"""The (task, data, model) device mesh on ``torch.distributed`` (the
counterpart of mtl_tpu/parallel/mesh.py).

A mesh of ``task x data x model`` ranks is one process per rank in one
process group (``parallel/launch.py`` starts them). Rank ``r`` sits at
coordinates ``(t, d, m)`` with ``r = (t * data + d) * model + m``, the
row-major order of JAX's ``devices.reshape(task, data, model)``. Each axis
is a subgroup of the ranks that differ in that coordinate alone; ``world``
is all of them.

As in the JAX package, parameters are replicated (``replicate_state``
broadcasts rank 0's, so every rank starts from one weight set) and a host
batch is sliced ``[K over task, B over data, ...]`` (``shard_batch``). In
JAX the collectives are XLA's; here ``parallel/comm.py`` holds them and the
steps call them (train/steps.py). The ``model`` axis carries the
sequence-parallel encode of ``parallel/sp.py`` and tensor-parallel
training (``parallel/tp.py``: after ``replicate_state`` each rank keeps its
slice of the split weights). ``plane`` is the (task, data) plane of this
rank's ``model`` coordinate: the ranks that hold the same slices and see
other parts of the batch, over which the steps sum what ``world`` sums
without a ``model`` axis (the same group when ``model`` is 1).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm

AXES = ("task", "data", "model")


@dataclass
class Axis:
    """One mesh axis as this rank sees it: its process group (None on an
    axis of size 1, where ``comm`` launches nothing), the rank's index
    along it, its size, and the global ranks of the group in axis order."""

    name: str
    size: int
    index: int
    ranks: List[int]
    group: Optional[object] = None


@dataclass
class Mesh:
    """This rank's view of the mesh: ``shape`` by axis name, its global
    ``rank`` and coordinates, its ``device`` and the process group's
    ``backend``, and one ``Axis`` per name of ``AXES`` plus ``plane`` and
    ``world``."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    device: torch.device
    backend: str
    axes: Dict[str, Axis] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    @property
    def task(self) -> Axis:
        return self.axes["task"]

    @property
    def data(self) -> Axis:
        return self.axes["data"]

    @property
    def model(self) -> Axis:
        return self.axes["model"]

    @property
    def plane(self) -> Axis:
        return self.axes["plane"]

    @property
    def world(self) -> Axis:
        return self.axes["world"]

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def mesh_shape(cfg, num_devices: int = 1) -> Tuple[int, int, int]:
    """(task, data, model) by JAX's rules (mtl_tpu/parallel/mesh.py:30-41):
    each axis at least 1, and ``--mesh-data 0`` fills the devices the
    other two leave (at least 1)."""
    task, model = max(1, cfg.mesh.task), max(1, cfg.mesh.model)
    data = cfg.mesh.data
    if data <= 0:
        data = max(1, num_devices // (task * model))
    return task, data, model


def requested_size(cfg) -> int:
    """The number of ranks the mesh flags ask for, ``--mesh-data 0``
    counted as 1 (mtl_tpu/parallel/mesh.py:maybe_make_mesh)."""
    return (max(1, cfg.mesh.task) * max(1, cfg.mesh.data)
            * max(1, cfg.mesh.model))


def coords_of(rank: int, shape: Sequence[int]) -> Dict[str, int]:
    return dict(zip(AXES, np.unravel_index(rank, tuple(shape))))


def make_mesh(shape: Sequence[int], device: torch.device,
              members: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """This rank's ``Mesh`` in the initialized default process group, over
    all its ranks or over the global ranks ``members`` (mesh rank i is
    ``members[i]``; None on a rank outside them). Every rank of the process
    group creates every subgroup (the axes, the whole mesh, the planes), in
    one order, as ``dist.new_group`` requires."""
    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size()
    members = list(range(world)) if members is None else list(members)
    if int(np.prod(shape)) != len(members):
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks; "
                         f"it was given {len(members)}")
    me = dist.get_rank()
    grid = np.asarray(members).reshape(shape)
    axes = {}
    for i, name in enumerate(AXES):
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            index = list(rest)
            index.insert(i, slice(None))
            ranks = [int(r) for r in grid[tuple(index)]]
            group = dist.new_group(ranks) if shape[i] > 1 else None
            if me in ranks:
                axes[name] = Axis(name, shape[i], ranks.index(me), ranks,
                                  group)
    whole = (dist.group.WORLD if len(members) == world
             else dist.new_group(members))
    for m in range(shape[2]):
        ranks = [int(r) for r in grid[:, :, m].reshape(-1)]
        if shape[2] == 1:
            group = whole
        else:
            group = dist.new_group(ranks) if len(ranks) > 1 else None
        if me in ranks:
            axes["plane"] = Axis("plane", len(ranks), ranks.index(me), ranks,
                                 group)
    if me not in members:
        return None
    rank = members.index(me)
    axes["world"] = Axis("world", len(members), rank, members, whole)
    return Mesh(dict(zip(AXES, shape)), rank,
                {a: int(c) for a, c in coords_of(rank, shape).items()},
                device, dist.get_backend(), axes)


def validate_mesh_divisibility(shape: Sequence[int], num_tasks: int,
                               k_train: int, k_valid: int) -> None:
    """The batch axes of a mesh ``shape`` (task, data, ...) must divide
    evenly (JAX's messages, mtl_tpu/parallel/mesh.py:73-94)."""
    task, data = int(shape[0]), int(shape[1])
    if num_tasks % task:
        raise ValueError(
            f"--mesh-task {task} must divide the number of train manifests "
            f"({num_tasks})"
        )
    if k_train % data:
        raise ValueError(
            f"--mesh-data {data} must divide --k-train ({k_train})"
        )
    if k_valid % data:
        raise ValueError(
            f"--mesh-data {data} must divide --k-valid ({k_valid})"
        )


def shard_batch_prefix(batch: Dict[str, np.ndarray], mesh: Mesh,
                       prefix: Sequence[Optional[str]]
                       ) -> Dict[str, np.ndarray]:
    """This rank's slice of a host batch: leading dim i of every array is
    cut into ``shape[prefix[i]]`` equal parts and the rank keeps part
    ``coords[prefix[i]]`` (None keeps the dim whole)."""

    def cut(x: np.ndarray) -> np.ndarray:
        for i, name in enumerate(prefix[:x.ndim]):
            if name is None or mesh.shape[name] == 1:
                continue
            n = x.shape[i] // mesh.shape[name]
            x = x.take(range(mesh.coords[name] * n,
                             (mesh.coords[name] + 1) * n), axis=i)
        return x

    return {k: cut(v) for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                task_axis: bool = False) -> Dict[str, np.ndarray]:
    """``[K over task, B over data]`` with ``task_axis``, else ``[B over
    data]``."""
    return shard_batch_prefix(
        batch, mesh, ("task", "data") if task_axis else ("data",))


def _state_tensors(model: torch.nn.Module, state) -> List[torch.Tensor]:
    """The tensors every rank must hold alike: the model's parameters and
    buffers, the optimizer state's tensors and, with a discriminator head,
    its parameters and optimizer tensors, in one fixed order."""
    out = list(model.parameters()) + list(model.buffers())

    def opt_tensors(opt_state) -> List[torch.Tensor]:
        found = []
        for value in opt_state.tensors().values():
            if isinstance(value, dict):
                found.extend(value[k] for k in sorted(value))
        return found

    out.extend(opt_tensors(state.opt_state))
    if getattr(state, "disc_params", None) is not None:
        out.extend(state.disc_params[k] for k in sorted(state.disc_params))
        out.extend(opt_tensors(state.disc_opt_state))
    return out


def replicate_state(model: torch.nn.Module, state, mesh: Mesh) -> None:
    """Broadcasts rank 0's weights, buffers and optimizer state to every
    rank, in place (the replicated placement of the JAX package), before
    ``parallel/tp.py`` slices any of them."""
    comm.broadcast_(_state_tensors(model, state), mesh.world)
