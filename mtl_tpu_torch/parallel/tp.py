"""Tensor-parallel training over the ``model`` mesh axis (the counterpart
of mtl_tpu/parallel/sharding.py and mesh.py:shard_train_state).

The split is JAX's: its rule table (``RULES``, sharding.py:25-31) is
matched against each parameter's flax path (``interop.flax_path``), the
first rule that matches wins, and only a leaf of 2 or more dims is split:

* column (the kernel's last axis, its output features): ``query_linear``,
  ``key_linear``, ``value_linear``, the Conformer's ``q``/``k``/``v``,
  ``linear_1``, ``pw1`` and ``ff*/Dense_0``;
* row (the kernel's first axis, its input features): ``output_linear``
  (the decoder's vocab projection too), ``out``, ``linear_2``, ``pw2`` and
  ``ff*/Dense_1``;
* every other leaf is replicated: biases, norms, the depthwise ``dw``, the
  VGG convs, ``trg_embedding``, ``input_linear``.

A factorized linear has both of its kernels under one rule. In torch's
layout ([out, in]) a column split cuts dim 0 and a row split dim 1.

The port's layout (``param_layout``) adds one thing: the bias of a
column-split linear is kept as this rank's slice too, since each rank adds
only those entries (JAX replicates it; the values are the same, and its
gradient needs no sum over the axis). ``pw1``, whose output feeds a GLU,
is cut as two blocks (``Split.groups``): each rank takes its slice of the
values and the matching slice of the gates, so that the GLU runs on the
rank's channels alone.

``shard_module`` replaces each split leaf by this rank's slice (an
``nn.Parameter`` of the local shape) and turns on the layers' split
forwards (``models/layers.py``, ``decoder.py``, ``conformer.py``), which
hold the collectives of ``parallel/comm.py``. The optimizer moments follow
the parameters by name (``shard_tensors``). Checkpoints hold full tensors:
``gather_tensors`` / ``full_state_dict`` rebuild them on every rank of the
axis, and a restore slices the full tensors again. A split dim that the
axis size does not divide is refused before any rank starts
(``check_config``), with JAX's word for it.

The E-Branchformer (``models/ebranchformer.py``) has no layout: the rule
table is the Transformer's and the Conformer's, and its cgMLP, merge conv
and relative-position attention would need splits of their own.
``check_config`` and ``shard_module`` refuse it by name
(``check_encoder``).
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from .. import interop
from . import comm

# (flax path pattern, split) -- the first that matches wins
RULES = [
    (re.compile(r"(query_linear|key_linear|value_linear|/q/|/k/|/v/|"
                r"linear_1|pw1|ff\d/Dense_0)"), "col"),
    (re.compile(r"(output_linear|/out/|linear_2|pw2|ff\d/Dense_1)"), "row"),
]


def jax_spec(path: str, ndim: int) -> Optional[str]:
    """The JAX package's split of the leaf at flax ``path`` ("a/b/kernel")
    with ``ndim`` dims: "col" (its last axis over ``model``), "row" (its
    first) or None (replicated)."""
    if ndim < 2:
        return None
    for rx, kind in RULES:
        if rx.search(path):
            return kind
    return None


@dataclass(frozen=True)
class Split:
    """A leaf's torch ``dim`` split over the axis, seen as ``groups``
    equal blocks that are each split (1: one contiguous split)."""

    dim: int
    groups: int = 1


def param_layout(model: nn.Module) -> Dict[str, Split]:
    """The port's split of each parameter of ``model`` by name (the module
    docstring); the absent ones are replicated."""
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    out: Dict[str, Split] = {}
    for name, p in params.items():
        path = interop.flax_path(name, p.dim())
        kind = jax_spec("/".join(path), p.dim())
        if kind is None:
            continue
        if p.dim() != 2:
            raise ValueError(f"{name}: no tensor-parallel layout for a "
                             f"{p.dim()}-D leaf")
        owner = name.rpartition(".")[0]
        parent, _, child = owner.rpartition(".")
        groups = getattr(modules.get(parent), "TP_GROUPS", {}).get(child, 1)
        out[name] = Split(0 if kind == "col" else 1, groups)
        bias = owner + ".bias"
        if kind == "col" and bias in params:
            out[bias] = Split(0, groups)
    return out


def _bad_dims(shapes: Dict[str, torch.Size], layout: Dict[str, Split],
              size: int) -> List[str]:
    bad = []
    for name, split in layout.items():
        n = shapes[name][split.dim]
        if n % (split.groups * size):
            what = (f"{split.groups} blocks of {n // split.groups}"
                    if split.groups > 1 else str(n))
            bad.append(f"{name} {tuple(shapes[name])}: dim {split.dim} "
                       f"({what}) should be divisible by {size}")
    return bad


def check_divisible(model: nn.Module, size: int) -> Dict[str, Split]:
    """``param_layout(model)``, after a ``ValueError`` when ``size`` does
    not divide a split dim."""
    layout = param_layout(model)
    bad = _bad_dims({n: p.shape for n, p in model.named_parameters()},
                    layout, size)
    if bad:
        raise ValueError(f"--mesh-model {size}: " + "; ".join(bad))
    return layout


NO_LAYOUT = ("e_branchformer",)


def check_encoder(encoder_type: str, size: int) -> None:
    """A ``ValueError`` for an encoder that has no tensor-parallel
    layout."""
    if encoder_type in NO_LAYOUT:
        raise ValueError(f"--mesh-model {size}: tensor parallel has no "
                         f"layout for encoder_type {encoder_type!r}")


def check_config(cfg, size: int) -> None:
    """The refusals of ``check_encoder`` and ``check_divisible`` for the
    model of ``cfg``, built on the meta device (no memory, no rank)."""
    from ..models.transformer import build_model

    check_encoder(cfg.model.encoder_type, size)

    with torch.device("meta"):
        model = build_model(cfg, 1)
    check_divisible(model, size)


def part(t: torch.Tensor, split: Split, size: int, index: int
         ) -> torch.Tensor:
    """Rank ``index``'s slice of a full tensor (a new contiguous one)."""
    blocks = t.chunk(split.groups, split.dim)
    n = blocks[0].shape[split.dim] // size
    return torch.cat([b.narrow(split.dim, index * n, n) for b in blocks],
                     split.dim).contiguous()


def whole(parts: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The full tensor of every rank's slice, in rank order."""
    chunks = [p.chunk(split.groups, split.dim) for p in parts]
    return torch.cat([c[g] for g in range(split.groups) for c in chunks],
                     split.dim)


def shard_tensors(tensors: Dict[str, torch.Tensor],
                  layout: Dict[str, Split], axis) -> Dict[str, torch.Tensor]:
    """Tensors by parameter name with the split ones cut to this rank's
    slice (the others as they are)."""
    return {k: part(v, layout[k], axis.size, axis.index) if k in layout
            else v for k, v in tensors.items()}


def gather_tensors(tensors: Dict[str, torch.Tensor],
                   layout: Dict[str, Split], axis
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_tensors``, on every rank of the axis (a
    collective: every rank calls it with the same names)."""
    out = {}
    for k, v in tensors.items():
        if k in layout:
            every = comm.all_gather(v.detach().contiguous(), axis)
            v = whole(list(every), layout[k])
        out[k] = v
    return out


def shard_module(model: nn.Module, axis) -> Dict[str, Split]:
    """Cuts each split parameter of ``model`` to this rank's slice of the
    ``axis`` (in place, a new ``nn.Parameter`` each) and turns on the
    layers' split forwards; returns the layout, also kept as
    ``model.tp_layout`` beside ``model.tp_axis``."""
    check_encoder(model.encoder.encoder_type, axis.size)
    layout = check_divisible(model, axis.size)
    with torch.no_grad():
        for name, split in layout.items():
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            local = part(getattr(module, leaf).detach(), split, axis.size,
                         axis.index)
            setattr(module, leaf, nn.Parameter(local))
    for name, module in model.named_modules():
        if isinstance(module, nn.Linear) and f"{name}.weight" in layout:
            module.tp_kind = "col" if layout[f"{name}.weight"].dim == 0 \
                else "row"
        if hasattr(module, "tp"):
            module.tp = axis
    model.tp_axis, model.tp_layout = axis, layout
    return layout


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with full tensors (a collective over the
    model's axis when it is sharded)."""
    sd = model.state_dict()
    axis = getattr(model, "tp_axis", None)
    if axis is None:
        return sd
    return gather_tensors(sd, model.tp_layout, axis)


def full_opt_state(opt_state, model: nn.Module):
    """The optimizer state with full moments (a shallow copy; a collective
    over the model's axis when it is sharded)."""
    axis = getattr(model, "tp_axis", None)
    if axis is None:
        return opt_state
    out = copy.copy(opt_state)
    for field, value in opt_state.tensors().items():
        if isinstance(value, dict):
            setattr(out, field, gather_tensors(value, model.tp_layout, axis))
    return out


def shard_state(model: nn.Module, state, axis) -> None:
    """Shards a replicated ``TrainState`` in place: the model's split
    parameters (``shard_module``), ``state.params`` re-read from it, and
    the optimizer moments cut like the parameters."""
    layout = shard_module(model, axis)
    state.params = dict(model.named_parameters())
    for field, value in state.opt_state.tensors().items():
        if isinstance(value, dict):
            setattr(state.opt_state, field,
                    shard_tensors(value, layout, axis))
