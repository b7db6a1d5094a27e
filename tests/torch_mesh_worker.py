"""The ranks' side of the port's mesh tests (tests/test_torch_port_mesh.py,
test_torch_port_sp.py, test_torch_port_cuda.py).

The functions here run on every rank of a group that
``mtl_tpu_torch.parallel.launch.run`` starts, rank 0 in the test process
and the others spawned; a spawned rank imports this module, which imports
torch and the port alone (no JAX). A case is a plain dict (numpy arrays,
a config as JSON) so that it pickles to the spawned ranks; each case runs
on a sub-mesh of the group's first ranks, and rank 0 returns the results.
A step case on a mesh with a ``model`` axis shards the model over it
(``parallel/tp.py``) unless it has a discriminator head; its gradients and
params come back gathered to full tensors.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from mtl_tpu_torch.config import Config
from mtl_tpu_torch.models.discriminator import Discriminator
from mtl_tpu_torch.models.subsampler import subsampled_length
from mtl_tpu_torch.models.transformer import build_model
from mtl_tpu_torch.ops import native
from mtl_tpu_torch.parallel import comm, tp
from mtl_tpu_torch.parallel.mesh import make_mesh, shard_batch
from mtl_tpu_torch.parallel.sp import (encode_sp, gather_encoder_output,
                                       time_slices)
from mtl_tpu_torch.train.optim import Adam
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       make_joint_step, make_meta_step)
from mtl_tpu_torch.train.steps_disc import (init_disc_state,
                                            make_joint_step_disc)


VGG_COUNTERS = ("vgg_block1", "vgg_block2", "vgg_block1_f32",
                "vgg_block2_f32")


class RecordingAdam(Adam):
    """Adam that keeps the gradients it was handed (after the steps'
    reductions: the global outer gradient)."""

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return super().update(grads, state, params)


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def _same_on_every_rank(tensors: List[torch.Tensor], axis) -> bool:
    """True when every rank of ``axis`` holds bitwise the same tensors."""
    if not tensors:
        return True
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    every = comm.all_gather(flat, axis)
    return bool((every == every[0]).all())


def sub_mesh(shape, device: torch.device):
    """The mesh of ``shape`` (task, data, model) over the group's first
    ranks; None on the others."""
    return make_mesh(shape, device, members=range(int(np.prod(shape))))


def build_case_model(case: dict, device: torch.device):
    cfg = Config.from_dict(json.loads(case["cfg"]))
    model = build_model(cfg, case["vocab_size"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["state_dict"].items()})
    return cfg, model.to(device)


def _step_case(mesh, case: dict, device: torch.device) -> dict:
    """One step of ``case["kind"]`` on this rank's slice of the batch:
    "meta" (first or, by the config, second order; the shared query),
    "maml", "joint", "joint_disc" or "epoch" (a joint step of one task,
    sharded over data alone)."""
    cfg, model = build_case_model(case, device)
    kind = case["kind"]
    meta = kind in ("meta", "maml")
    opt = RecordingAdam(cfg.train.meta_lr if meta else cfg.train.lr)
    state = init_train_state(model, opt)
    layout = {}
    if mesh.model.size > 1 and kind != "joint_disc":
        tp.shard_state(model, state, mesh.model)
        layout = model.tp_layout
        shapes = {k: tuple(v.shape) for k, v in state.params.items()}
        moments = {k: tuple(v.shape) for k, v in state.opt_state.mu.items()}
    disc = None
    if kind == "joint_disc":
        disc = Discriminator(cfg.model.dim_model, cfg.train.num_class)
        disc.load_state_dict({k: torch.from_numpy(v)
                              for k, v in case["disc_state_dict"].items()})
        disc = disc.to(device)
        state = init_disc_state(disc, cfg, state)
        disc.load_state_dict({k: torch.from_numpy(v)
                              for k, v in case["disc_state_dict"].items()})
    space_id = case.get("space_id")
    if meta:
        step = make_meta_step(model, cfg, opt, kind == "maml",
                              space_id=space_id, mesh=mesh)
        support = batch_to_device(shard_batch(case["support"], mesh, True),
                                  device)
        query = batch_to_device(
            shard_batch(case["query"], mesh, kind == "maml"), device)
        state, m = step(state, support, query, None)
    else:
        if kind == "joint_disc":
            step = make_joint_step_disc(model, disc, cfg, opt, mesh=mesh)
        else:
            step = make_joint_step(model, cfg, opt, space_id=space_id,
                                   mesh=mesh)
        batch = batch_to_device(shard_batch(case["support"], mesh, True),
                                device)
        state, loss, m = step(state, batch, None, case.get("beta", 0.5))
        m = dict(m, loss=loss)
    replicated = [v for k, v in state.params.items() if k not in layout]
    split = [v for k, v in state.params.items() if k in layout]
    grads, params = opt.grads, state.params
    if layout:
        grads = tp.gather_tensors(grads, layout, mesh.model)
        params = tp.gather_tensors(params, layout, mesh.model)
    out = {
        "metrics": _numpy({k: v for k, v in m.items()
                           if isinstance(v, torch.Tensor)}),
        "grads": _numpy(grads),
        "params": _numpy(params),
        "buffers": _numpy(dict(model.named_buffers())),
        "same_on_every_rank": (
            _same_on_every_rank(replicated + list(model.buffers()),
                                mesh.world)
            and _same_on_every_rank(split, mesh.plane)),
    }
    if layout:
        out["layout"] = {k: (v.dim, v.groups) for k, v in layout.items()}
        out["local_shapes"], out["moment_shapes"] = shapes, moments
    if disc is not None:
        out["disc_params"] = _numpy(state.disc_params)
    return out


def run_step_cases(mesh, cases: List[dict], device_name: str = "cpu"
                   ) -> Optional[List[dict]]:
    """Every case on its sub-mesh (``case["shape"]``, (task, data) or
    (task, data, model)); rank 0 returns the results in order."""
    device = mesh.device if device_name == "cuda" else torch.device("cpu")
    results = []
    for case in cases:
        sub = sub_mesh((tuple(case["shape"]) + (1,))[:3], device)
        results.append(None if sub is None else
                       _step_case(sub, case, device))
    return results if mesh.is_root else None


def run_encode_cases(mesh, cases: List[dict], device_name: str = "cpu"
                     ) -> Optional[List[dict]]:
    """``encode_sp`` of each case's features on its sub-mesh
    (``case["shape"]``, (data, model)): rank 0 returns the gathered
    encoder output beside the unsharded ``model.encode`` of the same
    inputs (and with ``case["reference_cfg"]`` the unsharded encode of the
    same weights under that config), each rank's VGG kernel launches in its
    encode and the peak device memory of its encode on a card."""
    device = mesh.device if device_name == "cuda" else torch.device("cpu")
    results = []
    for case in cases:
        sub = sub_mesh((1,) + tuple(case["shape"]), device)
        if sub is None:
            results.append(None)
            continue
        _, model = build_case_model(case, device)
        model.eval()
        feats = torch.from_numpy(case["features"]).to(device)
        lengths = torch.from_numpy(case["lengths"]).to(device)
        n = feats.shape[0] // sub.data.size
        rows = slice(sub.data.index * n, (sub.data.index + 1) * n)
        slices = time_slices(subsampled_length(model.conv.feat_extractor,
                                               feats.shape[1]),
                             sub.model.size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        native.reset_launch_counts()
        enc = encode_sp(model, feats[rows], lengths[rows], sub.model, slices)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        counts = comm.all_gather(torch.tensor(
            [native.launch_counts[k] for k in VGG_COUNTERS], device=device),
            sub.world).cpu().tolist()
        enc = gather_encoder_output(enc, slices, sub)
        if not sub.is_root:
            results.append(None)
            continue
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        with torch.no_grad():
            want = model.encode(feats, lengths)
            reference = None
            if "reference_cfg" in case:  # the same weights at another dtype
                _, ref_model = build_case_model(
                    dict(case, cfg=case["reference_cfg"]), device)
                reference = ref_model.eval().encode(feats, lengths)
                reference = reference.float().cpu().numpy()
        results.append({
            "reference": reference,
            "sp": enc.float().cpu().numpy(),
            "plain": want.float().cpu().numpy(),
            "slices": slices,
            "sp_counts": [dict(zip(VGG_COUNTERS, c)) for c in counts],
            "sp_peak": peak,
            "plain_peak": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0),
        })
    return results if mesh.is_root else None


def epoch_train_failing_rank(mesh, args, failing_rank: int):
    """``cli/asr.py:_epoch_train`` on this rank, where the joint step of
    rank ``failing_rank`` raises before its first collective (the other
    ranks then wait inside the step's collectives)."""
    from mtl_tpu_torch.cli import asr
    from mtl_tpu_torch.train import trainer

    if mesh.rank == failing_rank:
        def failing_step(*_args, **_kwargs):
            def step(*_a, **_k):
                raise RuntimeError(f"planted step failure on rank "
                                   f"{failing_rank}")
            return step

        trainer.make_joint_step = failing_step
    return asr._epoch_train(mesh, args)
