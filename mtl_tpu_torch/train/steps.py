"""Training steps of the port (mtl_tpu/train/steps.py): feature
preparation, the teacher-forced forward + loss, the joint step, the
first-order meta-transfer step and the evaluation step.

The joint step (:169-222; reference joint_trainer.py:195-271) takes the
mean over the K task batches of their CE and one gradient of it, which is
the reference's accumulation of grad(loss_k / K); the tasks' forwards run
one after another and one backward runs over their sum. Then the optional
global-norm clip and one update of the joint optimizer (Adam, or SGD with
nesterov momentum).

The meta step is the paper's algorithm (reference transient_trainer.py:
155-255) in the flat first-order form of ``task_outer_grad_fo``
(mtl_tpu/train/steps.py:286-302), its tasks in a sequential loop as in
``outer_grads_fo_scan`` (:324-352). Per task k: support loss and its
gradient g at the shared weights p -> optional global-norm clip -> adapted
weights p - lr * g, detached -> the query loss and its gradient at the
adapted weights. Then the mean over the K tasks -> optional outer clip ->
outer Adam (:397-401). The query batch (the code-switched target,
transient_trainer.py:168) is the same for every task, so its features are
computed once per iteration. Second order (gradients through the inner
step) is not ported yet.

Parameters are the model's own f32 ``nn.Parameter``s; the adapted weights
enter the forward through ``torch.func.functional_call``. A step updates
the parameters and the optimizer state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..data.vocab import PAD_ID
from ..ops.frontend import log_spectrogram
from ..ops.targets import make_teacher_forcing
from .losses import ce_loss, ce_row_losses, masked_loss_guard
from .optim import OptState, global_norm


@dataclass
class TrainState:
    """(step, f32 params, optimizer state) -- mtl_tpu/train/steps.py:53-61.
    ``params`` are the model's own parameters, by name."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: OptState


def init_train_state(model: torch.nn.Module, optimizer) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(0, params, optimizer.init(params))


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def prepare_features(batch: Dict[str, torch.Tensor], cfg: Config):
    """(features [B, T, F], input_lengths [B]) from raw prepadded audio or
    precomputed ``features``."""
    if "features" in batch:
        return batch["features"], batch["input_lengths"]
    if cfg.audio.feat != "spectrogram":
        raise ValueError(f"--feat {cfg.audio.feat} is not ported yet")
    return log_spectrogram(
        batch["audio"], batch["audio_lengths"],
        n_fft=cfg.audio.n_fft, hop=cfg.audio.hop_length,
        window=cfg.audio.window, normalize=cfg.audio.normalize,
        prepadded=True,  # collate_audio reflect-pads per utterance
    )


def make_forward_fn(model: torch.nn.Module, cfg: Config) -> Callable:
    """Teacher-forced forward + CE loss (mtl_tpu/train/steps.py:90-143).
    ``forward(params, batch, generator, deterministic)`` returns (loss,
    aux with argmax ``hyp`` and ``gold`` B x L, ``num_correct``); ``params``
    None runs the model's own parameters, a dict runs those instead."""
    if cfg.train.loss != "ce":
        raise ValueError(f"--loss {cfg.train.loss} is not ported yet")
    smoothing = cfg.train.label_smoothing

    def forward(params: Optional[Dict[str, torch.Tensor]], batch,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True):
        feats, input_lengths = prepare_features(batch, cfg)
        seq_in, seq_out = make_teacher_forcing(batch["targets"])
        args = (feats, input_lengths, seq_in)
        kwargs = dict(deterministic=deterministic, generator=generator)
        logits = (model(*args, **kwargs) if params is None
                  else functional_call(model, params, args, kwargs))
        loss, num_correct = ce_loss(logits, seq_out, PAD_ID, smoothing)
        aux = {"hyp": logits.argmax(dim=-1), "gold": seq_out,
               "num_correct": num_correct}
        return masked_loss_guard(loss), aux

    return forward


def _clip_tree(grads: List[torch.Tensor], max_norm: float
               ) -> List[torch.Tensor]:
    """Scale by min(1, max_norm / (global norm + 1e-6))
    (mtl_tpu/train/steps.py:161-164)."""
    scale = (max_norm / (global_norm(grads) + 1e-6)).clamp(max=1.0)
    return torch._foreach_mul(grads, scale)


def make_joint_step(model: torch.nn.Module, cfg: Config,
                    optimizer) -> Callable:
    """One joint iteration. ``step(state, batches, generator)``:
    ``batches`` holds tensors with a leading task axis K. Returns (state,
    mean loss, aux with the argmax ``hyp`` and ``gold`` [K, B, L])."""
    forward = make_forward_fn(model, cfg)
    clip, max_norm = cfg.train.clip, cfg.train.max_norm

    def step(state: TrainState, batches: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        names = list(state.params)
        params = [state.params[n] for n in names]
        losses, auxes = [], []
        for i in range(batches["targets"].shape[0]):
            loss, aux = forward(None, {k: v[i] for k, v in batches.items()},
                                generator, False)
            losses.append(loss)
            auxes.append(aux)
        loss = torch.stack(losses).mean()
        grads = list(torch.autograd.grad(loss, params))
        if clip:
            grads = _clip_tree(grads, max_norm)
        optimizer.update(dict(zip(names, grads)), state.opt_state,
                         state.params)
        state.step += 1
        return state, loss.detach(), {
            "hyp": torch.stack([a["hyp"] for a in auxes]),
            "gold": torch.stack([a["gold"] for a in auxes])}

    return step


def make_meta_step(model: torch.nn.Module, cfg: Config,
                   outer_optimizer) -> Callable:
    """One first-order meta-transfer iteration. ``step(state, support,
    query, generator)``: ``support`` holds tensors with a leading task axis
    K, ``query`` one batch. Returns (state, metrics) with the metrics of
    mtl_tpu/train/steps.py:408-415."""
    if cfg.train.second_order:
        raise ValueError("--second-order is not ported yet")
    forward = make_forward_fn(model, cfg)
    inner_lr, clip, max_norm = cfg.train.lr, cfg.train.clip, cfg.train.max_norm

    def step(state: TrainState, support: Dict[str, torch.Tensor],
             query: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        names = list(state.params)
        params = [state.params[n] for n in names]
        feats, lengths = prepare_features(query, cfg)
        query = {"features": feats, "input_lengths": lengths,
                 "targets": query["targets"]}
        k = support["targets"].shape[0]
        gsum = None
        q_losses, s_losses, s_aux, q_aux = [], [], [], []
        for i in range(k):
            sup = {key: v[i] for key, v in support.items()}
            s_loss, aux = forward(None, sup, generator, False)
            g = list(torch.autograd.grad(s_loss, params))
            if clip:
                g = _clip_tree(g, max_norm)
            with torch.no_grad():
                adapted = torch._foreach_add(params, g, alpha=-inner_lr)
            for a in adapted:
                a.requires_grad_(True)
            q_loss, aux_q = forward(dict(zip(names, adapted)), query,
                                    generator, False)
            gq = list(torch.autograd.grad(q_loss, adapted))
            if gsum is None:
                gsum = gq
            else:
                torch._foreach_add_(gsum, gq)
            q_losses.append(q_loss.detach())
            s_losses.append(s_loss.detach())
            s_aux.append(aux)
            q_aux.append(aux_q)
        torch._foreach_div_(gsum, k)
        if clip:
            gsum = _clip_tree(gsum, max_norm)
        outer_optimizer.update(dict(zip(names, gsum)), state.opt_state,
                               state.params)
        state.step += 1
        metrics = {
            "outer_loss": torch.stack(q_losses).mean(),
            "support_losses": torch.stack(s_losses),
            "support_hyp": torch.stack([a["hyp"] for a in s_aux]),
            "support_gold": torch.stack([a["gold"] for a in s_aux]),
            "query_hyp": torch.stack([a["hyp"] for a in q_aux]),
            "query_gold": torch.stack([a["gold"] for a in q_aux]),
        }
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """Deterministic CE evaluation of one batch at the model's parameters
    (mtl_tpu/train/steps.py:434-482): (loss, aux with ``hyp``, ``gold`` and
    the per-row ``row_loss`` / ``row_tokens``, so that the padded rows of a
    ragged final batch can be left out)."""
    if cfg.train.loss != "ce":
        raise ValueError(f"--loss {cfg.train.loss} is not ported yet")
    smoothing = cfg.train.label_smoothing

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]):
        feats, input_lengths = prepare_features(batch, cfg)
        seq_in, seq_out = make_teacher_forcing(batch["targets"])
        logits = model(feats, input_lengths, seq_in, deterministic=True)
        row_loss, row_tokens = ce_row_losses(logits, seq_out, PAD_ID,
                                             smoothing)
        loss = masked_loss_guard(row_loss.sum()
                                 / row_tokens.sum().clamp_min(1))
        return loss, {"hyp": logits.argmax(dim=-1), "gold": seq_out,
                      "row_loss": row_loss, "row_tokens": row_tokens}

    return step
