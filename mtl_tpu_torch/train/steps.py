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
outer Adam (:397-401). The meta-transfer query batch (the code-switched
target, transient_trainer.py:168) is the same for every task, so its
features are computed once per iteration; under MAML (``per_task_query``,
meta_trainer.py:244) task k takes its own query ``query[k]``, whose
features are computed in its turn. Second order (gradients through the
inner step) is not ported yet.

Both steps take an optional discriminator head (``steps_disc.py``), which
adds the adversarial or multitask terms to each task's (query) loss and
updates the discriminator from the same backward.

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
    ``forward(params, batch, generator, deterministic, with_encoder)``
    returns (loss, aux with argmax ``hyp`` and ``gold`` B x L,
    ``num_correct``, and with ``with_encoder`` the encoder output ``enc``
    of ``forward_with_encoder``); ``params`` None runs the model's own
    parameters, a dict runs those instead."""
    if cfg.train.loss != "ce":
        raise ValueError(f"--loss {cfg.train.loss} is not ported yet")
    smoothing = cfg.train.label_smoothing

    def forward(params: Optional[Dict[str, torch.Tensor]], batch,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, with_encoder: bool = False):
        feats, input_lengths = prepare_features(batch, cfg)
        seq_in, seq_out = make_teacher_forcing(batch["targets"])
        args = (feats, input_lengths, seq_in)
        kwargs = dict(deterministic=deterministic, generator=generator,
                      return_encoder=with_encoder)
        out = (model(*args, **kwargs) if params is None
               else functional_call(model, params, args, kwargs))
        logits, enc = out if with_encoder else (out, None)
        loss, num_correct = ce_loss(logits, seq_out, PAD_ID, smoothing)
        aux = {"hyp": logits.argmax(dim=-1), "gold": seq_out,
               "num_correct": num_correct}
        if with_encoder:
            aux["enc"] = enc
        return masked_loss_guard(loss), aux

    return forward


def _clip_tree(grads: List[torch.Tensor], max_norm: float
               ) -> List[torch.Tensor]:
    """Scale by min(1, max_norm / (global norm + 1e-6))
    (mtl_tpu/train/steps.py:161-164)."""
    scale = (max_norm / (global_norm(grads) + 1e-6)).clamp(max=1.0)
    return torch._foreach_mul(grads, scale)


def _task_batch(batches: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in batches.items()}


def make_joint_step(model: torch.nn.Module, cfg: Config, optimizer,
                    head=None) -> Callable:
    """One joint iteration. ``step(state, batches, generator, beta)``:
    ``batches`` holds tensors with a leading task axis K. Returns (state,
    mean CE, aux with the argmax ``hyp`` and ``gold`` [K, B, L]).

    ``head`` (``steps_disc.DiscHead``) adds the discriminator terms of
    ``make_joint_step_disc`` (mtl_tpu/train/steps_disc.py:189-252): task k
    (accent k) adds ``head.terms``, the loss is mean(CE) + mean(terms), one
    backward reaches the model and the discriminator (``state`` is then a
    ``DiscTrainState``), the model's gradients alone are clipped, and each
    side takes its own update. The returned loss stays the mean CE."""
    forward = make_forward_fn(model, cfg)
    clip, max_norm = cfg.train.clip, cfg.train.max_norm

    def step(state: TrainState, batches: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, beta: float = 0.5):
        names = list(state.params)
        params = [state.params[n] for n in names]
        ces, terms, auxes = [], [], []
        for i in range(batches["targets"].shape[0]):
            ce, aux = forward(None, _task_batch(batches, i), generator, False,
                              with_encoder=head is not None)
            if head is not None:
                terms.append(head.terms(aux.pop("enc"), i, beta))
            ces.append(ce)
            auxes.append(aux)
        ce = torch.stack(ces).mean()
        loss = ce
        if head is not None:
            loss = ce + torch.stack([t[0] for t in terms]).mean()
        d_params = [] if head is None else head.params(state)
        grads = list(torch.autograd.grad(loss, params + d_params))
        grads, d_grads = grads[:len(params)], grads[len(params):]
        if clip:
            grads = _clip_tree(grads, max_norm)
        optimizer.update(dict(zip(names, grads)), state.opt_state,
                         state.params)
        out = {"hyp": torch.stack([a["hyp"] for a in auxes]),
               "gold": torch.stack([a["gold"] for a in auxes])}
        if head is not None:
            head.update(state, d_grads)
            out["ce"] = ce.detach()
            out.update(head.metrics(terms))
        state.step += 1
        return state, ce.detach(), out

    return step


def make_meta_step(model: torch.nn.Module, cfg: Config, outer_optimizer,
                   per_task_query: bool = False, head=None) -> Callable:
    """One first-order meta iteration. ``step(state, support, query,
    generator, beta)``: ``support`` holds tensors with a leading task axis
    K; ``query`` one batch shared by the tasks (meta-transfer), or with
    ``per_task_query`` (MAML, meta_trainer.py:244) a batch per task with a
    leading axis K. Returns (state, metrics) with the metrics of
    mtl_tpu/train/steps.py:408-415.

    ``head`` (``steps_disc.DiscHead``) adds the discriminator terms to each
    task's query loss at the adapted weights, as ``make_meta_step_disc``
    (mtl_tpu/train/steps_disc.py:77-186): accent k under MAML, K - 1 (the
    target task) under the shared query; the inner step stays plain CE.
    The outer loss is the mean of the augmented query losses; the
    discriminator's gradients are the mean over the tasks, not clipped."""
    if cfg.train.second_order:
        raise ValueError("--second-order is not ported yet")
    forward = make_forward_fn(model, cfg)
    inner_lr, clip, max_norm = cfg.train.lr, cfg.train.clip, cfg.train.max_norm

    def step(state: TrainState, support: Dict[str, torch.Tensor],
             query: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, beta: float = 0.5):
        names = list(state.params)
        params = [state.params[n] for n in names]
        d_params = [] if head is None else head.params(state)
        if not per_task_query:  # the shared query's features, once
            feats, lengths = prepare_features(query, cfg)
            query = {"features": feats, "input_lengths": lengths,
                     "targets": query["targets"]}
        k = support["targets"].shape[0]
        gsum = None  # the sum over the tasks of the model's gradients
        # at the adapted weights, then the discriminator's
        q_losses, s_losses, s_aux, q_aux, terms, ces = [], [], [], [], [], []
        for i in range(k):
            s_loss, aux = forward(None, _task_batch(support, i), generator,
                                  False)
            g = list(torch.autograd.grad(s_loss, params))
            if clip:
                g = _clip_tree(g, max_norm)
            with torch.no_grad():
                adapted = list(torch._foreach_add(params, g, alpha=-inner_lr))
            for a in adapted:
                a.requires_grad_(True)
            q = _task_batch(query, i) if per_task_query else query
            q_loss, aux_q = forward(dict(zip(names, adapted)), q, generator,
                                    False, with_encoder=head is not None)
            if head is not None:
                ces.append(q_loss.detach())
                terms.append(head.terms(aux_q.pop("enc"),
                                        i if per_task_query else k - 1,
                                        beta))
                q_loss = q_loss + terms[-1][0]
            gq = list(torch.autograd.grad(q_loss, adapted + d_params))
            if gsum is None:
                gsum = gq
            else:
                torch._foreach_add_(gsum, gq)
            q_losses.append(q_loss.detach())
            s_losses.append(s_loss.detach())
            s_aux.append(aux)
            q_aux.append(aux_q)
        torch._foreach_div_(gsum, k)
        gsum, dsum = gsum[:len(params)], gsum[len(params):]
        if clip:
            gsum = _clip_tree(gsum, max_norm)
        outer_optimizer.update(dict(zip(names, gsum)), state.opt_state,
                               state.params)
        metrics = {
            "outer_loss": torch.stack(q_losses).mean(),
            "support_losses": torch.stack(s_losses),
            "support_hyp": torch.stack([a["hyp"] for a in s_aux]),
            "support_gold": torch.stack([a["gold"] for a in s_aux]),
            "query_hyp": torch.stack([a["hyp"] for a in q_aux]),
            "query_gold": torch.stack([a["gold"] for a in q_aux]),
        }
        if head is not None:
            head.update(state, dsum)
            metrics["query_ce"] = torch.stack(ces).mean()
            metrics.update(head.metrics(terms))
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """Deterministic CE evaluation of one batch (mtl_tpu/train/steps.py:
    434-482) at the model's parameters, or at ``params`` (a dict by name,
    such as meta-test's adapted weights) through ``functional_call``:
    (loss, aux with ``hyp``, ``gold`` and the per-row ``row_loss`` /
    ``row_tokens``, so that the padded rows of a ragged final batch can be
    left out)."""
    if cfg.train.loss != "ce":
        raise ValueError(f"--loss {cfg.train.loss} is not ported yet")
    smoothing = cfg.train.label_smoothing

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor],
             params: Optional[Dict[str, torch.Tensor]] = None):
        feats, input_lengths = prepare_features(batch, cfg)
        seq_in, seq_out = make_teacher_forcing(batch["targets"])
        args = (feats, input_lengths, seq_in)
        logits = (model(*args, deterministic=True) if params is None
                  else functional_call(model, params, args))
        row_loss, row_tokens = ce_row_losses(logits, seq_out, PAD_ID,
                                             smoothing)
        loss = masked_loss_guard(row_loss.sum()
                                 / row_tokens.sum().clamp_min(1))
        return loss, {"hyp": logits.argmax(dim=-1), "gold": seq_out,
                      "row_loss": row_loss, "row_tokens": row_tokens}

    return step
