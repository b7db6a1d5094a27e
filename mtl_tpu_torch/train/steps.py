"""Training steps of the port (mtl_tpu/train/steps.py): feature
preparation, the teacher-forced forward + loss, the joint step, the
meta-transfer step (first or second order) and the evaluation step.

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
features are computed in its turn.

With ``--second-order`` the task's term is ``task_outer_loss``
(:273-284) and its gradient is taken through the inner step, the tasks
one after another as in ``outer_grads_so_scan`` (:354-380): the support
gradient g is kept in the graph (``create_graph``), the inner clip is
differentiated through, norm included, the adapted weights p - lr * g stay
in the graph, and the query loss at them is differentiated with respect to
p. Each task's graph is freed before the next starts. The VGG stack then
runs its plain version (``models/subsampler.py``), and the step runs with
TF32 off, so its f32 convolutions are f32 on the card.

With ``--loss ctc`` the loss is the CTC of the decoder's logits against
the targets with input lengths ``min(src_percentages * L, L)``
(:118-129), the reference's quirk. emb_cnn's BatchNorm statistics follow
:103-158: each training forward reports the running statistics it would
give from the same starting buffers, the step takes their mean over the
K tasks (the meta step over the query forwards, the support forwards'
dropped) and writes it into the buffers after the update; no gradient
reaches them. With ``--device-cer`` the joint and meta steps (not those
with a discriminator head, as in the JAX package) also return the train
CER's edit distance and character count, computed on the batch's device
(:214-220, :416-422).

Both steps take an optional discriminator head (``steps_disc.py``), which
adds the adversarial or multitask terms to each task's (query) loss and
updates the discriminator from the same backward.

The meta step's phases are the program's spans (``utils/trace.py``):
``meta.step`` around ``meta.query_features``, then per task
``meta.support_fwd``, ``meta.support_grad``, ``meta.inner_sgd``,
``meta.query_fwd`` and ``meta.query_grad``, then ``meta.outer``; the same
names in second order. On a card the meta trainers replay the first-order
step as CUDA graphs (``graphs.py``), whose replays open none of them.

Parameters are the model's own f32 ``nn.Parameter``s; the adapted weights
enter the forward through ``torch.func.functional_call``. A step updates
the parameters and the optimizer state in place.

Each step takes an optional ``mesh`` (``parallel/mesh.py``); with none it
is the single-process step. On a mesh every rank holds the same parameters
and its own ``[K / task, B / data]`` slice of the batch, and the step
writes out the collectives that XLA inserts for the JAX package's sharded
step (``parallel/comm.py``):

* a forward's loss is this rank's share of the global batch's: the CE's
  row-loss sum over the *global* token count (all-reduced over ``data``),
  the CTC's local mean over ``data`` (equal shards, so the mean of the
  shard means), and ``masked_loss_guard`` decides on the global loss;
  emb_cnn's BatchNorm normalizes by the global batch's statistics
  (``models/subsampler.py:batch_norm``, a synchronized BatchNorm);
* the meta step all-reduces each task's support gradient over ``data``
  before the inner clip and SGD step (the autograd-aware all-reduce under
  ``--second-order``, so the outer gradient flows through it), and the
  query gradients over ``(task, data)`` before the division by K; the
  joint step reduces its gradient over ``(task, data)``; the outer clip and
  the update then run alike on every rank;
* the running BatchNorm statistics are averaged over the tasks of every
  ``task`` rank, ``--device-cer``'s counts are summed over the ranks, and
  the hyps and golds and the reported losses are the global batch's on
  every rank, so that rank 0 logs the single-process run's lines.

With a ``model`` axis the sums over the ranks run over the ``plane``
(the ranks of this rank's model coordinate), which every rank of the axis
does alike. A model sharded over the axis (``parallel/tp.py``) holds this
rank's slices of its split parameters: their gradients are the slices'
own, a replicated parameter's is the same on every rank of the axis, and
the global-norm clips (inner, differentiable under ``--second-order``, and
outer) sum the split tensors' squares over the axis (``_clip_tree``). A
model with a discriminator head stays replicated over the axis, as in the
JAX package. Before the update the replicated leaves' gradients are model
rank 0's on every rank of the axis (``_agree_over_model``), so that they
stay bitwise one value where the card's kernels round alike computations
otherwise.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..data.vocab import PAD_ID
from ..ops.edit_distance import device_cer
from ..ops.frontend import log_fbank, log_spectrogram
from ..ops.targets import make_teacher_forcing, target_lengths
from ..parallel import comm
from ..utils.precision import strict_f32
from ..utils.trace import span
from .losses import (ce_loss, ce_row_losses, ctc_loss, ctc_row_losses,
                     masked_loss_guard)
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
    with span("model.features"):
        if cfg.audio.feat == "logfbank":
            # the psf front-end is uncentered: the n_fft // 2 reflect pad that
            # collate_audio adds for the STFT comes off again
            pad = cfg.audio.n_fft // 2
            audio = batch["audio"]
            return log_fbank(audio[:, pad:audio.shape[1] - pad],
                             batch["audio_lengths"],
                             sample_rate=cfg.audio.sample_rate, nfilt=80,
                             normalize=cfg.audio.normalize)
        return log_spectrogram(
            batch["audio"], batch["audio_lengths"],
            n_fft=cfg.audio.n_fft, hop=cfg.audio.hop_length,
            window=cfg.audio.window, normalize=cfg.audio.normalize,
            prepadded=True,  # collate_audio reflect-pads per utterance
        )


def _ctc_input_lengths(batch, t: int) -> torch.Tensor:
    """min(src_percentages * t, t): the CTC input lengths on decoder-length
    logits (mtl_tpu/train/steps.py:121-127)."""
    targets = batch["targets"]
    pct = batch.get("src_percentages")
    if pct is None:
        pct = torch.ones(targets.shape[0], device=targets.device)
    return torch.clamp((pct * t).int(), max=t)


def _guard(loss: torch.Tensor, data) -> torch.Tensor:
    """``masked_loss_guard`` on the global loss: this rank's share is
    zeroed when the sum of the shares over ``data`` is not finite."""
    if data is None or data.size == 1:
        return masked_loss_guard(loss)
    total = comm.all_reduce(loss.detach(), data)
    return torch.where(torch.isfinite(total), loss, 0.0)


def make_forward_fn(model: torch.nn.Module, cfg: Config,
                    mesh=None) -> Callable:
    """Teacher-forced forward + loss, CE or CTC
    (mtl_tpu/train/steps.py:90-143). ``forward(params, batch, generator,
    deterministic, with_encoder, stats_out)`` returns (loss, aux with argmax
    ``hyp`` and ``gold`` B x L, ``num_correct``, and with ``with_encoder``
    the encoder output ``enc`` of ``forward_with_encoder``); ``params``
    None runs the model's own parameters, a dict runs those instead. A
    training forward of emb_cnn appends its BatchNorms' new running
    statistics to ``stats_out`` when given. On a ``mesh`` the loss is this
    rank's share of the global batch's over ``data`` (the module
    docstring), and emb_cnn's BatchNorm is synchronized over ``data``."""
    if cfg.train.loss not in ("ce", "ctc"):
        raise ValueError(f"unknown --loss {cfg.train.loss!r}")
    smoothing = cfg.train.label_smoothing
    data = None if mesh is None else mesh.data
    model.conv.sync_axis = data

    def forward(params: Optional[Dict[str, torch.Tensor]], batch,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, with_encoder: bool = False,
                stats_out: Optional[list] = None):
        feats, input_lengths = prepare_features(batch, cfg)
        targets = batch["targets"]
        seq_in, seq_out = make_teacher_forcing(targets)
        args = (feats, input_lengths, seq_in)
        kwargs = dict(deterministic=deterministic, generator=generator,
                      return_encoder=with_encoder, stats_out=stats_out)
        out = (model(*args, **kwargs) if params is None
               else functional_call(model, params, args, kwargs))
        logits, enc = out if with_encoder else (out, None)
        with span("model.loss"):
            if cfg.train.loss == "ctc":
                loss = ctc_loss(torch.log_softmax(logits, dim=-1),
                                _ctc_input_lengths(batch, logits.shape[1]),
                                targets, target_lengths(targets))
                if data is not None:
                    # a mean over sequences: the shards are equal, so the
                    # global mean is the sum over data of the shard means / D
                    loss = loss / data.size
                num_correct = torch.zeros((), dtype=torch.long,
                                          device=logits.device)
            elif data is None:
                loss, num_correct = ce_loss(logits, seq_out, PAD_ID, smoothing)
            else:
                # a token mean over the global batch: the shards hold other
                # token counts, so each divides by the global count
                row_loss, row_tokens = ce_row_losses(logits, seq_out, PAD_ID,
                                                     smoothing)
                tokens = comm.all_reduce(row_tokens.sum(), data)
                loss = row_loss.sum() / tokens.clamp_min(1)
                num_correct = ((logits.argmax(dim=-1) == seq_out)
                               & (seq_out != PAD_ID)).sum()
            aux = {"hyp": logits.argmax(dim=-1), "gold": seq_out,
                   "num_correct": num_correct}
            if with_encoder:
                aux["enc"] = enc
            return _guard(loss, data), aux

    return forward


@torch.no_grad()
def _merge_batch_stats(model: torch.nn.Module, per_task: List[list],
                       mesh=None) -> None:
    """Writes the mean over the tasks of the running statistics each
    task's forward reported (from the same starting buffers) into emb_cnn's
    buffers (mtl_tpu/train/steps.py:146-158); nothing without them. On a
    mesh the mean runs over the tasks of every ``task`` rank (the
    statistics are the global batch's already, alike over ``data``)."""
    per_task = [stats for stats in per_task if stats]
    if not per_task:
        return
    k = len(per_task) * (1 if mesh is None else mesh.task.size)
    for j, (mean, var) in enumerate(model.conv.batch_stats()):
        if mesh is None:
            mean.copy_(torch.stack([s[j][0] for s in per_task]).mean(0))
            var.copy_(torch.stack([s[j][1] for s in per_task]).mean(0))
            continue
        sums = comm.all_reduce_list(
            [torch.stack([s[j][i] for s in per_task]).sum(0)
             for i in (0, 1)], mesh.task)
        mean.copy_(sums[0] / k)
        var.copy_(sums[1] / k)


def _device_cer_metrics(hyp: torch.Tensor, gold: torch.Tensor,
                        space_id: Optional[int], mesh=None
                        ) -> Dict[str, torch.Tensor]:
    """``cer_dist`` / ``cer_chars`` of [K, B, L] hyps against their gold;
    on a mesh of this rank's slice, summed over the ranks."""
    d, c = device_cer(hyp.flatten(0, 1), gold.flatten(0, 1), space_id)
    if mesh is not None:
        d, c = comm.all_reduce_list([d, c], mesh.plane)
    return {"cer_dist": d, "cer_chars": c}


def _gather_tasks(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global [K, B, ...] of every rank's [K / task, B / data, ...]
    slice (the identity without a mesh)."""
    if mesh is None:
        return x
    kl, bl = x.shape[:2]
    t, d = mesh.coords["task"], mesh.coords["data"]
    full = x.new_zeros((kl * mesh.task.size, bl * mesh.data.size)
                       + tuple(x.shape[2:]))
    full[t * kl:(t + 1) * kl, d * bl:(d + 1) * bl] = x
    return comm.all_reduce(full, mesh.plane)


def _task_mean(values: List[torch.Tensor], mesh, k: int) -> torch.Tensor:
    """The mean over the K tasks of per-task values: on a mesh this
    rank's part of it (its tasks' sum over K), whose sum over the ranks
    is the mean."""
    if mesh is None:
        return torch.stack(values).mean()
    return torch.stack(values).sum() / k


def _global(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the plane's ranks of this rank's part of a reported
    value."""
    return x if mesh is None else comm.all_reduce(x, mesh.plane)


def tp_split(model: torch.nn.Module, names: List[str]):
    """(axis, which of ``names`` are split over it) of a model sharded by
    ``parallel/tp.py``; None for a model that is not."""
    axis = getattr(model, "tp_axis", None)
    if axis is None:
        return None
    return axis, [n in model.tp_layout for n in names]


def _agree_over_model(grads: List[torch.Tensor], tp, mesh) -> None:
    """Overwrites, in place, the gradients of the leaves replicated over
    the mesh's ``model`` axis (all of them when the model is not sharded)
    with model rank 0's. Every rank of the axis computes them alike, but a
    card's kernels (cuDNN's weight gradients, atomic sums) may round them
    otherwise from one process to the next, and a replicated leaf must
    stay one value on every rank."""
    if mesh is None or mesh.model.size == 1:
        return
    split = tp[1] if tp is not None else []
    comm.broadcast_([g for i, g in enumerate(grads)
                     if i >= len(split) or not split[i]], mesh.model)


def _clip_tree(grads: List[torch.Tensor], max_norm: float,
               differentiable: bool = False, tp=None) -> List[torch.Tensor]:
    """Scale by min(1, max_norm / (global norm + 1e-6))
    (mtl_tpu/train/steps.py:161-164). ``differentiable`` computes the same
    values per tensor, with ops that autograd differentiates again (the
    second-order inner clip), as optax.global_norm does: the square root
    of the sum of every tensor's sum of squares. ``tp`` (``tp_split``'s)
    takes the norm of the full tensors over the model axis: the split
    slices' squares reduced over it (differentiably, and their scale copied
    to the axis, so that the backward collects every rank's part)."""
    axis, split = tp if tp is not None else (None, None)
    if not differentiable:
        norm = global_norm(grads, split, axis)
        scale = (max_norm / (norm + 1e-6)).clamp(max=1.0)
        return torch._foreach_mul(grads, scale)
    squares = [(g * g).sum() for g in grads]
    if axis is None:
        norm = torch.sqrt(torch.stack(squares).sum())
    else:
        mine = [q for q, s in zip(squares, split) if s]
        rest = [q for q, s in zip(squares, split) if not s]
        total = comm.reduce_from_model(torch.stack(mine).sum(), axis)
        if rest:
            total = total + torch.stack(rest).sum()
        norm = torch.sqrt(total)
    scale = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    if axis is None:
        return [g * scale for g in grads]
    split_scale = comm.copy_to_model(scale, axis)
    return [g * (split_scale if s else scale) for g, s in zip(grads, split)]


def _task_batch(batches: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in batches.items()}


def make_joint_step(model: torch.nn.Module, cfg: Config, optimizer,
                    head=None, space_id: Optional[int] = None,
                    mesh=None) -> Callable:
    """One joint iteration. ``step(state, batches, generator, beta)``:
    ``batches`` holds tensors with a leading task axis K. Returns (state,
    mean CE, aux with the argmax ``hyp`` and ``gold`` [K, B, L]).

    ``head`` (``steps_disc.DiscHead``) adds the discriminator terms of
    ``make_joint_step_disc`` (mtl_tpu/train/steps_disc.py:189-252): task k
    (accent k) adds ``head.terms``, the loss is mean(CE) + mean(terms), one
    backward reaches the model and the discriminator (``state`` is then a
    ``DiscTrainState``), the model's gradients alone are clipped, and each
    side takes its own update. The returned loss stays the mean CE.

    With ``cfg.train.device_cer`` and no head, aux also holds
    ``cer_dist`` / ``cer_chars`` (``space_id``: the vocabulary's space).
    On a ``mesh``, ``batches`` is this rank's ``[K / task, B / data]``
    slice, and the gradient is reduced over ``(task, data)``."""
    forward = make_forward_fn(model, cfg, mesh)
    clip, max_norm = cfg.train.clip, cfg.train.max_norm
    with_cer = cfg.train.device_cer and head is None
    if head is not None:
        head.on_mesh(mesh)

    def step(state: TrainState, batches: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, beta: float = 0.5):
        names = list(state.params)
        params = [state.params[n] for n in names]
        tp = tp_split(model, names)
        ces, terms, auxes, stats = [], [], [], []
        k_local = batches["targets"].shape[0]
        k = k_local * (1 if mesh is None else mesh.task.size)
        first = 0 if mesh is None else mesh.coords["task"] * k_local
        for i in range(k_local):
            stats.append([])
            ce, aux = forward(None, _task_batch(batches, i), generator, False,
                              with_encoder=head is not None,
                              stats_out=stats[-1])
            if head is not None:
                terms.append(head.terms(aux.pop("enc"), first + i, beta))
            ces.append(ce)
            auxes.append(aux)
        ce = _task_mean(ces, mesh, k)
        loss = ce
        if head is not None:
            loss = ce + _task_mean([t[0] for t in terms], mesh, k)
        d_params = [] if head is None else head.params(state)
        grads = list(torch.autograd.grad(loss, params + d_params))
        if mesh is not None:
            grads = comm.all_reduce_list(grads, mesh.plane)
            _agree_over_model(grads, tp, mesh)
        grads, d_grads = grads[:len(params)], grads[len(params):]
        if clip:
            grads = _clip_tree(grads, max_norm, tp=tp)
        optimizer.update(dict(zip(names, grads)), state.opt_state,
                         state.params)
        _merge_batch_stats(model, stats, mesh)
        hyp = torch.stack([a["hyp"] for a in auxes])
        gold = torch.stack([a["gold"] for a in auxes])
        out = {"hyp": _gather_tasks(hyp, mesh),
               "gold": _gather_tasks(gold, mesh)}
        if with_cer:
            out.update(_device_cer_metrics(hyp, gold, space_id, mesh))
        ce = _global(ce.detach(), mesh)
        if head is not None:
            head.update(state, d_grads)
            out["ce"] = ce
            out.update(head.metrics(terms, k))
        state.step += 1
        return state, ce, out

    return step


def make_meta_step(model: torch.nn.Module, cfg: Config, outer_optimizer,
                   per_task_query: bool = False, head=None,
                   space_id: Optional[int] = None, mesh=None,
                   bias_corrections=None) -> Callable:
    """One meta iteration, first order or (``cfg.train.second_order``)
    second order. ``step(state, support, query,
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
    discriminator's gradients are the mean over the tasks, not clipped.

    With ``cfg.train.device_cer`` and no head, the metrics also hold
    ``cer_dist`` / ``cer_chars`` of the support hyps. Second order takes no
    head and no ``--copy-grad`` (both raise, as in the JAX package).

    On a ``mesh``, ``support`` is this rank's ``[K / task, B / data]``
    slice and ``query`` its ``[B / data]`` slice (MAML: ``[K / task, B /
    data]``); the metrics are the global batch's on every rank.

    ``bias_corrections`` (``optim.DeviceBiasCorrection``) goes to the outer
    Adam's ``update``: the step that ``graphs.GraphedMetaStep`` captures
    reads them from the device."""
    second_order = cfg.train.second_order
    if cfg.train.copy_grad and second_order:
        raise ValueError("--copy-grad (first-order) contradicts "
                         "--second-order; pass one or the other")
    if head is not None and second_order:
        raise ValueError(
            "--second-order is not implemented for the adversarial/multitask"
            " meta step; drop --second-order or the discriminator flags")
    forward = make_forward_fn(model, cfg, mesh)
    inner_lr, clip, max_norm = cfg.train.lr, cfg.train.clip, cfg.train.max_norm
    with_cer = cfg.train.device_cer and head is None
    outer_update = outer_optimizer.update
    if bias_corrections is not None:
        outer_update = functools.partial(outer_update,
                                         corrections=bias_corrections)
    if head is not None:
        head.on_mesh(mesh)

    def second_order_task(names, params, s_loss, q, generator, stats_out,
                          tp):
        """(query loss, its aux) of ``task_outer_loss``, whose gradient at p
        flows through the inner SGD step (and, on a mesh, through the
        all-reduce of the support gradient over ``data``)."""
        with span("meta.support_grad"):
            g = torch.autograd.grad(s_loss, params, create_graph=True)
            if mesh is not None:
                g = comm.all_reduce_grad_list(g, mesh.data)
        with span("meta.inner_sgd"):
            if clip:
                g = _clip_tree(g, max_norm, differentiable=True, tp=tp)
            adapted = [p - inner_lr * gi for p, gi in zip(params, g)]
        with span("meta.query_fwd"):
            return forward(dict(zip(names, adapted)), q, generator, False,
                           stats_out=stats_out)

    def step(state: TrainState, support: Dict[str, torch.Tensor],
             query: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, beta: float = 0.5):
        with span("meta.step"), \
                strict_f32() if second_order else contextlib.nullcontext():
            return run(state, support, query, generator, beta)

    def run(state, support, query, generator, beta):
        names = list(state.params)
        params = [state.params[n] for n in names]
        tp = tp_split(model, names)
        d_params = [] if head is None else head.params(state)
        if not per_task_query:  # the shared query's features, once
            with span("meta.query_features"):
                feats, lengths = prepare_features(query, cfg)
            query = {"features": feats, "input_lengths": lengths,
                     "targets": query["targets"],
                     "src_percentages": query["src_percentages"]}
        k_local = support["targets"].shape[0]
        k = k_local * (1 if mesh is None else mesh.task.size)
        first = 0 if mesh is None else mesh.coords["task"] * k_local
        gsum = None  # the sum over the tasks of the model's gradients
        # at the adapted weights, then the discriminator's
        q_losses, s_losses, s_aux, q_aux, terms, ces = [], [], [], [], [], []
        stats = []  # the query forwards' BatchNorm statistics
        for i in range(k_local):
            with span("meta.support_fwd"):
                s_loss, aux = forward(None, _task_batch(support, i),
                                      generator, False)
            q = _task_batch(query, i) if per_task_query else query
            stats.append([])
            if second_order:
                q_loss, aux_q = second_order_task(
                    names, params, s_loss, q, generator, stats[-1], tp)
                wrt = params
            else:
                with span("meta.support_grad"):
                    g = list(torch.autograd.grad(s_loss, params))
                    if mesh is not None:
                        g = comm.all_reduce_list(g, mesh.data)
                with span("meta.inner_sgd"):
                    if clip:
                        g = _clip_tree(g, max_norm, tp=tp)
                    with torch.no_grad():
                        adapted = list(torch._foreach_add(params, g,
                                                          alpha=-inner_lr))
                    for a in adapted:
                        a.requires_grad_(True)
                with span("meta.query_fwd"):
                    q_loss, aux_q = forward(dict(zip(names, adapted)), q,
                                            generator, False,
                                            with_encoder=head is not None,
                                            stats_out=stats[-1])
                    if head is not None:
                        ces.append(q_loss.detach())
                        terms.append(head.terms(
                            aux_q.pop("enc"),
                            first + i if per_task_query else k - 1, beta))
                        q_loss = q_loss + terms[-1][0]
                wrt = adapted + d_params
            with span("meta.query_grad"):
                gq = list(torch.autograd.grad(q_loss, wrt))
                if gsum is None:
                    gsum = gq
                else:
                    torch._foreach_add_(gsum, gq)
            q_losses.append(q_loss.detach())
            s_losses.append(s_loss.detach())
            s_aux.append(aux)
            q_aux.append(aux_q)
            # the task's graph and adapted weights, before the next task
            del s_loss, q_loss, wrt
        with span("meta.outer"):
            if mesh is not None:
                gsum = comm.all_reduce_list(gsum, mesh.plane)
                _agree_over_model(gsum, tp, mesh)
            torch._foreach_div_(gsum, k)
            gsum, dsum = gsum[:len(params)], gsum[len(params):]
            if clip:
                gsum = _clip_tree(gsum, max_norm, tp=tp)
            outer_update(dict(zip(names, gsum)), state.opt_state,
                         state.params)
            _merge_batch_stats(model, stats, mesh)
            s_hyp = torch.stack([a["hyp"] for a in s_aux])
            s_gold = torch.stack([a["gold"] for a in s_aux])
            metrics = {
                "outer_loss": _global(_task_mean(q_losses, mesh, k), mesh),
                "support_losses": _support_losses(s_losses, mesh, first, k),
                "support_hyp": _gather_tasks(s_hyp, mesh),
                "support_gold": _gather_tasks(s_gold, mesh),
                "query_hyp": _gather_tasks(
                    torch.stack([a["hyp"] for a in q_aux]), mesh),
                "query_gold": _gather_tasks(
                    torch.stack([a["gold"] for a in q_aux]), mesh),
            }
            if with_cer:
                metrics.update(_device_cer_metrics(s_hyp, s_gold, space_id,
                                                   mesh))
            if head is not None:
                head.update(state, dsum)
                metrics["query_ce"] = _global(_task_mean(ces, mesh, k), mesh)
                metrics.update(head.metrics(terms, k))
        state.step += 1
        return state, metrics

    return step


def _support_losses(s_losses: List[torch.Tensor], mesh, first: int,
                    k: int) -> torch.Tensor:
    """[K] support losses: on a mesh each rank's shares sit at its tasks'
    places, summed over the ranks."""
    if mesh is None:
        return torch.stack(s_losses)
    full = s_losses[0].new_zeros(k)
    full[first:first + len(s_losses)] = torch.stack(s_losses)
    return comm.all_reduce(full, mesh.plane)


def make_eval_step(model: torch.nn.Module, cfg: Config) -> Callable:
    """Deterministic evaluation of one batch (mtl_tpu/train/steps.py:
    434-482) at the model's parameters, or at ``params`` (a dict by name,
    such as meta-test's adapted weights) through ``functional_call``:
    (loss, aux with ``hyp``, ``gold`` and the per-row ``row_loss`` /
    ``row_tokens``, so that the padded rows of a ragged final batch can be
    left out). Under CTC a row's loss is its CTC over max(target length,
    1) and it counts as one token."""
    smoothing = cfg.train.label_smoothing

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor],
             params: Optional[Dict[str, torch.Tensor]] = None):
        feats, input_lengths = prepare_features(batch, cfg)
        seq_in, seq_out = make_teacher_forcing(batch["targets"])
        args = (feats, input_lengths, seq_in)
        logits = (model(*args, deterministic=True) if params is None
                  else functional_call(model, params, args))
        if cfg.train.loss == "ctc":
            targets = batch["targets"]
            tlens = target_lengths(targets)
            row_loss = ctc_row_losses(
                torch.log_softmax(logits, dim=-1),
                _ctc_input_lengths(batch, logits.shape[1]), targets, tlens)
            row_tokens = torch.ones_like(tlens)
        else:
            row_loss, row_tokens = ce_row_losses(logits, seq_out, PAD_ID,
                                                 smoothing)
        loss = masked_loss_guard(row_loss.sum()
                                 / row_tokens.sum().clamp_min(1))
        return loss, {"hyp": logits.argmax(dim=-1), "gold": seq_out,
                      "row_loss": row_loss, "row_tokens": row_tokens}

    return step
