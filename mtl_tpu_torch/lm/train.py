"""LM training and evaluation (port of mtl_tpu/lm/train.py; reference
lm/main.py, lm/main_joint.py, lm/main_meta_transfer.py, lm/test.py).

* ``make_lm_sgd_step``: one bptt-window SGD step (lm/main.py:256-275):
  global-norm clip ``min(1, clip / (norm + 1e-6))``, the learning rate an
  argument, the carry in and out detached ("repackage_hidden");
* ``make_lm_joint_step``: the ratio-weighted sum of K task windows, each
  from a zero carry, then one clipped SGD step (lm/main_joint.py:321-327);
* ``make_lm_meta_step``: meta-transfer (lm/main_meta_transfer.py:299-368):
  per task an inner clipped SGD step at ``lr / meta_lr_factor``, the query
  loss of the last task's window at the adapted weights, the ratio-weighted
  sum of query losses, one clipped outer SGD step. First order detaches the
  inner gradient: the outer gradient is the sum over tasks of ratio_k times
  the query gradient at the adapted weights, which enter the model through
  ``torch.func.functional_call``. Second order differentiates through the
  inner step, which needs the LM's cell loop (``RNNLM(cell_loop=True)``);
* ``evaluate_lm``: length-weighted CE over the bptt windows of a
  batchified stream, the hidden state carried across windows;
* ``evaluate_lm_test``: perplexity plus the code-switch transition
  breakdown (en->en / en->zh / zh->en / zh->zh token losses, skipping pairs
  with ``<eos>``; correct bucket names, where the reference swaps them,
  lm/test.py:269-312) and the per-word probability dump.

A training step puts the model in training mode, runs its forward and
backward in true f32 (``strict_f32``) and updates the model's parameters in
place; evaluation runs in eval mode and restores the mode after.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..train.optim import global_norm
from ..utils.metrics import is_contain_chinese_word
from ..utils.precision import strict_f32
from .data import batchify, get_batch
from .model import RNNLM


def _ids(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _detach_carry(carry: List) -> List:
    return [tuple(x.detach() for x in c) if isinstance(c, tuple)
            else c.detach() for c in carry]


def make_lm_loss(model: RNNLM) -> Callable:
    """loss_fn(params, data [T, B], target [T*B], gen, carry) -> (mean token
    CE over T*B, new carry); ``params`` None runs the model's own weights, a
    dict by name runs those. Dropout draws from ``gen`` (None: none)."""

    def loss_fn(params, data, target, gen=None, carry=None):
        if params is None:
            logits, new_carry = model(data, carry, gen)
        else:
            logits, new_carry = functional_call(model, params, (data, carry),
                                                {"gen": gen})
        t, b, v = logits.shape
        lp = torch.log_softmax(logits.reshape(t * b, v), -1)
        return -lp.gather(1, target.reshape(-1, 1)).mean(), new_carry

    return loss_fn


def _clip_scale(grads, clip: float) -> torch.Tensor:
    return (clip / (global_norm(grads) + 1e-6)).clamp(max=1.0)


@torch.no_grad()
def _clipped_sgd_(params, grads, lr: float, clip: float) -> None:
    """p <- p - lr * min(1, clip / (norm + 1e-6)) * g, in place."""
    torch._foreach_add_(params, torch._foreach_mul(
        grads, _clip_scale(grads, clip) * -lr))


def make_lm_sgd_step(model: RNNLM, clip: float) -> Callable:
    """step(data, target, lr, gen, carry) -> (loss, detached new carry);
    numpy ids go to the model's device."""
    loss_fn = make_lm_loss(model)
    params = list(model.parameters())
    device = model.embed.weight.device

    def step(data, target, lr: float, gen, carry):
        model.train()
        with strict_f32():
            loss, new_carry = loss_fn(None, _ids(data, device),
                                      _ids(target, device), gen, carry)
            grads = torch.autograd.grad(loss, params)
        _clipped_sgd_(params, grads, lr, clip)
        return loss.detach(), _detach_carry(new_carry)

    return step


def make_lm_joint_step(model: RNNLM, clip: float,
                       ratios: Sequence[float]) -> Callable:
    """step(datas [K, T, B], targets [K, T*B], lr, gen) -> (ratio-weighted
    total, per-task losses [K])."""
    loss_fn = make_lm_loss(model)
    params = list(model.parameters())
    device = model.embed.weight.device
    weights = torch.tensor(ratios, dtype=torch.float32, device=device)

    def step(datas, targets, lr: float, gen):
        model.train()
        datas, targets = _ids(datas, device), _ids(targets, device)
        with strict_f32():
            losses = torch.stack([loss_fn(None, d, t, gen)[0]
                                  for d, t in zip(datas, targets)])
            total = (losses * weights).sum()
            grads = torch.autograd.grad(total, params)
        _clipped_sgd_(params, grads, lr, clip)
        return total.detach(), losses.detach()

    return step


def make_lm_meta_step(model: RNNLM, clip: float, ratios: Sequence[float],
                      meta_lr_factor: float,
                      second_order: bool = False) -> Callable:
    """step(datas [K, T, B], targets [K, T*B], q_data [T, B], q_target,
    lr, gen) -> (ratio-weighted query total, per-task query losses [K]).
    The outer gradient is that of sum_k ratio_k * L_query(p - (lr /
    meta_lr_factor) * clip(dL_k/dp)), with the inner gradient detached
    unless ``second_order``."""
    if second_order and not model.cell_loop:
        raise ValueError("second-order LM meta-transfer needs "
                         "RNNLM(cell_loop=True): cuDNN's RNN backward has "
                         "no double backward")
    loss_fn = make_lm_loss(model)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    device = model.embed.weight.device
    weights = torch.tensor(ratios, dtype=torch.float32, device=device)

    def task_query_loss(d, t, q_data, q_target, inner_lr, gen):
        """(query loss at the adapted weights, the adapted weights)."""
        loss = loss_fn(None, d, t, gen)[0]
        g = torch.autograd.grad(loss, params, create_graph=second_order)
        scale = _clip_scale(g, clip)
        g = [x * scale for x in g]
        if second_order:
            adapted = [p - inner_lr * x for p, x in zip(params, g)]
        else:
            with torch.no_grad():
                adapted = torch._foreach_add(params, g, alpha=-inner_lr)
            for a in adapted:
                a.requires_grad_(True)
        q_loss = loss_fn(dict(zip(names, adapted)), q_data, q_target, gen)[0]
        return q_loss, adapted

    def step(datas, targets, q_data, q_target, lr: float, gen):
        model.train()
        inner_lr = lr / meta_lr_factor
        datas, targets = _ids(datas, device), _ids(targets, device)
        q_data, q_target = _ids(q_data, device), _ids(q_target, device)
        q_losses, grads = [], None
        with strict_f32():
            for k in range(datas.shape[0]):
                q_loss, adapted = task_query_loss(
                    datas[k], targets[k], q_data, q_target, inner_lr, gen)
                q_losses.append(q_loss)
                if not second_order:
                    gq = torch.autograd.grad(q_loss * weights[k], adapted)
                    if grads is None:
                        grads = list(gq)
                    else:
                        torch._foreach_add_(grads, gq)
            q_losses = torch.stack(q_losses)
            total = (q_losses * weights).sum()
            if second_order:
                grads = torch.autograd.grad(total, params)
        _clipped_sgd_(params, grads, lr, clip)
        return total.detach(), q_losses.detach()

    return step


def joint_ratios(num_tasks: int, ratio: float) -> List[float]:
    """lm/main_joint.py:321-327: the last task gets ``ratio``, the others
    split 1 - ratio evenly."""
    if num_tasks == 1:
        return [1.0]
    return [(1.0 - ratio) / (num_tasks - 1)] * (num_tasks - 1) + [ratio]


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    """The model in eval mode for the body; its mode restored after."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def make_lm_eval_step(model: RNNLM) -> Callable:
    """step(data [T, B], target [T*B], carry) -> (mean CE, per-token CE
    [T*B], new carry), in eval mode; numpy ids go to the model's device."""
    device = model.embed.weight.device

    @torch.no_grad()
    def step(data, target, carry):
        data, target = np.asarray(data), np.asarray(target).reshape(-1)
        if max(data.max(), target.max()) >= model.ntoken:
            raise ValueError(f"token id outside the LM's {model.ntoken} "
                             f"words (a word the LM was not trained on)")
        with _eval_mode(model):
            logits, carry = model(_ids(data, device), carry)
        target = _ids(target, device)
        t, b, v = logits.shape
        lp = torch.log_softmax(logits.reshape(t * b, v), -1)
        tok_loss = -lp.gather(1, target[:, None])[:, 0]
        return tok_loss.mean(), tok_loss, carry

    return step


def evaluate_lm(model: RNNLM, stream: np.ndarray, bptt: int,
                eval_batch_size: int = 10) -> float:
    """Length-weighted average CE over the batchified token stream
    (lm/main.py:189-241; eval_batch_size=10 at lm/main.py:122)."""
    eval_batch_size = min(eval_batch_size, max(1, len(stream) // (bptt + 1)))
    source = batchify(np.asarray(stream).reshape(-1), eval_batch_size)
    eval_step = make_lm_eval_step(model)
    carry = model.init_carry(eval_batch_size)
    total_loss, total_len = 0.0, len(source)
    i = 0
    while i < len(source) - 1:
        data, target = get_batch(source, i, bptt)
        loss, _, carry = eval_step(data, target, carry)
        total_loss += float(loss) * data.shape[0]
        i += bptt
    return total_loss / max(total_len, 1)


def evaluate_lm_test(model: RNNLM, source: np.ndarray, idx2word: dict,
                     bptt: int, dump_path: Optional[str] = None) -> dict:
    """Perplexity + code-switch transition breakdown at batch size 1, like
    the reference's test path. ``dump_path``: write the per-word
    probability file (lm/main.py:217-250: one
    ``word\\tnext\\tp(next)\\tlogp(next)`` line per position, a blank line
    at the end of the stream)."""
    eval_step = make_lm_eval_step(model)
    data_source = source.reshape(-1, 1)
    carry = model.init_carry(1)
    total_loss = 0.0
    buckets = {"en_en": [0.0, 0], "en_zh": [0.0, 0],
               "zh_en": [0.0, 0], "zh_zh": [0.0, 0]}
    dump = open(dump_path, "w", encoding="utf-8") if dump_path else None
    try:
        i = 0
        n = len(data_source)
        while i < n - 1:
            data, target = get_batch(data_source, i, bptt)
            loss, tok_loss, carry = eval_step(data, target, carry)
            total_loss += float(loss) * data.shape[0]
            tok_loss = tok_loss.cpu().numpy()
            for j in range(data.shape[0]):
                sw = idx2word[int(data[j, 0])]
                tw = idx2word[int(target[j])]
                if dump is not None:
                    logp = -float(tok_loss[j])
                    dump.write(f"{sw}\t{tw}\t{math.exp(logp)}\t{logp}\n")
                if sw == "<eos>" or tw == "<eos>":
                    continue
                key = ("zh" if is_contain_chinese_word(sw) else "en") + "_" + (
                    "zh" if is_contain_chinese_word(tw) else "en")
                buckets[key][0] += float(tok_loss[j])
                buckets[key][1] += 1
            i += bptt
        if dump is not None:
            dump.write("\n")
    finally:
        if dump is not None:
            dump.close()
    out = {"loss": total_loss / max(n, 1)}
    out["ppl"] = math.exp(out["loss"])
    for k, (s, c) in buckets.items():
        out[f"{k}_loss"] = s / max(c, 1)
        out[f"{k}_ppl"] = math.exp(s / max(c, 1)) if c else float("nan")
        out[f"{k}_count"] = c
    cs_s = buckets["en_zh"][0] + buckets["zh_en"][0]
    cs_c = buckets["en_zh"][1] + buckets["zh_en"][1]
    out["cs_loss"] = cs_s / max(cs_c, 1)
    out["cs_ppl"] = math.exp(out["cs_loss"]) if cs_c else float("nan")
    return out
