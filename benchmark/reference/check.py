"""The numbers that decide ``correct``, each the program's reading against
the plain reference's, and the control's readings.

Training (``meta_readings``): the reference regenerates the weights from
the seed, reads the corpus and draws the first steps' batches itself,
draws the same dropout masks from a generator of the same seed, and runs
the first-order meta step (per task: support loss and gradient, inner SGD,
query loss and gradient at the adapted weights; the mean over the tasks;
outer Adam, optax's) in f32 with TF32 off. Compared:

* ``loss_gap``: the widest relative gap of the three steps' outer losses;
* ``grad1_gap``: the worst leaf's gap between the norms of the first
  outer gradient, over the larger of the reference's norm of that leaf and
  of the median leaf;
* ``change3_gap``: the same of the weights' change after three steps.

Both leave out the leaves whose reference gradient is under a thousandth
of the median leaf's: a key's bias under softmax, whose gradient is nought
but round-off, and which Adam moves by round-off alone.

Serving (``serve_readings``): over a sample of served batches, the
reference's logits at each served position (fed SOS and the served tokens)
and ``logit_gap``: the widest gap by which a served token's logit lies
below the reference's best, up to each row's first EOS.

The control (``quant="fp8"``) is the reference with every product in
float8 (operands e4m3, their gradients e5m2), put in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import Corpus
from .model import EOS, Reference, f32_context
from .params import param_shapes
from .weights import make_weights

QUIET_LEAF = 1e-3  # of the median leaf's reference gradient
B1, B2, EPS = 0.9, 0.999, 1e-8


def _corpus(corpus: dict, config: dict) -> Corpus:
    return Corpus(corpus, config, config["src_bucket_frames"],
                  config["tgt_bucket_len"], config["src_max_len"])


def _to(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _clip(g: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum((x * x).sum() for x in g))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [x * scale for x in g]


def reference_meta(config: dict, corpus: dict, seeds: dict, traffic: dict,
                   device, vocab_size: int, quant: Optional[str] = None,
                   n_steps: int = 3) -> dict:
    """The reference's (or with ``quant`` the control's) first ``n_steps``
    meta steps: {"losses", "g1" {name: norm}, "delta" {name: norm}}."""
    device = torch.device(device)
    k_train, k_valid = traffic["k_train"], traffic["k_valid"]
    if config["per_task_query"]:
        raise NotImplementedError("the reference follows the shared query")
    with f32_context():
        ref = Reference(config, device, quant)
        shapes = param_shapes(config, vocab_size)
        w0 = make_weights(shapes, seeds["weights"], device)
        names = list(shapes)
        W = {n: w0[n].clone().requires_grad_(True) for n in names}
        mu = {n: torch.zeros_like(W[n]) for n in names}
        nu = {n: torch.zeros_like(W[n]) for n in names}
        batches = _corpus(corpus, config).meta_batches(
            seeds["data"], n_steps, k_train, k_valid)
        gen = torch.Generator(device).manual_seed(seeds["dropout"])
        lr, meta_lr = config["lr"], config["meta_lr"]
        losses, g1 = [], None
        for step, (support, query) in enumerate(batches):
            support, query = _to(support, device), _to(query, device)
            k = support["targets"].shape[0]
            gsum = [torch.zeros_like(W[n]) for n in names]
            q_losses = []
            for i in range(k):
                task = {key: v[i] for key, v in support.items()}
                s_loss = ref.loss(W, task, gen)
                g = list(torch.autograd.grad(s_loss, [W[n] for n in names]))
                if config["clip"]:
                    g = _clip(g, config["max_norm"])
                adapted = {n: (W[n] - lr * gi).detach().requires_grad_(True)
                           for n, gi in zip(names, g)}
                q_loss = ref.loss(adapted, query, gen)
                gq = torch.autograd.grad(q_loss, [adapted[n] for n in names])
                for acc, x in zip(gsum, gq):
                    acc.add_(x)
                q_losses.append(float(q_loss.detach()))
                del s_loss, q_loss, g, gq, adapted
            grads = [x / k for x in gsum]
            if config["clip"]:
                grads = _clip(grads, config["max_norm"])
            if step == 0:
                g1 = {n: float(x.norm()) for n, x in zip(names, grads)}
            with torch.no_grad():
                c = step + 1
                for n, g in zip(names, grads):
                    mu[n].mul_(B1).add_(g, alpha=1 - B1)
                    nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                    upd = (mu[n] / (1 - B1 ** c)) / (
                        torch.sqrt(nu[n] / (1 - B2 ** c)) + EPS)
                    W[n].sub_(meta_lr * upd)
            losses.append(sum(q_losses) / len(q_losses))
        delta = {n: float((W[n].detach() - w0[n]).norm()) for n in names}
    return {"losses": losses, "g1": g1, "delta": delta}


def _leaf_gaps(mine: Dict[str, float], ref: Dict[str, float],
               keep: List[str]) -> Dict[str, float]:
    med = float(np.median([ref[n] for n in ref]))
    return {n: abs(mine[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in keep}


def meta_numbers(program: dict, ref: dict, detail: Optional[dict] = None
                 ) -> Dict[str, float]:
    """The three numbers of a run's readings against the reference's;
    ``detail`` receives each step's loss gap and the worst leaves."""
    med = float(np.median(list(ref["g1"].values())))
    keep = [n for n, v in ref["g1"].items() if v >= QUIET_LEAF * med]
    steps = [abs(a - b) / abs(b)
             for a, b in zip(program["losses"], ref["losses"])]
    g1 = _leaf_gaps(program["g1"], ref["g1"], keep)
    d3 = _leaf_gaps(program["delta"], ref["delta"], keep)
    out = {"loss_gap": max(steps), "loss1_gap": steps[0]}
    for name, gaps in (("grad1", g1), ("change3", d3)):
        v = np.array(list(gaps.values()))
        out.update({f"{name}_gap": float(v.max()),
                    f"{name}_median": float(np.median(v)),
                    f"{name}_p75": float(np.percentile(v, 75)),
                    f"{name}_p90": float(np.percentile(v, 90)),
                    f"{name}_mean": float(v.mean())})
    if detail is not None:
        detail.update(
            loss_gaps=steps, quiet=sorted(set(ref["g1"]) - set(keep)),
            grad1_worst=sorted(g1.items(), key=lambda x: -x[1])[:3],
            change3_worst=sorted(d3.items(), key=lambda x: -x[1])[:3])
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def meta_readings(config, corpus, seeds, traffic, device, vocab_size,
                  program: dict, detail: Optional[dict] = None
                  ) -> Dict[str, float]:
    ref = reference_meta(config, corpus, seeds, traffic, device, vocab_size)
    return meta_numbers(program, ref, detail)


def served_gaps(config: dict, corpus: dict, seeds: dict, device,
                vocab_size: int, served: List[dict],
                quant: Optional[str] = None) -> Dict[str, float]:
    """{"logit_gap": widest gap, "tokens": how many were judged} of the
    served batches ``served`` ([{"index", "tokens" [B, steps] int64}]).
    With ``quant`` the control: at each position the token the fp8
    reference puts first is judged instead of the served one."""
    device = torch.device(device)
    shapes = param_shapes(config, vocab_size)
    reader = _corpus(corpus, config)
    worst, judged = 0.0, 0
    with f32_context(), torch.no_grad():
        W = make_weights(shapes, seeds["weights"], device)
        ref = Reference(config, device)
        low = Reference(config, device, quant) if quant else None
        for item in served:
            batch = _to(reader.test_batch(item["index"], item["batch"]),
                        device)
            tokens = torch.as_tensor(item["tokens"], device=device)
            logits = ref.served_logits(W, batch["audio"],
                                       batch["audio_lengths"], tokens)
            pick = tokens
            if low is not None:
                pick = low.served_logits(W, batch["audio"],
                                         batch["audio_lengths"],
                                         tokens).argmax(-1)
            gap = logits.max(-1).values - logits.gather(
                -1, pick[..., None])[..., 0]
            eos = (tokens == EOS).int()
            # positions up to and including each row's first EOS
            live = (torch.cumsum(eos, 1) - eos) == 0
            worst = max(worst, float(gap[live].max()))
            judged += int(live.sum())
    return {"logit_gap": worst, "tokens": judged}


def reference_greedy(config: dict, corpus: dict, seeds: dict, device,
                     vocab_size: int, index: int, batch: int) -> np.ndarray:
    """The f32 reference's own greedy tokens for test batch ``index``, for
    as many steps as its longest transcript needs plus one."""
    device = torch.device(device)
    reader = _corpus(corpus, config)
    host = reader.test_batch(index, batch)
    steps = min(config["max_steps"], int((host["targets"] != 0).sum(1).max()) + 1)
    data = _to(host, device)
    with f32_context(), torch.no_grad():
        W = make_weights(param_shapes(config, vocab_size), seeds["weights"],
                         device)
        ref = Reference(config, device)
        enc, _ = ref.encode(W, data["audio"], data["audio_lengths"])
        tokens = torch.zeros((batch, 0), dtype=torch.long, device=device)
        for _ in range(steps):
            probe = torch.cat([tokens, tokens.new_zeros((batch, 1))], 1)
            nxt = ref.next_logits(W, enc, probe)[:, -1].argmax(-1)
            tokens = torch.cat([tokens, nxt[:, None]], 1)
    return tokens.cpu().numpy()
