"""LM evaluation (the evaluation half of mtl_tpu/lm/train.py; reference
lm/main.py:189-241 and lm/test.py:189-368).

* ``evaluate_lm``: length-weighted CE over the bptt windows of a
  batchified stream, the hidden state carried across windows;
* ``evaluate_lm_test``: perplexity plus the code-switch transition
  breakdown (en->en / en->zh / zh->en / zh->zh token losses, skipping pairs
  with ``<eos>``; correct bucket names, where the reference swaps them,
  lm/test.py:269-312) and the per-word probability dump.

LM training (the plain, joint and meta-transfer steps) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.metrics import is_contain_chinese_word
from .data import batchify, get_batch
from .model import RNNLM


def make_lm_eval_step(model: RNNLM) -> Callable:
    """step(data [T, B], target [T*B], carry) -> (mean CE, per-token CE
    [T*B], new carry); numpy ids go to the model's device."""
    device = model.embed.weight.device

    @torch.no_grad()
    def step(data, target, carry):
        data, target = np.asarray(data), np.asarray(target).reshape(-1)
        if max(data.max(), target.max()) >= model.ntoken:
            raise ValueError(f"token id outside the LM's {model.ntoken} "
                             f"words (a word the LM was not trained on)")
        data = torch.as_tensor(data, dtype=torch.long, device=device)
        target = torch.as_tensor(target, dtype=torch.long, device=device)
        logits, carry = model(data, carry)
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
