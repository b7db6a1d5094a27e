"""Levenshtein distance on the device (port of
mtl_tpu/ops/edit_distance_jax.py): the training CER of ``--device-cer``
computed on the batch's device, two scalars read by the host instead of
token matrices decoded into strings every iteration.

The row recurrence ``cur[j] = min(prev[j] + 1, prev[j-1] + sub_j,
cur[j-1] + 1)`` is vectorized with a prefix minimum: with ``c[j] =
min(prev[j] + 1, prev[j-1] + sub_j)``, ``cur[j] = j + min_{k<=j}(c[k] -
k)``, one ``torch.cummin`` a row (the JAX package's
``associative_scan(minimum)``), over the whole batch at once.

CER parity: with a character vocabulary, the reference's post-processing
(strip special tokens, drop spaces; transient_trainer.py:55-64) equals
dropping the PAD, SOS, EOS, OOV and space ids and comparing what remains.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..data.vocab import EOS_ID, OOV_ID, PAD_ID, SOS_ID


def edit_distance_device(hyp: torch.Tensor, hyp_len: torch.Tensor,
                         gold: torch.Tensor, gold_len: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row distances [B] between ``hyp[b, :hyp_len[b]]`` and
    ``gold[b, :gold_len[b]]`` (ids [B, L1] and [B, L2]; int64)."""
    b, l1 = hyp.shape
    j = torch.arange(gold.shape[1] + 1, device=gold.device)
    prev = j.expand(b, -1)
    gl = gold_len.long()[:, None]
    # finals[:, i] = D[i][gold_len]; D[0][gold_len] = gold_len
    finals = [gl[:, 0]]
    for i in range(l1):
        sub = (hyp[:, i:i + 1] != gold).long()
        c = torch.cat([prev[:, :1] + 1,
                       torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + sub)],
                      dim=1)
        prev = j + torch.cummin(c - j, dim=1).values
        finals.append(prev.gather(1, gl)[:, 0])
    return torch.stack(finals, dim=1).gather(
        1, hyp_len.long()[:, None])[:, 0]


def compact_ids(tokens: torch.Tensor, drop_ids: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Removes ``drop_ids`` from each row, left-compacting the rest:
    (compacted [B, L] PAD-filled, lengths [B])."""
    keep = torch.ones_like(tokens, dtype=torch.bool)
    for d in drop_ids:
        keep &= tokens != d
    b, l = tokens.shape
    # dropped ids go to a spare column, cut off below
    dest = torch.where(keep, keep.long().cumsum(dim=1) - 1, l)
    out = torch.full((b, l + 1), PAD_ID, dtype=tokens.dtype,
                     device=tokens.device)
    out.scatter_(1, dest, tokens)
    return out[:, :l], keep.sum(dim=1)


def device_cer(hyp: torch.Tensor, gold: torch.Tensor,
               space_id: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total edit distance, total gold characters) as 0-d tensors on the
    batch's device, the reference's train-CER semantics: the special ids
    and the space id are dropped before the comparison. ``hyp`` and
    ``gold`` are [B, L] ids (argmax hypotheses, EOS-terminated gold)."""
    drop = [PAD_ID, SOS_ID, EOS_ID, OOV_ID]
    if space_id is not None:
        drop.append(space_id)
    h, hl = compact_ids(hyp, drop)
    g, gl = compact_ids(gold, drop)
    return edit_distance_device(h, hl, g, gl).sum(), gl.sum()
