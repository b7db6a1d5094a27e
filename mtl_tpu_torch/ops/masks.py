"""Length- and id-based attention / padding masks (port of
mtl_tpu/ops/masks.py; reference modules/common_layers.py:38-84).

* ``non_pad_mask``: 1.0 at valid positions, 0.0 at pad, B x T x 1.
* attention masks: True where a position must NOT be attended, B x T_q x T_k.

The reference builds encoder masks from the *un-downsampled* input lengths
while the encoder runs on conv-downsampled time; callers replicate that by
passing the raw lengths (positions beyond T then count as valid).
"""

from __future__ import annotations

import torch


def non_pad_mask_from_lengths(lengths: torch.Tensor,
                              max_len: int) -> torch.Tensor:
    """B -> B x T x 1 float mask; 1.0 where position < length."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()[:, :, None]


def non_pad_mask_from_ids(seq: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """B x T ids -> B x T x 1 float mask; 1.0 where id != pad_idx
    (mtl_tpu/ops/masks.py:32)."""
    return (seq != pad_idx).float()[:, :, None]


def attn_pad_mask_from_lengths(lengths: torch.Tensor, key_len: int,
                               query_len: int) -> torch.Tensor:
    """B -> B x T_q x T_k bool mask; True where the KEY position is pad."""
    pos = torch.arange(key_len, device=lengths.device)[None, :]
    pad = pos >= lengths[:, None]
    return pad[:, None, :].expand(lengths.shape[0], query_len, key_len)


def attn_key_pad_mask(seq_k: torch.Tensor, query_len: int,
                      pad_idx: int) -> torch.Tensor:
    """B x T_k ids -> B x T_q x T_k bool mask; True where key id == pad."""
    pad = seq_k == pad_idx
    return pad[:, None, :].expand(seq_k.shape[0], query_len, seq_k.shape[1])


def subsequent_mask(seq_len: int, device=None) -> torch.Tensor:
    """T -> T x T bool mask; True strictly above the diagonal (the future)
    (mtl_tpu/ops/masks.py:65)."""
    return torch.ones((seq_len, seq_len), dtype=torch.bool,
                      device=device).triu(1)
