"""Teacher-forcing targets (port of mtl_tpu/ops/targets.py:19-41; reference
Decoder.preprocess, modules/decoder.py:55-69).

Strip PAD, prepend SOS, append EOS; the input sequence is padded with EOS
and the output sequence with PAD. A static-shape tensor transform that
assumes compact targets (the non-pad tokens of each row form a prefix, as
every loader of both packages writes them).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..data.vocab import EOS_ID, PAD_ID, SOS_ID


def target_lengths(targets: torch.Tensor,
                   pad_id: int = PAD_ID) -> torch.Tensor:
    """Non-pad tokens per row (mtl_tpu/ops/targets.py:19)."""
    return (targets != pad_id).sum(dim=-1)


def make_teacher_forcing(targets: torch.Tensor, pad_id: int = PAD_ID,
                         sos_id: int = SOS_ID, eos_id: int = EOS_ID
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """targets B x L (PAD-padded) -> (seq_in B x (L+1) EOS-padded, seq_out
    B x (L+1) PAD-padded with EOS at each row's length)
    (mtl_tpu/ops/targets.py:23-41)."""
    b, l = targets.shape
    lengths = target_lengths(targets, pad_id)
    sos_col = torch.full((b, 1), sos_id, dtype=targets.dtype,
                         device=targets.device)
    body = torch.where(targets == pad_id, eos_id, targets)
    seq_in = torch.cat([sos_col, body], dim=1)
    out = torch.cat([targets, torch.full_like(sos_col, pad_id)], dim=1)
    pos = torch.arange(l + 1, device=targets.device)[None, :]
    seq_out = torch.where(pos == lengths[:, None], eos_id, out)
    return seq_in, seq_out
