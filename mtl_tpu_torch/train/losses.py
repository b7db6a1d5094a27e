"""Cross-entropy losses of the meta-transfer step (port of
mtl_tpu/train/losses.py:26-77; reference utils/metrics.py:68-126).

* CE: token mean over non-pad positions (``F.cross_entropy(ignore_index=
  pad, reduction="mean")``);
* label smoothing: ``one_hot * (1 - eps) + (1 - one_hot) * eps / C``, mean
  over non-pad tokens;
* num_correct: argmax matches over non-pad positions;
* ``masked_loss_guard``: non-finite losses become 0;
* the discriminator heads' losses (:106-116): the discriminator's CE to a
  constant accent id and the encoder's MSE of its logits to uniform (the
  multitask head takes the first alone).

The CTC loss is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..data.vocab import PAD_ID


def ce_row_losses(logits: torch.Tensor, gold: torch.Tensor,
                  pad_id: int = PAD_ID, smoothing: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits B x L x C (f32), gold B x L ids -> per-row (loss sum over
    non-pad tokens, non-pad token count) (mtl_tpu/train/losses.py:26-54)."""
    mask = gold != pad_id
    log_probs = F.log_softmax(logits, dim=-1)
    if smoothing > 0.0:
        c = logits.shape[-1]
        one_hot = F.one_hot(torch.where(mask, gold, 0).long(), c).to(
            log_probs.dtype)
        one_hot = one_hot * (1.0 - smoothing) + (1.0 - one_hot) * smoothing / c
        tok_loss = -(one_hot * log_probs).sum(dim=-1)
    else:
        tok_loss = -log_probs.gather(-1, gold[..., None].long())[..., 0]
    row_loss = torch.where(mask, tok_loss, 0.0).sum(dim=-1)
    return row_loss, mask.sum(dim=-1)


def ce_loss(logits: torch.Tensor, gold: torch.Tensor, pad_id: int = PAD_ID,
            smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scalar mean loss over non-pad tokens, num_correct)
    (mtl_tpu/train/losses.py:57-70)."""
    mask = gold != pad_id
    row_loss, row_tokens = ce_row_losses(logits, gold, pad_id, smoothing)
    loss = row_loss.sum() / row_tokens.sum().clamp_min(1)
    num_correct = ((logits.argmax(dim=-1) == gold) & mask).sum()
    return loss, num_correct


def masked_loss_guard(loss: torch.Tensor) -> torch.Tensor:
    """Non-finite losses become 0 (mtl_tpu/train/losses.py:73-77)."""
    return torch.where(torch.isfinite(loss), loss, 0.0)


def adversarial_losses(disc_logits: torch.Tensor, accent_id: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the discriminator's CE against the constant ``accent_id``, the
    encoder's MSE of the logits to 1 / num_class)
    (mtl_tpu/train/losses.py:106-116)."""
    c = disc_logits.shape[-1]
    log_probs = F.log_softmax(disc_logits, dim=-1)
    disc_loss = -log_probs[:, accent_id].mean()
    enc_loss = ((disc_logits - 1.0 / c) ** 2).mean()
    return disc_loss, enc_loss

