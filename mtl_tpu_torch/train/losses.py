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
  multitask head takes the first alone);
* CTC (:80-103), ``optax.ctc_loss``'s forward recursion with its finite
  log(0) (``LOG_EPSILON``), blank = PAD, each sequence's loss divided by
  its target length, then the batch mean.
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



# optax.ctc_loss's stand-in for log(0): an alignment that needs more frames
# than the input has costs a large finite loss there, where torch's
# F.ctc_loss returns inf (which masked_loss_guard would turn into a zero
# loss for the whole batch)
LOG_EPSILON = -1e5


def ctc_per_seq(logits: torch.Tensor, logit_paddings: torch.Tensor,
                labels: torch.Tensor, label_paddings: torch.Tensor,
                blank_id: int = PAD_ID) -> torch.Tensor:
    """``optax.ctc_loss`` (optax 0.2.6): logits B x T x C, paddings 1.0
    where padded (B x T, B x N, right-padded labels), labels B x N ->
    per-sequence negative log-likelihood [B]. The alpha recursion in log
    space over T, differentiable by autograd."""
    b, n = labels.shape
    logprobs = F.log_softmax(logits.float(), dim=-1)
    labellens = n - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    phi_t = logprobs[:, :, blank_id]  # [B, T]
    emit_t = logprobs.gather(
        2, labels.long()[:, None, :].expand(-1, logits.shape[1], -1))
    phi = torch.full((b, n + 1), LOG_EPSILON, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, device=logits.device)

    def add_to_phi(p, score):  # logaddexp into p[:, 1:]
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for t in range(logits.shape[1]):
        prev_phi_orig = phi
        # emit-to-phi epsilon transition, unless the next label repeats
        prev_phi = add_to_phi(phi, emit + LOG_EPSILON * repeat)
        e, p_blank = emit_t[:, t], phi_t[:, t:t + 1]
        pad = logit_paddings[:, t:t + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = add_to_phi(prev_phi + p_blank,
                              emit + p_blank + LOG_EPSILON * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = add_to_phi(phi, emit)
    return -phi_last.gather(1, labellens[:, None])[:, 0]


def ctc_row_losses(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                   targets: torch.Tensor, target_lengths: torch.Tensor,
                   pad_id: int = PAD_ID) -> torch.Tensor:
    """Per-row CTC of decoder outputs (the reference's quirk), blank = PAD,
    each sequence's loss over max(target length, 1): torch
    ``F.ctc_loss(reduction="mean")``'s terms (mtl_tpu/train/losses.py:
    80-103, steps.py:450-470)."""
    t, n = log_probs.shape[1], targets.shape[1]
    dev = log_probs.device
    logit_pad = (torch.arange(t, device=dev)[None, :]
                 >= input_lengths[:, None]).float()
    label_pad = (torch.arange(n, device=dev)[None, :]
                 >= target_lengths[:, None]).float()
    per_seq = ctc_per_seq(log_probs, logit_pad, targets, label_pad, pad_id)
    return per_seq / target_lengths.clamp_min(1)


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             pad_id: int = PAD_ID) -> torch.Tensor:
    """The batch mean of ``ctc_row_losses``."""
    return ctc_row_losses(log_probs, input_lengths, targets, target_lengths,
                          pad_id).mean()
