"""Batched fixed-width beam search with LM shallow-fusion rescoring (port of
mtl_tpu/decode/beam.py; reference Decoder.beam_search,
modules/decoder.py:186-291).

Every utterance x beam advances in one flattened [B*W] batch over the
decoder's KV caches. Each step expands every live beam by all tokens and
keeps the top W of the B x (W*V) candidates; an expansion that ends in EOS
retires into a fixed-size bank of ended hypotheses and its slot dies. The
bank ranks by the reference's final score without the LM, ``raw +
sqrt(num_words) * c_weight``, with the word count kept on the device by
incremental word-run counting (PAD/SOS/EOS vanish from the string, a space
ends a word). The loop stops when no slot is alive or at ``max_steps``,
where the survivors get EOS appended and retire. The host then ranks the
bank by the final score, LM fusion included (``score + lm_weight *
(lm_score - 2*oov) + sqrt(num_words) * c_weight``, decoder.py:261-270).
Like the reference's search, no decoder-encoder mask is used.

Orders are the JAX package's: ``jax.lax.top_k`` returns equal values lowest
index first, so every top-k here is a stable descending sort
(``topk_stable``); scores and keys are f32 on the device, the host ranking
is Python float math on the f32 bank values. The all-dead test is the
loop's one host sync per step.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..data.vocab import (EOS_ID, EOS_TOKEN, PAD_ID, PAD_TOKEN, SOS_ID,
                          SOS_TOKEN, Vocab, post_process)
from ..models.decoder import reorder_caches
from ..models.transformer import ASRTransformer

NEG_INF = -1.0e9

# (keys, raw scores, words, tokens, lengths): the bank, or its candidates
Bank = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, equal values lowest index
    first (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _bank_insert(bank: Bank, cand: Bank, n_bank: int) -> Bank:
    """Merge retirement candidates into the bank, ranked by final key."""
    keys, raw, words, tokens, lens = (torch.cat([a, c], 1)
                                      for a, c in zip(bank, cand))
    top_keys, idx = topk_stable(keys, n_bank)
    return (top_keys, raw.gather(1, idx), words.gather(1, idx),
            tokens.gather(1, idx[..., None].expand(-1, -1, tokens.shape[2])),
            lens.gather(1, idx))


@torch.no_grad()
def beam_decode_ids(model: ASRTransformer, features: torch.Tensor,
                    input_lengths: torch.Tensor, beam_width: int = 3,
                    max_steps: int = 300, start_token: int = 1,
                    bank_size: int = 0, space_id: int = -1,
                    c_weight: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Returns (bank_tokens [B, N, max_steps+1], bank_scores [B, N] raw
    cumulative log-probs, bank_words [B, N] reference num_words,
    bank_lengths [B, N]): the best N = ``bank_size`` (0: max(W, 5)) ended
    hypotheses per utterance ranked by final score, EOS at position
    length-1; empty slots have score <= NEG_INF/2."""
    b, w = features.shape[0], beam_width
    n_bank = bank_size or max(beam_width, 5)
    dev = features.device
    f32, i64 = torch.float32, torch.long
    _, enc_kvs = model.prepare_decode(features, input_lengths)
    enc_kvs = [(k.repeat_interleave(w, 0), v.repeat_interleave(w, 0))
               for k, v in enc_kvs]
    caches = model.init_cache(b * w, max_steps + 1, dev)
    c = torch.tensor(c_weight, dtype=f32, device=dev)

    def final_key(raw, words):
        return raw + torch.sqrt(words.clamp_min(0).to(f32)) * c

    y = torch.full((b * w,), start_token, dtype=i64, device=dev)
    # only beam 0 alive at first (the others at NEG_INF, so that copies of
    # one expansion do not fill the beam)
    scores = torch.full((b, w), NEG_INF, dtype=f32, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.zeros((b, w, max_steps + 1), dtype=i64, device=dev)
    words = torch.zeros((b, w), dtype=i64, device=dev)
    in_word = torch.zeros((b, w), dtype=torch.bool, device=dev)
    bank = (torch.full((b, n_bank), 2 * NEG_INF, dtype=f32, device=dev),
            torch.full((b, n_bank), 2 * NEG_INF, dtype=f32, device=dev),
            torch.zeros((b, n_bank), dtype=i64, device=dev),
            torch.full((b, n_bank, max_steps + 1), EOS_ID, dtype=i64,
                       device=dev),
            torch.zeros((b, n_bank), dtype=i64, device=dev))
    beam_rows = torch.arange(b, device=dev)[:, None] * w

    t = 0
    while t < max_steps and bool((scores > NEG_INF / 2).any()):
        logits, caches = model.decode_step(y, t, enc_kvs, caches)
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), -1).view(b, w, v)
        alive = scores > NEG_INF / 2
        cand = (scores[..., None] + logp).masked_fill(~alive[..., None],
                                                      2 * NEG_INF)
        # top-W over all expansions, EOS included (the reference's
        # hyps_best_kept, decoder.py:239-250)
        top_scores, top_idx = topk_stable(cand.view(b, w * v), w)
        src_beam = torch.div(top_idx, v, rounding_mode="floor")
        next_tok = top_idx - src_beam * v

        tokens = tokens.gather(1, src_beam[..., None].expand_as(tokens))
        tokens[:, :, t] = next_tok
        # the reference's num_words, counted as tokens arrive
        # (decoder.py:265: strip specials -> collapse spaces -> split())
        words = words.gather(1, src_beam)
        in_word = in_word.gather(1, src_beam)
        is_special = ((next_tok == PAD_ID) | (next_tok == SOS_ID)
                      | (next_tok == EOS_ID))
        is_space = next_tok == space_id
        is_char = ~is_special & ~is_space
        words = words + (is_char & ~in_word).to(i64)
        in_word = is_char | (~is_space & in_word)

        # EOS selections retire into the bank and their slot dies
        # (decoder.py:257-276)
        is_eos = next_tok == EOS_ID
        bank = _bank_insert(bank, (
            final_key(top_scores, words).masked_fill(~is_eos, 2 * NEG_INF),
            top_scores.masked_fill(~is_eos, 2 * NEG_INF), words, tokens,
            torch.full((b, w), t + 1, dtype=i64, device=dev)), n_bank)
        scores = top_scores.masked_fill(is_eos, NEG_INF)
        caches = reorder_caches(caches, (beam_rows + src_beam).view(-1))
        y = next_tok.view(-1)
        t += 1

    # the horizon: survivors get EOS appended and retire (the reference's
    # force-append, decoder.py:253-255)
    live = scores > NEG_INF / 2
    tokens[:, :, t] = EOS_ID
    _, bank_scores, bank_words, bank_tokens, bank_len = _bank_insert(bank, (
        final_key(scores, words).masked_fill(~live, 2 * NEG_INF),
        scores.masked_fill(~live, 2 * NEG_INF), words, tokens,
        torch.full((b, w), t + 1, dtype=i64, device=dev)), n_bank)
    return bank_tokens, bank_scores, bank_words, bank_len


def ref_num_words(ids: Sequence[int], vocab: Vocab) -> int:
    """The reference's num_words for the length bonus (decoder.py:265):
    strip only PAD/SOS/EOS token strings (OOV stays), collapse double
    spaces, split on whitespace."""
    raw = "".join(vocab.id2label[int(i)] for i in ids)
    for tok in (PAD_TOKEN, SOS_TOKEN, EOS_TOKEN):
        raw = raw.replace(tok, "")
    return len(raw.replace("  ", " ").split())


def beam_search_grouped(model: ASRTransformer, features, input_lengths,
                        vocab: Vocab, beam_width: int = 3, nbest: int = 5,
                        max_steps: int = 300, start_token: int = 1,
                        c_weight: float = 0.1, lm=None,
                        lm_rescoring: bool = False, lm_weight: float = 0.1
                        ) -> List[List[Tuple[float, List[int], str]]]:
    """Per-utterance n-best lists [(final_score, ids, string), ...] sorted
    best-first (test.py groups them per utterance to align hypotheses with
    golds when nbest > 1). With ``lm_rescoring`` the whole bank of the
    batch is scored in one LM call."""
    # under LM rescoring the device bank ranks by the final score without
    # the LM: widen it so the LM's reranking sees enough candidates
    n_bank = max(nbest, beam_width) * (4 if lm_rescoring else 1)
    tokens, scores, _, lengths = beam_decode_ids(
        model, features, input_lengths, beam_width, max_steps, start_token,
        n_bank, vocab.label2id.get(" ", -1), c_weight)
    tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
    lengths = lengths.cpu().numpy()
    entries = [(x, j, tokens[x, j, : lengths[x, j]].tolist())
               for x in range(tokens.shape[0]) for j in range(n_bank)
               if scores[x, j] > NEG_INF / 2]  # else an empty bank slot
    lm_scores = None
    if lm_rescoring and lm is not None:
        lm_scores = lm.score_batch([[start_token] + ids
                                    for _, _, ids in entries], vocab)

    grouped: List[List[Tuple[float, List[int], str]]] = [
        [] for _ in range(tokens.shape[0])]
    for e, (x, j, ids) in enumerate(entries):
        # post_process_hyp semantics (decoder.py:117-128): specials
        # stripped, no double-space collapse
        s = post_process("".join(vocab.id2label[int(i)] for i in ids),
                         vocab.special_token_list)
        if lm_scores is not None:
            lm_score, num_words, oov = lm_scores[e]
            final = (scores[x, j] + lm_weight * (lm_score - 2 * oov)
                     + math.sqrt(max(num_words, 0)) * c_weight)
        else:
            final = (scores[x, j]
                     + math.sqrt(ref_num_words(ids, vocab)) * c_weight)
        grouped[x].append((float(final), ids, s))
    for hyps in grouped:
        hyps.sort(key=lambda h: h[0], reverse=True)
        del hyps[nbest:]
    return grouped


def beam_search(model: ASRTransformer, features, input_lengths,
                vocab: Vocab, beam_width: int = 3, nbest: int = 5,
                max_steps: int = 300, start_token: int = 1,
                c_weight: float = 0.1, lm=None, lm_rescoring: bool = False,
                lm_weight: float = 0.1) -> Tuple[List[List[int]], List[str]]:
    """(n-best id lists, n-best strings) flattened over the batch, as the
    reference appends every utterance's n-best (decoder.py:286-291)."""
    grouped = beam_search_grouped(model, features, input_lengths, vocab,
                                  beam_width, nbest, max_steps, start_token,
                                  c_weight, lm, lm_rescoring, lm_weight)
    ids_nbest, strs_nbest = [], []
    for hyps in grouped:
        for _, ids, s in hyps:
            ids_nbest.append([start_token] + ids)
            strs_nbest.append(s)
    return ids_nbest, strs_nbest
