"""LM shallow-fusion scorer for beam-search rescoring, and its directory
format (port of mtl_tpu/lm/fusion.py; reference utils/lm.py).

* A fusion directory holds ``lm_meta.json`` ({word2idx, arch}) and
  ``lm_model.pt`` (the f32 state_dict, ``torch.save``), written by
  ``save_lm_fusion`` (lm/convert.py:433-448 parity).
* ``LMScorer.score_ids`` is calculate_lm_score (utils/lm.py:8-40): the
  character string -> EN words / ZH characters, CE sum over the word
  sequence plus ``<eos>``, returns (-loss/num_words + 1, num_words + 1,
  oov_count), OOV words mapped to ``<oov>``; an empty word string scores
  (-999.0, 0, 0). Past 256 transitions a sequence is cut, as the JAX
  scorer's largest bucket cuts it (mtl_tpu/lm/fusion.py:96-101).
* ``score_batch`` scores many hypotheses in one right-padded [T, N] LM
  call; the recurrence is causal, so each column's sum is its own
  sequence's.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import torch

from ..utils.metrics import (get_word_segments_per_language,
                             is_contain_chinese_word)
from .model import RNNLM

MAX_TRANSITIONS = 256  # the JAX scorer's largest length bucket


def save_lm_dir(path: str, meta_name: str, weights_name: str,
                model: RNNLM, word2idx: dict, arch: dict) -> None:
    """``meta_name`` ({arch, word2idx}) + ``weights_name`` (the state_dict
    on the CPU) under ``path``: the LM checkpoint and fusion formats."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, meta_name), "w", encoding="utf-8") as f:
        json.dump({"arch": arch, "word2idx": word2idx}, f,
                  ensure_ascii=False)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, weights_name))


def load_lm_dir(path: str, meta_name: str, weights_name: str,
                device: torch.device) -> Tuple[RNNLM, dict, dict]:
    """(model on ``device`` in eval mode, word2idx, arch)."""
    with open(os.path.join(path, meta_name), encoding="utf-8") as f:
        meta = json.load(f)
    arch = meta["arch"]
    model = RNNLM(rnn_type=arch.get("rnn_type", "LSTM"),
                  ntoken=arch["ntoken"], ninp=arch["ninp"],
                  nhid=arch["nhid"], nlayers=arch["nlayers"],
                  dropout=arch.get("dropout", 0.5),
                  tie_weights=arch.get("tie_weights", False))
    model.load_state_dict(torch.load(os.path.join(path, weights_name),
                                     map_location="cpu", weights_only=True))
    return model.to(device).eval(), meta["word2idx"], arch


def save_lm_fusion(path: str, model: RNNLM, word2idx: dict,
                   arch: dict) -> None:
    """lm/convert.py ``model_save`` parity (state_dict + metadata)."""
    save_lm_dir(path, "lm_meta.json", "lm_model.pt", model, word2idx, arch)


class LMScorer:
    def __init__(self, model: RNNLM, word2idx: dict):
        self.model = model
        self.word2idx = word2idx

    @classmethod
    def load(cls, path: str, device: torch.device) -> "LMScorer":
        model, word2idx, _ = load_lm_dir(path, "lm_meta.json",
                                         "lm_model.pt", device)
        return cls(model, word2idx)

    @torch.no_grad()
    def evaluate_batch(self, seqs: Sequence[str]) -> List[Tuple[float, int]]:
        """(CE sum over ``seq.split() + ['<eos>']``, OOV count) for each
        sequence (utils/lm.py:101-123), in one LM call."""
        rows, oovs = [], []
        oov_id = self.word2idx["<oov>"]
        for seq in seqs:
            words = seq.split() + ["<eos>"]
            ids = [self.word2idx.get(w, oov_id) for w in words]
            rows.append(ids[: MAX_TRANSITIONS + 1])
            oovs.append(sum(w not in self.word2idx for w in words))
        if not rows:
            return []
        device = self.model.embed.weight.device
        t = max(1, max(len(r) - 1 for r in rows))
        ids = torch.zeros((t + 1, len(rows)), dtype=torch.long)
        mask = torch.zeros((t, len(rows)), dtype=torch.bool)
        for j, r in enumerate(rows):
            ids[: len(r), j] = torch.tensor(r)
            mask[: len(r) - 1, j] = True
        ids, mask = ids.to(device), mask.to(device)
        logits, _ = self.model(ids[:-1])
        lp = torch.log_softmax(logits, -1)
        tok = -lp.gather(2, ids[1:, :, None])[..., 0]
        sums = torch.where(mask, tok, 0.0).sum(0).cpu().tolist()
        return list(zip(sums, oovs))

    def evaluate(self, seq: str) -> Tuple[float, int]:
        return self.evaluate_batch([seq])[0]

    @staticmethod
    def word_string(ids: Sequence[int], vocab) -> str:
        """The hypothesis as the LM's words: specials stripped, double
        spaces collapsed, EN runs kept as words and ZH segments split into
        characters (utils/lm.py:8-30)."""
        seq_str = "".join(vocab.id2label[int(i)] for i in ids)
        for tok in (vocab.PAD_TOKEN, vocab.SOS_TOKEN, vocab.EOS_TOKEN):
            seq_str = seq_str.replace(tok, "")
        seq_str = seq_str.replace("  ", " ")
        parts: List[str] = []
        for seg in get_word_segments_per_language(seq_str):
            if is_contain_chinese_word(seg):
                parts.extend(ch for ch in seg if ch != " ")
            elif seg:
                parts.append(seg)
        return " ".join(" ".join(parts).split())

    def score_batch(self, id_lists: Sequence[Sequence[int]], vocab
                    ) -> List[Tuple[float, int, int]]:
        """``score_ids`` of every id list, the non-empty ones in one LM
        call."""
        strs = [self.word_string(ids, vocab) for ids in id_lists]
        scored = iter(self.evaluate_batch([s for s in strs if s]))
        out = []
        for s in strs:
            if s == "":
                out.append((-999.0, 0, 0))
                continue
            score, oov = next(scored)
            n = len(s.split())
            out.append((-1.0 * score / n + 1.0, n + 1, oov))
        return out

    def score_ids(self, ids: Sequence[int], vocab) -> Tuple[float, int, int]:
        """calculate_lm_score parity (utils/lm.py:8-40)."""
        return self.score_batch([ids], vocab)[0]
