"""Word-level LM corpora: Dictionary / Corpus / bptt batching (a copy of
mtl_tpu/lm/data.py for the PyTorch port; numpy only).

Parity: lm/util/data.py —
* ``Dictionary``: growing word<->id map (:69-81);
* ``Corpus``: per-line ``split() + ['<eos>']`` tokenization, lowercased,
  double-space collapsed, ``<oov>`` fallback, per-token language tags
  (Chinese detection) (:83-195). A shared Dictionary can be chained across
  corpora (CV -> HKUST -> SEAME at lm/main_meta_transfer.py:131-140);
* ``LMDataset``: batchify trims to a multiple of batch_size and reshapes to
  [T, B] (:25-34); ``get_batch`` bptt windows (:36-44); ``sample(manifest_id,
  i)`` deterministic support/query windows with the reference's modulo
  arithmetic (:46-67), manifest_id=-1 = last task (SEAME).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.metrics import is_contain_chinese_word


class Dictionary:
    def __init__(self):
        self.word2idx = {}
        self.idx2word = {}

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.idx2word[len(self.idx2word)] = word
            self.word2idx[word] = len(self.idx2word) - 1
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.idx2word)


def _lines_to_words(line: str) -> List[str]:
    line = line.strip().lower().replace("  ", " ")
    return line.split() + ["<eos>"]


class Corpus:
    def __init__(self, train_path: str, valid_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 dictionary: Optional[Dictionary] = None, seed: int = 1000):
        self.dictionary = dictionary if dictionary is not None else Dictionary()
        self.train, self.train_lang = self.tokenize(train_path, save=True)
        self.valid = self.valid_lang = None
        self.test = self.test_lang = None
        if valid_path is not None:
            self.valid, self.valid_lang = self.tokenize(valid_path, save=False)
        if test_path is not None:
            self.test, self.test_lang = self.tokenize(test_path, save=False)

    def tokenize(self, path: str, save: bool) -> Tuple[np.ndarray, np.ndarray]:
        assert os.path.exists(path), path
        self.dictionary.add_word("<oov>")
        ids: List[int] = []
        langs: List[int] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                for word in _lines_to_words(line):
                    if save:
                        self.dictionary.add_word(word)
                    ids.append(
                        self.dictionary.word2idx.get(
                            word, self.dictionary.word2idx["<oov>"]
                        )
                    )
                    langs.append(1 if is_contain_chinese_word(word) else 0)
        return np.asarray(ids, np.int32), np.asarray(langs, np.int32)


def batchify(data: np.ndarray, bsz: int) -> np.ndarray:
    """[N] -> [T, B] column-major batch layout (lm/util/data.py:25-34)."""
    nbatch = len(data) // bsz
    data = data[: nbatch * bsz]
    return data.reshape(bsz, -1).T.copy()


def get_batch(source: np.ndarray, i: int, bptt: int):
    """(data [L, B], target [L*B]) with L = min(bptt, T-1-i)."""
    seq_len = min(bptt, len(source) - 1 - i)
    data = source[i:i + seq_len]
    target = source[i + 1:i + 1 + seq_len].reshape(-1)
    return data, target


class LMDataset:
    def __init__(self, task_list: Sequence[np.ndarray], bptt: int,
                 batch_size: int):
        self.bptt = bptt
        self.batch_size = batch_size
        self.task_list = [batchify(t, batch_size) for t in task_list]

    def sample(self, manifest_id: int, i: int):
        """Deterministic (tr, val) bptt windows (lm/util/data.py:46-67).

        Starts are additionally clamped so every window is a FULL bptt window
        — the reference lets end-of-stream windows come out ragged, which
        cannot be stacked across tasks for the vmapped meta step (and torch
        simply recompiled on them)."""
        ids = self.task_list[manifest_id]
        assert len(ids) > self.bptt, (
            f"task stream too short: {len(ids)} rows <= bptt {self.bptt}"
        )
        tr_id, val_id = i, i + 1
        n = len(ids)
        last_full = n - 1 - self.bptt

        def start(idx):
            s = ((idx * self.bptt) % n) - (((idx * self.bptt) % n) % self.bptt)
            return min(s, last_full)

        tr_src, tr_tgt = get_batch(ids, start(tr_id), self.bptt)
        val_src, val_tgt = get_batch(ids, start(val_id), self.bptt)
        return tr_src, tr_tgt, val_src, val_tgt

    def windows(self, manifest_id: int):
        source = self.task_list[manifest_id]
        for i in range(0, len(source) - 1, self.bptt):
            yield get_batch(source, i, self.bptt)
