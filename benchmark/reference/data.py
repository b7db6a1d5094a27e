"""The reference's own reading of the corpus: WAVs, transcripts and
batches, worked out again from the files the benchmark wrote, with the
draws that the training loop makes from its seeded ``RandomState``
(numpy's ``choice`` with uniform probabilities, support then query) and
the batch layout of static buckets: each utterance reflect-padded by
n_fft // 2, rows zero-padded to the bucket's samples, transcripts lowered,
a space put before them, labels mapped to ids after the four specials.
"""

from __future__ import annotations

import json
import wave
from typing import Dict, List, Sequence

import numpy as np

SPECIALS = 4  # <PAD> <SOS> <EOS> <OOV>


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as f:
        raw = f.readframes(f.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def read_ids(txt_path: str, label_ids: Dict[str, int]) -> List[int]:
    with open(txt_path, encoding="utf-8") as f:
        text = " " + f.read().replace("\n", "").lower()
    return [label_ids[ch] for ch in text if ch in label_ids]


def label_ids(labels_path: str) -> Dict[str, int]:
    with open(labels_path, encoding="utf-8") as f:
        labels = json.load(f)
    return {ch: SPECIALS + i for i, ch in enumerate(labels)}


def bucket(value: int, buckets: Sequence[int]) -> int:
    return next((b for b in buckets if value <= b), buckets[-1])


class Corpus:
    """The manifests of a corpus, read once."""

    def __init__(self, corpus: dict, config: dict, frame_buckets,
                 label_buckets, src_max_len: int = 2500):
        self.ids = label_ids(corpus["labels"])
        self.rows = [[tuple(line.strip().split(","))
                      for line in open(m, encoding="utf-8") if line.strip()]
                     for m in corpus["manifests"]]
        self.n_fft = int(config["sample_rate"] * config["window_size"])
        self.hop = int(config["sample_rate"] * config["window_stride"])
        self.frame_buckets, self.label_buckets = frame_buckets, label_buckets
        self.max_samples = (src_max_len - 1) * self.hop
        self._cache: Dict[str, np.ndarray] = {}

    def utterance(self, task: int, row: int):
        wav, txt = self.rows[task][row]
        if wav not in self._cache:
            self._cache[wav] = read_wav(wav)[:self.max_samples]
        return self._cache[wav], read_ids(txt, self.ids)

    def collate(self, pairs, frames: int, n_labels: int) -> Dict:
        pad = self.n_fft // 2
        s = (frames - 1) * self.hop
        audio = np.zeros((len(pairs), s + 2 * pad), np.float32)
        lengths = np.zeros(len(pairs), np.int64)
        targets = np.zeros((len(pairs), n_labels), np.int64)
        for i, (w, ids) in enumerate(pairs):
            w = w[:s]
            audio[i, :len(w) + 2 * pad] = np.pad(w, pad, mode="reflect")
            lengths[i] = len(w)
            targets[i, :min(len(ids), n_labels)] = ids[:n_labels]
        return {"audio": audio, "audio_lengths": lengths, "targets": targets}

    def buckets_of(self, pairs):
        frames = max(1 + len(w) // self.hop for w, _ in pairs)
        labels = max(max(1, len(ids)) for _, ids in pairs)
        return (bucket(frames, self.frame_buckets),
                bucket(labels, self.label_buckets))

    def meta_batches(self, seed: int, n_steps: int, k_train: int,
                     k_valid: int):
        """The first ``n_steps`` (support [K, B, ...], query [B, ...]) of
        a meta-transfer loop whose data set draws from RandomState(seed):
        k_train rows of every task, then k_valid of the last."""
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(n_steps):
            draws = []
            for task in list(range(len(self.rows))) + [len(self.rows) - 1]:
                n = len(self.rows[task])
                k = k_train if len(draws) < len(self.rows) else k_valid
                rows = rng.choice(np.arange(n), k, p=np.full(n, 1.0 / n),
                                  replace=True)
                draws.append([self.utterance(task, int(r)) for r in rows])
            t, l = self.buckets_of([p for d in draws for p in d])
            support = [self.collate(d, t, l) for d in draws[:-1]]
            support = {k: np.stack([b[k] for b in support])
                       for k in support[0]}
            out.append((support, self.collate(draws[-1], t, l)))
        return out

    def test_batch(self, index: int, batch: int):
        """Batch ``index`` of the first manifest in order (no labels
        needed: the served tokens are judged)."""
        n = len(self.rows[0])
        rows = [(index * batch + i) % n for i in range(batch)]
        pairs = [self.utterance(0, r) for r in rows]
        t, l = self.buckets_of(pairs)
        return self.collate(pairs, t, l)
