"""Multi-manifest dataset + static-shape batching (copy of
mtl_tpu/data/dataset.py).

Reference parity (utils/data_loader.py:170-500): manifests are CSVs of
``audio_path,transcript_path`` rows; transcripts are ``.txt`` files (read,
``'\\n'`` stripped, lowercased, with a leading space prepended) or inline
strings (:342-361), OOV chars dropped; features are truncated at
``src_max_len`` frames (:263,331). Multi-manifest training uses round-robin
``index % num_manifests`` with ``max_size`` forced to 30000 (:198-202);
``--train-partition-list`` restricts per-manifest sampling to a prefix with
uniform probabilities (:211-222); ``sample_meta_batch`` draws the support
and query batches of one meta iteration (:245-321).

Batches are padded to static bucket shapes and carry raw prepadded
waveforms; the STFT front-end runs on the device. The draws come from one
``np.random.RandomState(seed)`` in the JAX package's order, so both
packages draw the same utterances for one seed; a caller may pass its own
``RandomState`` instead (the prefetch workers' per-iteration draws). With
``augment`` each loaded waveform takes a random tempo and gain, and with
``cfg.audio.noise_dir`` (on every set, as in the JAX package) noise with
probability ``noise_prob``, drawn from the same ``RandomState`` in the JAX
package's order (mtl_tpu/data/dataset.py:174-205); the wave cache is off
then.
"""

from __future__ import annotations

import csv
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from .audio import NoiseInjector, augment_audio, load_audio
from .vocab import PAD_ID, Vocab


def read_manifest(path: str) -> List[Tuple[str, str]]:
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f):
            if not row:
                continue
            rows.append((row[0], row[1] if len(row) > 1 else ""))
    return rows


def parse_transcript(transcript_path: str, vocab: Vocab,
                     input_type: str = "char") -> List[int]:
    """Reference parse_transcript (utils/data_loader.py:342-361):
    char: .txt file (leading space prepended, lowercased) or inline string;
    ipa: pre-tokenized id arrays stored as .npy."""
    if input_type == "ipa":
        return [int(i) for i in np.load(transcript_path)]
    if transcript_path.endswith(".txt"):
        with open(transcript_path, encoding="utf8") as f:
            text = " " + f.read().replace("\n", "").lower()
    else:
        text = transcript_path.replace("\n", "").lower()
    return vocab.encode_transcript(text)


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value; values beyond the largest bucket clamp to
    it (truncation happens before bucketing)."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def collate_audio(
    waves: List[np.ndarray],
    transcripts: List[List[int]],
    hop_length: int,
    src_bucket_frames: Sequence[int],
    tgt_bucket_len: Sequence[int],
    src_max_len: int,
    n_fft: int = 320,
    force_frames: Optional[int] = None,
    force_tgt: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Pad a list of utterances into one static-shape batch.

    Frames(T) relate to samples(S) by T = 1 + S // hop (center STFT), so the
    per-bucket sample count is (bucket_frames - 1) * hop. Each utterance is
    reflect-padded by n_fft//2 on both sides here, so the device STFT matches
    librosa's center=True semantics even though the batch is zero-padded;
    the ``audio`` rows carry ``bucket_s + n_fft`` samples and the front-end
    runs with prepadded=True.
    """
    b = len(waves)
    pad = n_fft // 2
    max_samples = (src_max_len - 1) * hop_length
    waves = [w[:max_samples] for w in waves]
    frames = [1 + len(w) // hop_length for w in waves]
    tgt_lens = [max(1, len(t)) for t in transcripts]

    bucket_t = force_frames or pick_bucket(max(frames), src_bucket_frames)
    bucket_l = force_tgt or pick_bucket(max(tgt_lens), tgt_bucket_len)
    bucket_s = (bucket_t - 1) * hop_length

    audio = np.zeros((b, bucket_s + 2 * pad), np.float32)
    audio_lengths = np.zeros((b,), np.int32)
    targets = np.full((b, bucket_l), PAD_ID, np.int32)
    src_pct = np.zeros((b,), np.float32)

    for i, (w, t) in enumerate(zip(waves, transcripts)):
        w = w[:bucket_s]
        n = len(w)
        if n > 1:
            padded = np.pad(w, (pad, pad), mode="reflect")
        else:  # degenerate 0/1-sample utterance
            padded = np.zeros(n + 2 * pad, np.float32)
            padded[pad:pad + n] = w
        audio[i, :len(padded)] = padded
        audio_lengths[i] = n
        tt = t[:bucket_l]
        targets[i, :len(tt)] = tt
        src_pct[i] = (1 + n // hop_length) / bucket_t

    return {
        "audio": audio,
        "audio_lengths": audio_lengths,
        "targets": targets,
        "src_percentages": src_pct,
    }


class SpectrogramDataset:
    """Multi-manifest dataset over raw waveforms (device STFT downstream).
    Index i of an evaluation set reads row i of the first manifest
    (cyclically); a training set reads manifest i % M, row i // M."""

    def __init__(self, vocab: Vocab, cfg: Config,
                 manifest_filepath_list: Sequence[str],
                 normalize: bool = True, augment: bool = False,
                 is_train: bool = False,
                 partitions: Optional[Sequence[float]] = None,
                 seed: int = 0):
        self.vocab = vocab
        self.cfg = cfg
        self.normalize = normalize
        self.augment = augment
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        self.ids_list = [read_manifest(p) for p in manifest_filepath_list]
        self.max_size = (max(len(ids) for ids in self.ids_list)
                         * len(self.ids_list))
        if is_train and len(self.ids_list) > 1:
            self.max_size = 30000  # reference multi-manifest cap (:198-202)
        if partitions is not None:
            self.proba = []
            for ids, part in zip(self.ids_list, partitions):
                p = np.zeros(len(ids))
                part_len = max(1, int(len(ids) * part))
                p[:part_len] = 1.0 / part_len
                self.proba.append(p)
            self.part_len = max(1, int(len(self.ids_list[0]) * partitions[0]))
        else:
            self.proba = [np.full(len(ids), 1.0 / len(ids))
                          for ids in self.ids_list]
            self.part_len = self.max_size
        self.noise_injector = None
        if cfg.audio.noise_dir:
            self.noise_injector = NoiseInjector(
                cfg.audio.noise_dir, cfg.audio.sample_rate,
                (cfg.audio.noise_min, cfg.audio.noise_max))
        # bounded decoded-waveform cache: k-shot sampling revisits
        # utterances constantly, and decoding would otherwise pace the step;
        # off when augmenting (the waves are drawn anew each time)
        self._wave_cache: Dict[str, np.ndarray] = {}
        self._wave_cache_cap = int(cfg.data.wave_cache_size)
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return self.part_len

    def _load_wave(self, audio_path: str,
                   rng: Optional[np.random.RandomState] = None
                   ) -> np.ndarray:
        """The waveform, with tempo and gain and then noise drawn from
        ``rng`` (default: the dataset's) when the set randomizes."""
        rng = self.rng if rng is None else rng
        randomized = self.augment or self.noise_injector is not None
        if not randomized:
            cached = self._wave_cache.get(audio_path)
            if cached is not None:
                return cached
        y = load_audio(audio_path, self.cfg.audio.sample_rate)
        if self.augment:
            y = augment_audio(y, rng)
        if self.noise_injector is not None:
            if rng.binomial(1, self.cfg.audio.noise_prob):
                y = self.noise_injector.inject(y, rng)
        if not randomized and self._wave_cache_cap > 0:
            with self._cache_lock:  # prefetch workers share the cache
                if len(self._wave_cache) >= self._wave_cache_cap:
                    self._wave_cache.pop(next(iter(self._wave_cache)))
                self._wave_cache[audio_path] = y
        return y

    def get_utterance(self, manifest_id: int, sample_id: int,
                      rng: Optional[np.random.RandomState] = None
                      ) -> Tuple[np.ndarray, List[int]]:
        ids = self.ids_list[manifest_id]
        audio_path, transcript_path = ids[sample_id % len(ids)]
        return (
            self._load_wave(audio_path, rng),
            parse_transcript(transcript_path, self.vocab,
                             self.cfg.data.input_type),
        )

    def __getitem__(self, index: int) -> Tuple[np.ndarray, List[int]]:
        if self.is_train:
            n = len(self.ids_list)
            return self.get_utterance(index % n, index // n)
        return self.get_utterance(0, index)

    def _collate(self, pairs, force_frames=None, force_tgt=None):
        return collate_audio(
            [p[0] for p in pairs], [p[1] for p in pairs],
            self.cfg.audio.hop_length,
            self.cfg.data.src_bucket_frames, self.cfg.data.tgt_bucket_len,
            self.cfg.model.src_max_len, n_fft=self.cfg.audio.n_fft,
            force_frames=force_frames, force_tgt=force_tgt,
        )

    def sample_pairs(self, k: int, manifest_id: int,
                     rng: Optional[np.random.RandomState] = None):
        """Draw k (wave, transcript) pairs of one manifest with its
        probabilities, from ``rng`` (default: the dataset's RandomState),
        which also draws their augmentation."""
        rng = self.rng if rng is None else rng
        ids = self.ids_list[manifest_id]
        chosen = rng.choice(np.arange(len(ids)), k,
                            p=self.proba[manifest_id], replace=True)
        return [self.get_utterance(manifest_id, int(i), rng) for i in chosen]

    def sample_meta_batch(self, k_train: int, k_valid: int,
                          query_manifest_id: int = -1,
                          per_task_query: bool = False,
                          rng: Optional[np.random.RandomState] = None):
        """One meta iteration's data (mtl_tpu/data/dataset.py:276-322):
        support batches of k_train draws from every manifest, stacked
        [K, B, ...], and the query: k_valid draws from the last manifest
        (the code-switched target, transient_trainer.py:168), or with
        ``per_task_query`` (MAML, meta_trainer.py:244) k_valid draws from
        every manifest, stacked [K, B, ...], drawn after all the support
        draws. All share one (frames, target) bucket so that the tasks
        stack. ``rng`` replaces the dataset's RandomState for every draw."""
        num_tasks = len(self.ids_list)
        support_pairs = [self.sample_pairs(k_train, m, rng)
                         for m in range(num_tasks)]
        if per_task_query:
            query_pairs = [self.sample_pairs(k_valid, m, rng)
                           for m in range(num_tasks)]
        else:
            query_pairs = [self.sample_pairs(
                k_valid, query_manifest_id % num_tasks, rng)]
        hop = self.cfg.audio.hop_length
        all_pairs = [p for task in support_pairs + query_pairs for p in task]
        max_samples = (self.cfg.model.src_max_len - 1) * hop
        max_frames = max(1 + min(len(w), max_samples) // hop
                         for w, _ in all_pairs)
        max_tgt = max(max(1, len(t)) for _, t in all_pairs)
        bucket_t = pick_bucket(max_frames, self.cfg.data.src_bucket_frames)
        bucket_l = pick_bucket(max_tgt, self.cfg.data.tgt_bucket_len)

        def stack(groups):
            batches = [self._collate(p, bucket_t, bucket_l) for p in groups]
            return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

        query = stack(query_pairs)
        if not per_task_query:
            query = {k: v[0] for k, v in query.items()}
        return stack(support_pairs), query

    def iter_batches(
        self, batch_size: int, shuffle: bool = True,
        force_frames: Optional[int] = None, force_tgt: Optional[int] = None,
        drop_last: bool = False, with_valid_count: bool = False,
    ):
        """Epoch iterator of static-shape batches.

        The final ragged batch is padded to ``batch_size`` by repeating
        leading utterances so shapes stay static; with ``with_valid_count``
        each yield is ``(batch, num_valid)`` so metric consumers can trim
        the duplicated rows. ``shuffle`` draws the order from the
        dataset's RandomState, so that each epoch sees a new order
        (mtl_tpu/data/dataset.py:339-341)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            num_valid = len(idx)
            if num_valid < batch_size:
                if drop_last or num_valid == 0:
                    return
                # np.resize tiles cyclically, covering n < batch_size too
                idx = np.concatenate(
                    [idx, np.resize(order, batch_size - num_valid)]
                )
            batch = self._collate([self[int(i)] for i in idx], force_frames,
                                  force_tgt)
            yield (batch, num_valid) if with_valid_count else batch
