"""Synthetic corpus generators for tests and chip runs (copies of
make_synthetic_corpus and make_synthetic_lm_corpus from
mtl_tpu/data/synthetic.py).

Stands in for the LDC corpora (CommonVoice / HKUST / SEAME) the reference
trains on: sine-mixture wavs + short transcripts, one manifest per
pseudo-language, the last task a "code-switched" mix of the other alphabets.
The same seed gives the same files as the JAX package's generator.
"""

from __future__ import annotations

import json
import os
import wave
from typing import List, Sequence, Tuple

import numpy as np

EN_CHARS = list("abcdefghijklmnopqrstuvwxyz ")
ZH_CHARS = [chr(0x4E00 + i) for i in range(40)]  # CJK ideographs


def write_wav(path: str, y: np.ndarray, sample_rate: int = 16000) -> None:
    pcm = np.clip(y * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def _random_utterance(
    rng: np.random.RandomState, chars: Sequence[str], sample_rate: int,
    min_sec: float, max_sec: float, min_chars: int, max_chars: int,
) -> Tuple[np.ndarray, str]:
    dur = rng.uniform(min_sec, max_sec)
    n = int(dur * sample_rate)
    t = np.arange(n) / sample_rate
    y = np.zeros(n, np.float32)
    for _ in range(rng.randint(1, 4)):
        f0 = rng.uniform(100, 2000)
        y += rng.uniform(0.1, 0.4) * np.sin(
            2 * np.pi * f0 * t + rng.uniform(0, np.pi)
        ).astype(np.float32)
    y += 0.01 * rng.randn(n).astype(np.float32)
    length = rng.randint(min_chars, max_chars + 1)
    text = "".join(rng.choice(list(chars)) for _ in range(length))
    return y, text


def make_synthetic_corpus(
    root: str,
    num_tasks: int = 3,
    utts_per_task: int = 12,
    sample_rate: int = 16000,
    min_sec: float = 0.3,
    max_sec: float = 1.2,
    min_chars: int = 3,
    max_chars: int = 12,
    seed: int = 0,
) -> Tuple[List[str], str]:
    """Create wavs + transcripts + manifests + labels JSON under ``root``.

    Task 0: EN-like, task 1: ZH-like, last task: code-switched mix.
    Returns (manifest_paths, labels_json_path).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    alphabet_for_task = []
    for k in range(num_tasks):
        if k == num_tasks - 1 and num_tasks > 1:
            alphabet_for_task.append(EN_CHARS + ZH_CHARS)  # code-switched
        elif k % 2 == 0:
            alphabet_for_task.append(EN_CHARS)
        else:
            alphabet_for_task.append(ZH_CHARS + [" "])

    manifests = []
    for k in range(num_tasks):
        task_dir = os.path.join(root, f"task{k}")
        os.makedirs(task_dir, exist_ok=True)
        rows = []
        for i in range(utts_per_task):
            y, text = _random_utterance(
                rng, alphabet_for_task[k], sample_rate,
                min_sec, max_sec, min_chars, max_chars,
            )
            wav_path = os.path.join(task_dir, f"utt{i}.wav")
            txt_path = os.path.join(task_dir, f"utt{i}.txt")
            write_wav(wav_path, y, sample_rate)
            with open(txt_path, "w", encoding="utf-8") as f:
                f.write(text)
            rows.append(f"{wav_path},{txt_path}")
        manifest = os.path.join(root, f"manifest_task{k}.csv")
        with open(manifest, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        manifests.append(manifest)

    labels = sorted(set(EN_CHARS + ZH_CHARS))
    labels_path = os.path.join(root, "labels.json")
    with open(labels_path, "w", encoding="utf-8") as f:
        json.dump(labels, f, ensure_ascii=False)
    return manifests, labels_path


def make_synthetic_lm_corpus(
    root: str, num_tasks: int = 3, sentences_per_task: int = 40,
    seed: int = 0, markov: bool = False
) -> List[str]:
    """Word-level text corpora for the LM stack (train/valid/test files per
    task, mirroring the lm/ data layout).

    ``markov=True`` draws each sentence from a sparse per-task first-order
    Markov chain (each word allows ~3 successors) instead of i.i.d. word
    choices — i.i.d. text caps learning at unigram statistics, which makes
    perplexity curves too shallow for time-to-target benchmarks
    (bench_matched_ppl.py)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    en_words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "far", "you",
                "go", "now", "later", "really", "okay"]
    zh_words = [chr(0x4E00 + i) for i in range(25)]
    paths = []
    for k in range(num_tasks):
        if k == num_tasks - 1:
            pool = en_words + zh_words
        elif k % 2 == 0:
            pool = en_words
        else:
            pool = zh_words
        successors = None
        if markov:
            successors = {
                w: rng.choice(pool, size=3, replace=False) for w in pool
            }
        task_dir = os.path.join(root, f"lm_task{k}")
        os.makedirs(task_dir, exist_ok=True)
        for split, n in (("train", sentences_per_task),
                         ("valid", max(4, sentences_per_task // 5)),
                         ("test", max(4, sentences_per_task // 5))):
            lines = []
            for _ in range(n):
                length = rng.randint(3, 10)
                if markov:
                    words = [str(rng.choice(pool))]
                    for _ in range(length - 1):
                        words.append(str(rng.choice(successors[words[-1]])))
                else:
                    words = [str(rng.choice(pool)) for _ in range(length)]
                lines.append(" ".join(words))
            with open(os.path.join(task_dir, f"{split}.txt"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
        paths.append(task_dir)
    return paths
