"""The one traffic generator: a corpus of WAVs, transcripts, manifests and
a labels file, made from ``--seed`` and a traffic file's parameters.

Every seed gets the same multiset of utterance sizes in another order: the
durations are the quantiles ``(i + 0.5) / n`` of the traffic's log-normal
(clipped), each paired with a labels-per-second rate (from the task's
script's range) from a fixed permutation of the uniform quantiles, so the
work of a pool does not move with the seed; the seed chooses the order,
the audio and the labels. A mix served in manifest order in batches keeps
fixed batches of the pool in a fixed order, so that every seed serves the
same batches' sizes; the seed orders the rows inside each batch.

Tasks: ``latin`` (words of a-z and apostrophes between spaces), ``cjk``
(runs of CJK labels between spaces) and ``mixed`` (code-switched: runs of
English words and runs of CJK labels). Audio is a mixture of one to three
sines and faint noise, 16-bit PCM at the configuration's rate.
"""

from __future__ import annotations

import json
import os
import wave
from statistics import NormalDist
from typing import Dict, List

import numpy as np

LATIN = " 'abcdefghijklmnopqrstuvwxyz"
CJK_FIRST, CJK_LAST = 0x4E00, 0x9FFF


def make_labels(n_labels: int, seed: int) -> List[str]:
    """The configuration's label set: space, apostrophe, a-z, then CJK
    code points of U+4E00-U+9FFF drawn from ``seed``, in code-point
    order."""
    rng = np.random.RandomState(seed % 2 ** 32)
    n_cjk = n_labels - len(LATIN)
    cjk = rng.choice(CJK_LAST - CJK_FIRST + 1, n_cjk, replace=False)
    return list(LATIN) + [chr(CJK_FIRST + int(c)) for c in np.sort(cjk)]


def pool_sizes(traffic: dict, n: int, script: str):
    """(durations in s, label counts) of a pool of ``n`` utterances of a
    task in ``script``, in a fixed order: the same for every seed. The
    traffic's ``labels_per_s`` gives each script's range."""
    d = traffic["duration_s"]
    q = (np.arange(n) + 0.5) / n
    dist = NormalDist(np.log(d["median"]), d["sigma"])
    dur = np.clip(np.exp([dist.inv_cdf(float(x)) for x in q]),
                  d["min"], d["max"])
    r = traffic["labels_per_s"][script]
    rates = r["min"] + (r["max"] - r["min"]) * q
    rates = rates[np.random.RandomState(0).permutation(n)]
    labels = np.maximum(1, np.round(dur * rates)).astype(int)
    return dur, labels


def _word(rng, traffic, letters: str) -> str:
    lo, hi = traffic["word_letters"]
    return "".join(letters[i] for i in
                   rng.randint(len(letters), size=rng.randint(lo, hi + 1)))


def transcript(rng, script: str, n: int, cjk: np.ndarray,
               traffic: dict) -> str:
    """``n`` labels of ``script``, spaces counted."""
    out: List[str] = []
    latin_run = script == "latin" or (script == "mixed" and rng.rand() < 0.5)
    while len(out) < n:
        if out:
            out.append(" ")
        if latin_run:
            lo, hi = traffic["mixed_runs"]["latin_words"]
            words = [_word(rng, traffic, LATIN[2:] + "'")
                     for _ in range(rng.randint(lo, hi + 1))]
            out.extend(" ".join(words))
        else:
            lo, hi = traffic["mixed_runs"]["cjk_labels"]
            out.extend(cjk[rng.randint(len(cjk), size=rng.randint(lo, hi + 1))])
        if script == "mixed":
            latin_run = not latin_run
    out = out[:n]
    if out[-1] == " ":  # keep the count: a label, not a trailing space
        out[-1] = "a" if latin_run else str(cjk[0])
    return "".join(out)


def audio(rng, seconds: float, sample_rate: int) -> np.ndarray:
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    y = np.zeros(n, np.float32)
    for _ in range(rng.randint(1, 4)):
        y += rng.uniform(0.1, 0.3) * np.sin(
            2 * np.pi * rng.uniform(100, 2000) * t
            + rng.uniform(0, np.pi)).astype(np.float32)
    return y + 0.01 * rng.randn(n).astype(np.float32)


def write_wav(path: str, y: np.ndarray, sample_rate: int) -> None:
    pcm = np.clip(y * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def _order(rng, n: int, batch=None) -> np.ndarray:
    """The manifest's order of the pool: a permutation from ``rng``; for a
    mix served in manifest order in batches, fixed batches in a fixed
    order (every seed serves the same batches' sizes one after another,
    whatever part of a pass a window ends in), the rows of each in an
    order from ``rng``."""
    if not batch:
        return rng.permutation(n)
    groups = np.random.RandomState(1).permutation(n).reshape(-1, batch)
    return np.concatenate([g[rng.permutation(batch)] for g in groups])


def make_corpus(root: str, config: dict, traffic: dict, seed: int) -> Dict:
    """Writes the corpus under ``root``; returns {"labels": path,
    "manifests": [path per task], "utterances": [[(wav, txt, seconds,
    samples, text)] per task]} (the manifests' rows in order)."""
    sr = config["sample_rate"]
    labels = make_labels(config["labels"], seed)
    cjk = np.array(labels[len(LATIN):])
    os.makedirs(root, exist_ok=True)
    labels_path = os.path.join(root, "labels.json")
    with open(labels_path, "w", encoding="utf-8") as f:
        json.dump(labels, f, ensure_ascii=False)
    n = traffic["utterances_per_task"]
    manifests, utterances = [], []
    for k, script in enumerate(traffic["tasks"]):
        dur, counts = pool_sizes(traffic, n, script)
        rng = np.random.RandomState((seed * 7919 + k) % 2 ** 32)
        order = _order(rng, n, traffic.get("batch"))
        task_dir = os.path.join(root, f"task{k}")
        os.makedirs(task_dir, exist_ok=True)
        rows, utts = [], []
        for i, j in enumerate(order):
            y = audio(rng, float(dur[j]), sr)
            text = transcript(rng, script, int(counts[j]), cjk, traffic)
            wav_path = os.path.join(task_dir, f"utt{i}.wav")
            txt_path = os.path.join(task_dir, f"utt{i}.txt")
            write_wav(wav_path, y, sr)
            with open(txt_path, "w", encoding="utf-8") as f:
                f.write(text)
            rows.append(f"{wav_path},{txt_path}")
            utts.append((wav_path, txt_path, len(y) / sr, len(y), text))
        manifest = os.path.join(root, f"manifest_task{k}.csv")
        with open(manifest, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        manifests.append(manifest)
        utterances.append(utts)
    return {"labels": labels_path, "manifests": manifests,
            "utterances": utterances}
