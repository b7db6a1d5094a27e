"""Raw SEAME transcript -> LM corpus builders (a copy of
mtl_tpu/lm/corpus_builder.py for the PyTorch port).

A re-expression of the reference's LM-side corpus construction
(lm/util/datahelper.py:16-372 + lm/util/texthelper.py:64-145): walk the LDC
SEAME transcript tree (interview/conversation x phaseI/phaseII), parse the
tab-separated transcript lines, clean each mixed EN/ZH sentence with the
texthelper pipeline, bucket utterances per speaker, and write the
train/valid/test text files the LM stack's ``Corpus`` consumes
(mtl_tpu_torch/lm/data.py) — replacing the reference's numpy-pickle side
channel (datahelper.py:358-372) with plain text splits.

Differences from the reference, by design:

* StanfordCoreNLP retokenization (texthelper.py:137) is replaced by the
  offline EN-word / ZH-char segmentation used everywhere else in this
  package (the reference needs a running CoreNLP server; phase-II data —
  ``retokenize=False`` — never tokenized in the reference either).
* ``save_seame``'s ``numpy.save`` of python dicts becomes deterministic
  per-speaker text splits (LM training needs text files, not pickles).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence, Tuple

from ..utils.metrics import is_chinese_char

# texthelper.py:77-96 — ZH/EN punctuation stripped to spaces, apostrophes
# split off their word; note this table differs slightly from the ASR-side
# utils/data.py cleanup (no typo fixes, brackets removed wholesale).
_PUNCT_RE = re.compile(
    "[\\s+\\\\!\\/_,$%=^*?:@&^~`(+\"]+|"
    "[+！，。？、~@#￥%……&*（）:;：；《）《》“”()»〔〕]+"
)
_SPECIAL_RE = re.compile("[·．％°℃×→①ぃγ￣σς＝～•＋δ≤∶／⊥＿ñãíå∈△β［］±]+")
_BRACKET_RE = re.compile(r"[\(\[].*?[\)\]]")  # hesitation markers
_EMOJI_RE = re.compile(
    "["
    "\U0001F600-\U0001F64F"
    "\U0001F300-\U0001F5FF"
    "\U0001F680-\U0001F6FF"
    "\U0001F1E0-\U0001F1FF"
    "]+",
    flags=re.UNICODE,
)


def _squeeze_spaces(seq: str) -> str:
    return re.sub(" {2,}", " ", seq).strip()


def _segment_offline(seq: str) -> str:
    """Offline stand-in for CoreNLP word_tokenize: EN words stay words,
    each ZH character becomes its own token (the convention the LM stack's
    Dictionary/ppl breakdown already uses)."""
    out: List[str] = []
    for word in seq.split(" "):
        if not word:
            continue
        if any(is_chinese_char(ch) for ch in word):
            buf = ""
            for ch in word:
                if is_chinese_char(ch):
                    if buf:
                        out.append(buf)
                        buf = ""
                    out.append(ch)
                else:
                    buf += ch
            if buf:
                out.append(buf)
        else:
            out.append(word)
    return " ".join(out)


def preprocess_lm_sentence(seq: str, retokenize: bool = True) -> str:
    """texthelper.preprocess_mixed_language_sentence (lm/util/texthelper.py
    :108-145): lowercase, strip hesitation brackets / special chars /
    punctuation, then (re)tokenize. Returns "" for sequences that clean away
    to <= 1 char (the reference's filter)."""
    seq = seq.lower()
    seq = seq.replace("　", " ")
    seq = seq.replace("[", " [").replace("]", "] ")
    for ch in ("#", ",", "\n", "\r", "\t", "~", "*"):
        seq = seq.replace(ch, "")
    seq = _BRACKET_RE.sub("", seq)
    seq = _EMOJI_RE.sub("", seq)
    seq = _SPECIAL_RE.sub(" ", seq)
    seq = _squeeze_spaces(seq)
    seq = _PUNCT_RE.sub(" ", seq)
    for apo in ("'", "’", "＇"):
        seq = seq.replace(apo, " " + apo)
    for ch in ".?:;][}{|_()=":
        seq = seq.replace(ch, " ")
    seq = _squeeze_spaces(seq)
    if len(seq) <= 1:
        return ""
    if retokenize:
        seq = _segment_offline(seq)
    return seq


# transcript-line parsing: datahelper.py — the utterance text sits at
# tab-column 3 (phase I) or 4 (phase II); the speaker id is a 4-char slice
# of the leading utterance id (interview: chars 0:4, conversation: 2:6).
_LAYOUTS = {
    ("interview", "phaseI"): (3, slice(0, 4), True),
    ("interview", "phaseII"): (4, slice(0, 4), False),
    ("conversation", "phaseI"): (3, slice(2, 6), True),
    ("conversation", "phaseII"): (4, slice(2, 6), False),
}


def parse_transcript_file(path: str, kind: str, phase: str,
                          speakers: Dict[str, List[str]]) -> Tuple[int, int]:
    """Parse one SEAME transcript file into ``speakers``; returns
    (total_lines, kept_lines)."""
    col, spk_slice, retokenize = _LAYOUTS[(kind, phase)]
    total = kept = 0
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            arr = line.split("\t")
            if len(arr) <= col:
                continue
            total += 1
            seq = preprocess_lm_sentence(arr[col], retokenize=retokenize)
            if not seq:
                continue
            kept += 1
            speaker = line.split("_")[0][spk_slice]
            speakers.setdefault(speaker, []).append(seq)
    return total, kept


def read_seame_transcripts(
    root: str,
    kinds: Sequence[str] = ("interview", "conversation"),
    phases: Sequence[str] = ("phaseI", "phaseII"),
) -> Dict[str, List[str]]:
    """Walk ``root``/<kind>/transcript/<phase>/ recursively (the LDC SEAME
    layout, datahelper.py:147-151) and return speaker -> cleaned
    sentences."""
    speakers: Dict[str, List[str]] = {}
    for kind in kinds:
        for phase in phases:
            base = os.path.join(root, kind, "transcript", phase)
            if not os.path.isdir(base):
                continue
            for dirpath, _, files in os.walk(base):
                for name in sorted(files):
                    if name.endswith(".txt"):
                        parse_transcript_file(
                            os.path.join(dirpath, name), kind, phase,
                            speakers)
    return speakers


def build_lm_corpus(
    speakers: Dict[str, List[str]],
    out_dir: str,
    valid_fraction: float = 0.1,
    test_fraction: float = 0.1,
    seed: int = 0,
) -> Dict[str, str]:
    """Write train/valid/test text files (one sentence per line) with
    speaker-disjoint splits — utterances of one speaker never straddle a
    split (the property the reference's per-speaker buckets exist for).
    Returns {"train": path, "valid": path, "test": path, "vocab": path}."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = sorted(speakers)
    rng.shuffle(ids)
    n = len(ids)
    n_test = max(1, int(n * test_fraction)) if n > 2 else 0
    n_valid = max(1, int(n * valid_fraction)) if n > 2 else 0
    splits = {
        "test": ids[:n_test],
        "valid": ids[n_test:n_test + n_valid],
        "train": ids[n_test + n_valid:],
    }
    paths = {}
    vocab = {}
    for split, spk_ids in splits.items():
        path = os.path.join(out_dir, f"{split}.txt")
        with open(path, "w", encoding="utf-8") as fh:
            for spk in spk_ids:
                for seq in speakers[spk]:
                    fh.write(seq + "\n")
                    if split == "train":
                        for w in seq.split(" "):
                            vocab[w] = True
        paths[split] = path
    vpath = os.path.join(out_dir, "vocab.txt")
    with open(vpath, "w", encoding="utf-8") as fh:
        for w in sorted(vocab):
            fh.write(w + "\n")
    paths["vocab"] = vpath
    return paths


def build_seame_lm_corpus(seame_root: str, out_dir: str,
                          **kwargs) -> Dict[str, str]:
    """End-to-end: LDC SEAME tree -> LM text corpus (the path the reference
    scattered across read_seame + save_seame + manual pickling)."""
    speakers = read_seame_transcripts(os.path.join(seame_root, "data")
                                      if os.path.isdir(
                                          os.path.join(seame_root, "data"))
                                      else seame_root)
    return build_lm_corpus(speakers, out_dir, **kwargs)
