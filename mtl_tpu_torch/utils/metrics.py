"""Host-side evaluation metrics: CER / WER / per-language (EN/ZH) CER.

Parity: utils/metrics.py:7-66 —
* ``calculate_cer``: raw Levenshtein distance (normalization by char count
  happens in the trainers);
* ``calculate_wer``: map words to single chars, then Levenshtein;
* ``calculate_cer_en_zh``: split hyp/gold into EN vs ZH segments
  (utils/data.py:84-127 segmentation) and score separately.

A copy of mtl_tpu/utils/metrics.py for the PyTorch port.
"""

from __future__ import annotations

import unicodedata
from typing import List, Sequence, Tuple

from .edit_distance import distance, distance_batch


def is_chinese_char(cc: str) -> bool:
    """utils/data.py:61-69 parity (unicode category 'Lo')."""
    return unicodedata.category(cc) == "Lo"


def is_contain_chinese_word(seq: str) -> bool:
    return any(is_chinese_char(c) for c in seq)


def get_word_segments_per_language(seq: str) -> List[str]:
    """Group consecutive same-language words (utils/data.py:84-127)."""
    cur_lang = -1  # 0 = english, 1 = chinese
    words = seq.split(" ")
    temp_words = ""
    word_segments: List[str] = []
    for word in words:
        lang = 1 if is_contain_chinese_word(word) else 0
        if cur_lang == -1:
            cur_lang = lang
            temp_words = word
        elif cur_lang != lang:
            cur_lang = lang
            word_segments.append(temp_words)
            temp_words = word
        else:
            if temp_words != "":
                temp_words += " "
            temp_words += word
    word_segments.append(temp_words)
    return word_segments


def calculate_cer(s1: str, s2: str) -> int:
    """Edit distance between hyp s1 and gold s2 (raw, unnormalized)."""
    return distance(s1, s2)


def calculate_cer_batch(pairs: Sequence[Tuple[str, str]]) -> List[int]:
    """Edit distances of (hyp, gold) string pairs (one native call)."""
    return distance_batch(pairs)


def calculate_wer(s1: str, s2: str) -> int:
    """Word-level edit distance via word->char mapping."""
    b = set(s1.split() + s2.split())
    word2char = dict(zip(b, range(len(b))))
    w1 = "".join(chr(word2char[w]) for w in s1.split())
    w2 = "".join(chr(word2char[w]) for w in s2.split())
    return distance(w1, w2)


def calculate_cer_en_zh(s1: str, s2: str) -> Tuple[int, int, int, int]:
    """Per-language CER pieces: (en_dist, zh_dist, en_gold_len, zh_gold_len)."""
    en_s1 = zh_s1 = en_s2 = zh_s2 = ""
    for segment in get_word_segments_per_language(s1):
        if is_contain_chinese_word(segment):
            zh_s1 += segment
        else:
            en_s1 += segment
    for segment in get_word_segments_per_language(s2):
        if is_contain_chinese_word(segment):
            zh_s2 += segment
        else:
            en_s2 += segment
    return (
        calculate_cer(en_s1, en_s2),
        calculate_cer(zh_s1, zh_s2),
        len(en_s2),
        len(zh_s2),
    )
