"""Offline text preprocessing for code-switched corpora (a copy of
mtl_tpu/data/text.py for the PyTorch port, on the port's own
``utils/metrics.py``, ``data/audio.py:load_audio`` and
``data/synthetic.py:write_wav``).

Parity: utils/data.py:199-404 — emoji removal, abbreviation merging,
punctuation / special-character removal with the reference's typo fixes,
and ``preprocess_mixed_language_sentence`` (bracket/hesitation stripping,
per-language segment cleanup, non-ASCII removal from EN segments). The
StanfordCoreNLP-tokenizing variant (utils/data.py:129-197) is implemented as
``get_word_segments_per_language_with_tokenization`` — the reference's
language-run state machine exactly, with the CoreNLP ``word_tokenize``
calls replaced by injectable callables defaulting to self-contained offline
tokenizers (PTB-style English splitting, forward-maximum-matching Chinese
segmentation).

SEAME wav segmentation (utils/data.py:412-439, a sox subprocess pipeline) is
re-expressed in segment_wav_corpus() with numpy slicing instead of sox.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from ..utils.metrics import (
    get_word_segments_per_language,
    is_chinese_char,
    is_contain_chinese_word,
)

_EMOJI_RE = re.compile(
    "["
    "\U0001F600-\U0001F64F"
    "\U0001F300-\U0001F5FF"
    "\U0001F680-\U0001F6FF"
    "\U0001F1E0-\U0001F1FF"
    "]+",
    flags=re.UNICODE,
)

_PUNCT_RE = re.compile(
    "[\\s+\\\\!\\/_,$%=^*?:@&^~`(+\"]+"
    "|[+！，。？、~@#￥%……&*（）:;：；《）《》“”()»〔〕]+"
)

_SPECIAL_RE = re.compile("[【】·．％°℃×→①ぃγ￣σς＝～•＋δ≤∶／⊥＿ñãíå∈△β［］±]+")


def remove_emojis(seq: str) -> str:
    return _EMOJI_RE.sub("", seq).strip()


def merge_abbreviation(seq: str) -> str:
    """Join consecutive dot-terminated tokens ("u. s. a." -> "u.s.a.")."""
    seq = seq.replace("  ", " ")
    words = seq.split(" ")
    final_seq, temp = "", ""
    for word in words:
        if len(word) == 0:
            continue
        if word[-1] == ".":
            temp += word
        else:
            if temp != "":
                final_seq += (" " if final_seq else "") + temp
                temp = ""
            final_seq += (" " if final_seq else "") + word
    if temp != "":
        final_seq += (" " if final_seq else "") + temp
    return final_seq


def remove_space_in_between_words(seq: str) -> str:
    for _ in range(4):
        seq = seq.replace("  ", " ")
    return seq.strip().lstrip()


def remove_return(seq: str) -> str:
    return seq.replace("\n", "").replace("\r", "").replace("\t", "")


def remove_special_char(seq: str) -> str:
    return _SPECIAL_RE.sub(" ", seq)


def remove_punctuation(seq: str) -> str:
    """Punctuation removal + the reference's typo/encoding fixes
    (utils/data.py:243-309)."""
    seq = _PUNCT_RE.sub(" ", seq)
    for a, b in (
        (" ' ", " "), (" ’ ", " "), (" ＇ ", " "), (" ` ", " "),
        (" '", "'"), (" ’", "’"), (" ＇", "＇"),
        ("' ", " "), ("’ ", " "), ("＇ ", " "), ("` ", " "),
        (".", ""), ("`", ""), ("-", " "), ("?", " "), (":", " "),
        (";", " "), ("]", " "), ("[", " "), ("}", " "), ("{", " "),
        ("|", " "), ("_", " "), ("(", " "), (")", " "), ("=", " "),
        (" dont ", " don't "), ("welcome外星人", "welcome 外星人"),
        ("doens't", "doesn't"), ("o' clock", "o'clock"),
        ("因为it's", "因为 it's"), ("it' s", "it's"), ("it ' s", "it's"),
        ("y'", "y"), ("y ' ", "y"), ("看different", "看 different"),
        ("it'self", "itself"), ("it'ss", "it's"), ("don'r", "don't"),
        ("has't", "hasn't"), ("don'know", "don't know"),
        ("i'll", "i will"), ("you're", "you are"),
        ("'re ", " are "), ("'ll ", " will "), ("'ve ", " have "),
        ("'re\n", " are\n"), ("'ll\n", " will\n"), ("'ve\n", " have\n"),
    ):
        seq = seq.replace(a, b)
    return remove_space_in_between_words(seq)


def en_tokenize_basic(text: str) -> List[str]:
    """Offline stand-in for CoreNLP's English ``word_tokenize``: PTB-style
    splitting — punctuation separated, "n't" and clitic contractions
    ('s 're 'll 've 'd 'm) split off. Injectable wherever the reference
    passes ``en_nlp`` (utils/data.py:152-155)."""
    text = re.sub(r"([^\w\s'])", r" \1 ", text)
    text = re.sub(r"(?i)(\w)(n't)\b", r"\1 \2", text)
    text = re.sub(r"(?i)('(?:s|re|ll|ve|d|m))\b", r" \1", text)
    return text.split()


def zh_tokenize_fmm(
    text: str, lexicon=None, max_word_len: int = 4
) -> List[str]:
    """Offline stand-in for CoreNLP's Chinese segmenter: forward maximum
    matching against an optional word ``lexicon`` (a set of multi-char
    words); without one, per-character segmentation — which is also what
    the downstream character-level ASR/LM vocab consumes. Injectable
    wherever the reference passes ``zh_nlp`` (utils/data.py:170-173)."""
    if not lexicon:
        return [c for c in text if not c.isspace()]
    out: List[str] = []
    i = 0
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        for length in range(min(max_word_len, len(text) - i), 1, -1):
            if text[i:i + length] in lexicon:
                out.append(text[i:i + length])
                i += length
                break
        else:
            out.append(text[i])
            i += 1
    return out


def get_word_segments_per_language_with_tokenization(
    seq: str,
    tokenize_lang: int = -1,
    en_tokenize=None,
    zh_tokenize=None,
) -> List[str]:
    """utils/data.py:129-197 parity: split ``seq`` into same-language word
    runs, tokenizing the runs of the selected language (-1 none, 0 English,
    1 Chinese). The run state machine is the reference's exactly, including
    its quirks: a mid-sequence Chinese run is tokenized with spaces removed
    first, the FINAL Chinese run is tokenized as-is (reference line 185 vs
    172), and the final run is tokenized only when its language matches
    ``cur_lang``. ``en_tokenize``/``zh_tokenize`` replace the CoreNLP
    ``word_tokenize`` bound methods; they default to the offline
    tokenizers above."""
    en_tokenize = en_tokenize or en_tokenize_basic
    zh_tokenize = zh_tokenize or zh_tokenize_fmm
    cur_lang = -1
    words = seq.split(" ")
    temp_words = ""
    word_segments: List[str] = []

    for word in words:
        if is_contain_chinese_word(word):
            if cur_lang == -1:
                cur_lang = 1
                temp_words = word
            elif cur_lang == 0:  # flush an English run
                cur_lang = 1
                if tokenize_lang == 0:
                    temp_words = " ".join(en_tokenize(temp_words))
                word_segments.append(temp_words)
                temp_words = word
            else:
                if temp_words != "":
                    temp_words += " "
                temp_words += word
        else:
            if cur_lang == -1:
                cur_lang = 0
                temp_words = word
            elif cur_lang == 1:  # flush a Chinese run
                cur_lang = 0
                if tokenize_lang == 1:
                    temp_words = " ".join(
                        zh_tokenize(temp_words.replace(" ", "")))
                word_segments.append(temp_words)
                temp_words = word
            else:
                if temp_words != "":
                    temp_words += " "
                temp_words += word

    if tokenize_lang == 0 and cur_lang == 0:
        temp_words = " ".join(en_tokenize(temp_words))
    elif tokenize_lang == 1 and cur_lang == 1:
        temp_words = " ".join(zh_tokenize(temp_words))
    word_segments.append(temp_words)
    return word_segments


def preprocess_mixed_language_sentence(
    seq: str,
    tokenize: bool = False,
    tokenizer=None,
    tokenize_lang: int = -1,
    en_tokenize=None,
    zh_tokenize=None,
) -> str:
    """utils/data.py:342-404 parity; returns "" for sentences that reduce to
    <=1 characters."""
    if len(seq) == 0:
        return ""
    seq = seq.lower()
    seq = merge_abbreviation(seq)
    for a, b in (
        ("\x7f", ""), ("\x80", ""), ("　", " "), ("\xa0", ""),
        ("[", " ["), ("]", "] "), ("#", ""), (",", ""), ("*", ""),
        ("\n", ""), ("\r", ""), ("\t", ""), ("~", ""), ("—", ""),
    ):
        seq = seq.replace(a, b)
    seq = seq.replace("  ", " ").replace("  ", " ")
    seq = re.sub(r"\<.*?\>", "", seq)
    seq = re.sub(r"\【.*?\】", "", seq)
    seq = re.sub(r"[\(\[].*?[\)\]]", "", seq)  # bracketed hesitations
    seq = re.sub(r"[\{\[].*?[\}\]]", "", seq)
    seq = remove_special_char(seq)
    seq = remove_space_in_between_words(seq).strip().lstrip()
    seq = remove_punctuation(seq)

    if tokenize and tokenizer is not None:
        # legacy hook: a whole-sentence callable
        segments = tokenizer(seq)
    elif tokenize:
        segments = get_word_segments_per_language_with_tokenization(
            seq, tokenize_lang=tokenize_lang,
            en_tokenize=en_tokenize, zh_tokenize=zh_tokenize)
    else:
        segments = get_word_segments_per_language(seq)
    temp_words = ""
    for seg in segments:
        if not is_contain_chinese_word(seg):
            seg = re.sub(r"[^\x00-\x7f]", r" ", seg)
        if temp_words != "":
            temp_words += " "
        temp_words += seg.replace("\n", "")
    seq = remove_space_in_between_words(temp_words).strip().lstrip()
    return seq if len(seq) > 1 else ""


def segment_wav_corpus(
    source_wav: str,
    transcript_path: str,
    out_dir: str,
    sample_rate: int = 16000,
) -> List[str]:
    """SEAME-style wav segmentation (utils/data.py:412-439) without sox:
    slice the waveform by the transcript's tab-separated [id, start_ms,
    end_ms, ..., text] rows, writing one wav + txt per utterance."""
    import numpy as np

    from .audio import load_audio
    from .synthetic import write_wav

    os.makedirs(out_dir, exist_ok=True)
    y = load_audio(source_wav, sample_rate)
    written = []
    with open(transcript_path, encoding="utf-8") as f:
        for part_num, line in enumerate(f):
            data = line.replace("\n", "").split("\t")
            if len(data) < 5:
                continue
            start = int(float(data[1]) / 1000 * sample_rate)
            end = int(float(data[2]) / 1000 * sample_rate)
            text = data[4]
            seg = y[start:end]
            if len(seg) == 0:
                continue
            base = os.path.splitext(os.path.basename(source_wav))[0]
            wav_path = os.path.join(out_dir, f"{base}_{part_num}.wav")
            txt_path = os.path.join(out_dir, f"{base}_{part_num}.txt")
            write_wav(wav_path, seg, sample_rate)
            with open(txt_path, "w", encoding="utf-8") as tf:
                tf.write(text + "\n")
            written.append(wav_path)
    return written


def traverse_all(root: str, path: str) -> List[str]:
    p = root + path
    return [p + "/" + sub for sub in sorted(os.listdir(p))]
