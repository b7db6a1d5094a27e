"""Hybrid Chinese-English subword tokenizer (a copy of
mtl_tpu/data/tokenizer.py for the PyTorch port).

Parity: utils/tokenizer.py:22-193 — a GPT2-BPE (English) + BERT-zh
(character) tokenizer with an offset-merged id space: English text segments
are byte-BPE encoded with the GPT2 vocabulary, Chinese segments are
char-tokenized with the BERT-chinese vocabulary, and Chinese ids are offset
by the GPT2 vocab size into one shared id space. Standalone utility — the
training paths use the character Vocab, exactly like the reference.

``transformers`` is imported inside the constructor (the training and
serving paths never import it), and the pretrained vocabularies load with
``local_files_only=True`` from the local cache or a directory; when none
is there, construction raises a ``RuntimeError``. Nothing downloads.
"""

from __future__ import annotations

from typing import List

from ..utils.metrics import (
    get_word_segments_per_language,
    is_contain_chinese_word,
)


class ChineseEnglishTokenizer:
    def __init__(self, en_model: str = "gpt2",
                 zh_model: str = "bert-base-chinese"):
        try:
            from transformers import AutoTokenizer

            self.en_tokenizer = AutoTokenizer.from_pretrained(
                en_model, local_files_only=True
            )
            self.zh_tokenizer = AutoTokenizer.from_pretrained(
                zh_model, local_files_only=True
            )
        except Exception as e:  # no cached vocab in an offline environment
            raise RuntimeError(
                "ChineseEnglishTokenizer needs cached GPT2/BERT-zh "
                "vocabularies (no network egress available): " + str(e)
            ) from e
        self.en_vocab_size = len(self.en_tokenizer)
        self.zh_vocab_size = len(self.zh_tokenizer)

    def __len__(self) -> int:
        return self.en_vocab_size + self.zh_vocab_size

    def encode(self, text: str) -> List[int]:
        """Per-language segment encode; ZH ids offset by the EN vocab size."""
        ids: List[int] = []
        for seg in get_word_segments_per_language(text):
            if is_contain_chinese_word(seg):
                seg_ids = self.zh_tokenizer.encode(seg,
                                                   add_special_tokens=False)
                ids.extend(i + self.en_vocab_size for i in seg_ids)
            else:
                ids.extend(self.en_tokenizer.encode(seg,
                                                    add_special_tokens=False))
        return ids

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        en_buf: List[int] = []
        zh_buf: List[int] = []

        def flush():
            if en_buf:
                out.append(self.en_tokenizer.decode(en_buf))
                en_buf.clear()
            if zh_buf:
                out.append(
                    self.zh_tokenizer.decode(zh_buf).replace(" ", "")
                )
                zh_buf.clear()

        for i in ids:
            if i >= self.en_vocab_size:
                if en_buf:
                    flush()
                zh_buf.append(i - self.en_vocab_size)
            else:
                if zh_buf:
                    flush()
                en_buf.append(i)
        flush()
        return " ".join(s for s in out if s)
