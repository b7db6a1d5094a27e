"""The port's offline text tools and hybrid tokenizer against the JAX
package's: ``data/text.py``, ``lm/corpus_builder.py``,
``train/analyzer.py`` and ``data/tokenizer.py`` give the JAX modules'
results on the same inputs (tests/test_text.py's cases and a few more), a
synthetic wav segmented by a transcript, a SEAME-layout transcript tree
the test writes, a synthetic corpus's length statistics, and two tiny
vocabularies built with ``tokenizers`` and saved with ``save_pretrained``
(only where ``transformers`` is installed; nothing downloads)."""

import os

import numpy as np
import pytest

from mtl_tpu.data import text as jax_text
from mtl_tpu.lm import corpus_builder as jax_corpus
from mtl_tpu_torch.data import text
from mtl_tpu_torch.lm import corpus_builder
from tests.torch_threads import one_torch_thread  # noqa: F401

SENTENCE = "I don't know 你知道吗, it's [noise] 好的 u. s. a. #1 ~ok~ 😀"
MIXED = "we don't know 你好 世界 okay 再见"

# (function, args, kwargs): tests/test_text.py's inputs and a few more
TEXT_CASES = [
    ("remove_emojis", ("hi 😀 there",), {}),
    ("merge_abbreviation", ("u. s. a. today",), {}),
    ("merge_abbreviation", ("plain words here",), {}),
    ("remove_punctuation", ("x dont y",), {}),
    ("remove_punctuation", ("hello, world!",), {}),
    ("remove_punctuation", ("it ' s you're o' clock (x) don'know",), {}),
    ("remove_special_char", ("a【b】c·d ±e",), {}),
    ("remove_space_in_between_words", ("  a    b  ",), {}),
    ("remove_return", ("a\nb\r\tc",), {}),
    ("preprocess_mixed_language_sentence", ("Hello (uh) 你好 WORLD!",), {}),
    ("preprocess_mixed_language_sentence", ("(",), {}),
    ("preprocess_mixed_language_sentence", ("",), {}),
    ("preprocess_mixed_language_sentence", (SENTENCE,), {}),
    ("preprocess_mixed_language_sentence", ("hello 你好世界 friend",),
     {"tokenize": True, "tokenize_lang": 1}),
    ("preprocess_mixed_language_sentence", (SENTENCE,),
     {"tokenize": True, "tokenize_lang": 0}),
    ("en_tokenize_basic", ("don't stop",), {}),
    ("en_tokenize_basic", ("it's john's, right?",), {}),
    ("zh_tokenize_fmm", ("你好 世界",), {}),
    ("zh_tokenize_fmm", ("你好世界",), {"lexicon": {"你好", "世界", "你好世"}}),
    ("zh_tokenize_fmm", ("你好 世界",), {"lexicon": {"你好", "世界", "你好世"}}),
    ("get_word_segments_per_language_with_tokenization", (MIXED,), {}),
    ("get_word_segments_per_language_with_tokenization", (MIXED,),
     {"tokenize_lang": 0}),
    ("get_word_segments_per_language_with_tokenization", (MIXED,),
     {"tokenize_lang": 1}),
]


@pytest.mark.parametrize("fn,args,kwargs", TEXT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(TEXT_CASES)])
def test_text_functions_match_jax(fn, args, kwargs):
    assert getattr(text, fn)(*args, **kwargs) == \
        getattr(jax_text, fn)(*args, **kwargs)


@pytest.mark.parametrize("seq,retokenize", [
    ("Hello, WORLD! (cough) 你好吗", True), ("a", True), ("[noise]", True),
    ("it's 好的", False), (SENTENCE, True), (SENTENCE, False)])
def test_preprocess_lm_sentence_matches_jax(seq, retokenize):
    assert corpus_builder.preprocess_lm_sentence(seq, retokenize) == \
        jax_corpus.preprocess_lm_sentence(seq, retokenize)


def test_segment_wav_corpus_matches_jax(tmp_path):
    from mtl_tpu_torch.data.audio import load_audio
    from mtl_tpu_torch.data.synthetic import write_wav

    sr = 16000
    y = np.sin(np.arange(sr * 2) / sr * 800).astype(np.float32)
    wav = str(tmp_path / "conv.wav")
    write_wav(wav, y, sr)
    tr = tmp_path / "conv.txt"
    tr.write_text("id\t0\t500\tx\thello world\nshort\t1\n"
                  "id\t500\t1500\tx\t你好 there\nid\t1900\t1900\tx\tempty\n",
                  encoding="utf-8")
    got = text.segment_wav_corpus(wav, str(tr), str(tmp_path / "port"), sr)
    want = jax_text.segment_wav_corpus(wav, str(tr), str(tmp_path / "jax"),
                                       sr)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["conv_0.wav", "conv_2.wav"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(load_audio(g), load_audio(w))
        with open(g[:-4] + ".txt", encoding="utf-8") as f1, \
                open(w[:-4] + ".txt", encoding="utf-8") as f2:
            assert f1.read() == f2.read()
    assert abs(len(load_audio(got[0])) - sr // 2) < 10


def _seame_tree(root):
    """An LDC SEAME layout: every (kind, phase) with two files, speakers
    spread so that the splits have something to split."""
    lines = {
        ("interview", "phaseI"): [
            "NI01MAX_0101\t0\t100\thello 世界 one\n",
            "NI05MAX_0102\t0\t100\t(ppl) I don't 知道, ok?\n",
            "NI06MAX_0103\t0\t100\ta\n"],
        ("interview", "phaseII"): [
            "NI02FBY_0202\t0\t100\textra\tsecond phase 语 句\n",
            "NI07FBY_0203\t0\t100\textra\t[noise] 好的 it's fine\n"],
        ("conversation", "phaseI"): [
            "02NC03MAX_0303\t0\t100\tconversation 内容 here\n",
            "02NC08MAX_0304\t0\t100\tyes 对 lah\n"],
        ("conversation", "phaseII"): [
            "04NC04FBY_0404\t0\t100\textra\tmore 话 data\n",
            "04NC09FBY_0405\t0\t100\textra\tshort\n"],
    }
    for (kind, phase), rows in lines.items():
        d = root / kind / "transcript" / phase / "sub"
        d.mkdir(parents=True)
        (d / "a.txt").write_text("".join(rows[:1]), encoding="utf-8")
        (d / "b.txt").write_text("".join(rows[1:]), encoding="utf-8")


def test_corpus_builder_matches_jax(tmp_path):
    root = tmp_path / "seame"
    _seame_tree(root / "data")
    want = jax_corpus.read_seame_transcripts(str(root / "data"))
    got = corpus_builder.read_seame_transcripts(str(root / "data"))
    assert got == want and len(got) >= 8
    paths = corpus_builder.build_seame_lm_corpus(str(root),
                                                 str(tmp_path / "port"),
                                                 seed=3)
    jpaths = jax_corpus.build_seame_lm_corpus(str(root),
                                              str(tmp_path / "jax"), seed=3)
    assert set(paths) == set(jpaths) == {"train", "valid", "test", "vocab"}
    for split in paths:
        with open(paths[split], encoding="utf-8") as f1, \
                open(jpaths[split], encoding="utf-8") as f2:
            assert f1.read() == f2.read(), split
    with open(paths["test"], encoding="utf-8") as f:
        assert f.read()  # a speaker held out


def test_analyzer_matches_jax(tmp_path):
    from mtl_tpu.config import Config as JaxConfig
    from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
    from mtl_tpu.data.synthetic import make_synthetic_corpus
    from mtl_tpu.data.vocab import Vocab as JaxVocab
    from mtl_tpu.train.analyzer import Analyzer as JaxAnalyzer
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.train.analyzer import Analyzer

    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "c"), num_tasks=2, utts_per_task=4, max_sec=0.4,
        seed=2)
    jcfg, cfg = JaxConfig(), Config()
    jcfg.data.labels_path = cfg.data.labels_path = labels
    want = JaxAnalyzer().analyze(
        [JaxDataset(JaxVocab.from_json(labels), jcfg, manifests)],
        out_dir=str(tmp_path / "jax"))
    got = Analyzer().analyze(
        [SpectrogramDataset(Vocab.from_json(labels), cfg, manifests)],
        out_dir=str(tmp_path / "port"))
    assert got == want and got["dataset_0"]["count"] == 8
    with open(tmp_path / "port" / "lengths_0.csv") as f1, \
            open(tmp_path / "jax" / "lengths_0.csv") as f2:
        assert f1.read() == f2.read()


# -- the hybrid tokenizer ----------------------------------------------------

@pytest.fixture(scope="module")
def vocab_dirs(tmp_path_factory):
    """A byte-level BPE ("GPT2") trained on a few English words and a
    WordPiece ("BERT-zh") over a few characters, each saved with
    ``save_pretrained`` into a directory of its own."""
    pytest.importorskip("transformers")
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)
    from transformers import PreTrainedTokenizerFast

    root = tmp_path_factory.mktemp("vocabs")
    en = Tokenizer(models.BPE())
    en.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    en.decoder = decoders.ByteLevel()
    en.train_from_iterator(
        ["hello world okay friend we do not know hi ok"] * 20,
        trainers.BpeTrainer(
            vocab_size=300, special_tokens=["<|endoftext|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=en,
                            eos_token="<|endoftext|>").save_pretrained(
        str(root / "en"))
    chars = "你好世界再见知道吗"
    vocab = {"[PAD]": 0, "[UNK]": 1, **{c: i + 2 for i, c in
                                        enumerate(chars)}}
    zh = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    zh.normalizer = normalizers.BertNormalizer(  # a CJK char is a word
        handle_chinese_chars=True, lowercase=False)
    zh.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    zh.decoder = decoders.WordPiece()
    PreTrainedTokenizerFast(tokenizer_object=zh, unk_token="[UNK]",
                            pad_token="[PAD]").save_pretrained(
        str(root / "zh"))
    return str(root / "en"), str(root / "zh")


@pytest.mark.parametrize("sentence", [
    "hi 你好 ok", MIXED, "hello world", "再见", "okay 知道吗 friend 世界"])
def test_tokenizer_matches_jax(vocab_dirs, monkeypatch, sentence):
    from mtl_tpu.data.tokenizer import ChineseEnglishTokenizer as JaxTok
    from mtl_tpu_torch.data.tokenizer import ChineseEnglishTokenizer

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    en, zh = vocab_dirs
    tok, jtok = ChineseEnglishTokenizer(en, zh), JaxTok(en, zh)
    assert len(tok) == len(jtok) == tok.en_vocab_size + tok.zh_vocab_size
    ids = tok.encode(sentence)
    assert ids == jtok.encode(sentence) and ids
    if any("一" <= c <= "鿿" for c in sentence):
        assert max(ids) >= tok.en_vocab_size  # ZH ids past the offset
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids).replace(" ", "") == sentence.replace(" ", "")


def test_tokenizer_without_vocabularies_raises(tmp_path, monkeypatch):
    """Nothing cached (a directory that holds none): the documented
    ``RuntimeError``, no download."""
    pytest.importorskip("transformers")
    from mtl_tpu_torch.data.tokenizer import ChineseEnglishTokenizer

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="no network egress"):
        ChineseEnglishTokenizer(str(tmp_path / "none"), str(tmp_path / "no"))
