"""The port's word-level LM stack (``mtl_tpu_torch/lm``, ``cli/lm.py``)
against the JAX package's, on the CPU.

One Flax ``RNNLM`` param tree (drawn by ``init``, then moved by seeded
numpy noise of scale 0.1 so that every bias is nonzero) goes into the port
through ``mtl_tpu_torch.interop.lm_params_to_torch``; token streams come from a
synthetic word corpus written by the port's copy of
``make_synthetic_lm_corpus``. Both sides are f32 with dropout 0. Tolerances:
logits 1e-5 absolute (O(1) values, summation order only); losses,
perplexities and LM scores 1e-5 relative; transition counts and words
equal.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.cli import lm as jax_cli
from mtl_tpu.data.synthetic import make_synthetic_lm_corpus as jax_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.lm import data as jax_data
from mtl_tpu.lm.fusion import LMScorer as JaxScorer
from mtl_tpu.lm.fusion import save_lm_fusion as jax_save_fusion
from mtl_tpu.lm.model import RNNLM as JaxLM
from mtl_tpu.lm.train import evaluate_lm as jax_evaluate_lm
from mtl_tpu.lm.train import evaluate_lm_test as jax_evaluate_lm_test
from mtl_tpu_torch.cli import lm as port_cli
from mtl_tpu_torch.data.synthetic import make_synthetic_lm_corpus
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import lm_params_to_torch, torch_to_flax_lm_params
from mtl_tpu_torch.lm import data as port_data
from mtl_tpu_torch.lm.fusion import LMScorer, save_lm_fusion
from mtl_tpu_torch.lm.model import RNNLM
from mtl_tpu_torch.lm.train import evaluate_lm, evaluate_lm_test

CPU = torch.device("cpu")


def _flax_lm(rnn_type, ntoken, ninp, nhid, nlayers, tied, seed):
    jm = JaxLM(rnn_type, ntoken, ninp, nhid, nlayers, 0.0, tied)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32),
        jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 1), jnp.int32)))
    arch = {"rnn_type": rnn_type, "ntoken": ntoken, "ninp": ninp,
            "nhid": nhid, "nlayers": nlayers, "dropout": 0.0,
            "tie_weights": tied}
    model = RNNLM(rnn_type, ntoken, ninp, nhid, nlayers, 0.0, tied)
    model.load_state_dict(lm_params_to_torch(params, arch))
    return jm, params, model.eval(), arch


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU", "RNN_TANH", "RNN_RELU"])
def test_rnnlm_logits_match_flax(rnn_type, tied):
    """Logits over two windows, the carry passed from the first to the
    second; the port's biases: one parameter per gate, the other side a
    buffer; interop round trip exact."""
    jm, params, model, arch = _flax_lm(rnn_type, 23, 8, 8, 2, tied, 1)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 23, size=(2, 6, 3))
    jl0, jc = jm.apply(params, jnp.asarray(toks[0]))
    jl1, _ = jm.apply(params, jnp.asarray(toks[1]), jc)
    with torch.no_grad():
        pl0, pc = model(torch.from_numpy(toks[0]))
        pl1, _ = model(torch.from_numpy(toks[1]), pc)
    for a, b in ((pl0, jl0), (pl1, jl1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sum(n.endswith(".bias") and n.startswith("rnns.")
               for n in names) == 2
    assert not any("zero_bias" in n for n in names)
    back = torch_to_flax_lm_params(model.state_dict(), arch)
    assert jax.tree.all(jax.tree.map(np.array_equal, back,
                                     jax.tree.map(np.asarray, params)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The code-switched task of a synthetic word corpus, and one LSTM LM
    over its dictionary in both packages."""
    root = tmp_path_factory.mktemp("lmcorpus")
    task = make_synthetic_lm_corpus(str(root), num_tasks=2,
                                    sentences_per_task=30, seed=3)[-1]
    paths = [f"{task}/{s}.txt" for s in ("train", "valid", "test")]
    c = port_data.Corpus(*paths)
    jm, params, model, arch = _flax_lm("LSTM", len(c.dictionary), 10, 10, 2,
                                       False, 4)
    return root, paths, c, jm, params, model, arch


def test_corpus_and_batching_match_jax(corpus, tmp_path):
    root, paths, c, *_ = corpus
    jc = jax_data.Corpus(*paths)
    assert c.dictionary.word2idx == jc.dictionary.word2idx
    for a, b in ((c.train, jc.train), (c.train_lang, jc.train_lang),
                 (c.test, jc.test), (c.valid_lang, jc.valid_lang)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_data.batchify(c.train, 4),
                                  jax_data.batchify(jc.train, 4))
    for (x, y), (u, v) in zip(
            port_data.LMDataset([c.train, c.valid], 6, 3).windows(0),
            jax_data.LMDataset([jc.train, jc.valid], 6, 3).windows(0)):
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)
    for i in (0, 5):
        for a, b in zip(port_data.LMDataset([c.train, c.valid], 6, 3).sample(
                -1, i), jax_data.LMDataset([jc.train, jc.valid], 6,
                                           3).sample(-1, i)):
            np.testing.assert_array_equal(a, b)
    # the port's corpus generator writes the JAX package's files
    other = jax_corpus(str(tmp_path), num_tasks=2, sentences_per_task=30,
                       seed=3)[-1]
    for s in ("train", "valid", "test"):
        with open(f"{other}/{s}.txt", encoding="utf-8") as f, \
                open(f"{root}/lm_task1/{s}.txt", encoding="utf-8") as g:
            assert f.read() == g.read()


def _close(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-12)


def test_evaluate_lm_matches_jax(corpus):
    _, _, c, jm, params, model, _ = corpus
    for stream, bptt in ((c.valid, 5), (c.train, 7)):
        want = jax_evaluate_lm(jm, params, stream, bptt)
        assert math.isclose(evaluate_lm(model, stream, bptt), want,
                            rel_tol=1e-5)


def _dump_rows(path):
    with open(path, encoding="utf-8") as f:
        return [ln.split("\t") for ln in f.read().split("\n")]


def test_evaluate_lm_test_matches_jax(corpus, tmp_path):
    _, _, c, jm, params, model, _ = corpus
    idx2word = {v: k for k, v in c.dictionary.word2idx.items()}
    want = jax_evaluate_lm_test(jm, params, c.test, idx2word, 6,
                                dump_path=str(tmp_path / "jax.txt"))
    got = evaluate_lm_test(model, c.test, idx2word, 6,
                           dump_path=str(tmp_path / "port.txt"))
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("_count"):
            assert got[k] == want[k], k
        else:
            assert _close(got[k], want[k]), (k, got[k], want[k])
    assert want["en_zh_count"] > 0 and want["zh_en_count"] > 0
    rows, ref = _dump_rows(tmp_path / "port.txt"), _dump_rows(
        tmp_path / "jax.txt")
    assert len(rows) == len(ref) == len(c.test) + 1  # + the blank line
    for r, s in zip(rows, ref):
        assert r[:2] == s[:2]
        np.testing.assert_allclose([float(x) for x in r[2:]],
                                   [float(x) for x in s[2:]], rtol=1e-5)


@pytest.fixture(scope="module")
def scorers(corpus, tmp_path_factory):
    """(JAX scorer, port scorer, ASR vocab) over the corpus LM."""
    root = tmp_path_factory.mktemp("fusion")
    _, _, c, jm, params, model, arch = corpus
    jax_save_fusion(str(root / "jax"), params, c.dictionary.word2idx, arch)
    save_lm_fusion(str(root / "port"), model, c.dictionary.word2idx, arch)
    labels = list("abcdefghijklmnopqrstuvwxyz ") + [
        chr(0x4E00 + i) for i in range(30)]
    return (JaxScorer.load(str(root / "jax")),
            LMScorer.load(str(root / "port"), CPU),
            Vocab.from_labels(labels))


def _ids(vocab, text):
    return [vocab.SOS_ID] + vocab.encode_transcript(text) + [vocab.EOS_ID]


SEQS = {
    "empty": "",
    "specials_only": None,  # SOS PAD EOS: nothing left after stripping
    "oov": "the zebra sat",
    "mixed": "the cat 丁丂 sat 七on mat",
    "zh_only": "丁 七丂",
    "long": " ".join(["the cat 丁 sat 七"] * 70),  # 350 words > 256
}


@pytest.mark.parametrize("name", list(SEQS))
def test_score_ids_matches_jax(scorers, name):
    jsc, psc, vocab = scorers
    ids = ([vocab.SOS_ID, vocab.PAD_ID, vocab.EOS_ID] if SEQS[name] is None
           else _ids(vocab, SEQS[name]))
    want = jsc.score_ids(ids, JaxVocab.from_labels(vocab.id2label[4:]))
    got = psc.score_ids(ids, vocab)
    assert got[1:] == want[1:]
    assert math.isclose(got[0], want[0], rel_tol=1e-5, abs_tol=1e-5)
    if name in ("empty", "specials_only"):
        assert got == (-999.0, 0, 0)
    if name == "oov":
        assert got[2] == 1
    if name == "long":
        assert got[1] == 351


def test_score_batch_equals_per_sequence(scorers):
    """One right-padded [T, N] call (the beam's whole bank) gives each
    sequence's own score."""
    _, psc, vocab = scorers
    id_lists = [_ids(vocab, s) for s in SEQS.values() if s is not None]
    batch = psc.score_batch(id_lists, vocab)
    for ids, got in zip(id_lists, batch):
        one = psc.score_ids(ids, vocab)
        assert got[1:] == one[1:]
        assert math.isclose(got[0], one[0], rel_tol=1e-6, abs_tol=1e-6)


def test_evaluate_matches_jax(scorers):
    """The CE sum and OOV count of a word string (utils/lm.py:101-123)."""
    jsc, psc, _ = scorers
    for seq in ("the cat sat", "the zebra 丁 mat", ""):
        want, got = jsc.evaluate(seq), psc.evaluate(seq)
        assert got[1] == want[1]
        assert math.isclose(got[0], want[0], rel_tol=1e-5, abs_tol=1e-6)


def test_lm_cli_test_and_convert_match_jax(corpus, scorers, tmp_path,
                                           monkeypatch, capsys):
    """Both packages' lm/test.py entry points on one checkpoint: the same
    perplexity/transition results and per-word dump; then convert_main ->
    LMScorer.load scores as the JAX scorer does."""
    monkeypatch.chdir(tmp_path)
    _, paths, c, jm, params, model, _ = corpus
    jargs = jax_cli.lm_parser("").parse_args(["--emsize", "10", "--nhid",
                                              "10", "--dropout", "0"])
    pargs = port_cli.lm_parser("").parse_args(["--emsize", "10", "--nhid",
                                               "10", "--dropout", "0"])
    n = len(c.dictionary)
    jax_cli.save_lm_ckpt(str(tmp_path / "jax_ckpt"), params, c.dictionary,
                         jargs, n)
    port_cli.save_lm_ckpt(str(tmp_path / "port_ckpt"), model, c.dictionary,
                          pargs, n)
    flags = ["--test_path", paths[2], "--bptt", "6", "--emsize", "10",
             "--nhid", "10", "--dropout", "0"]
    want = jax_cli.test_main(flags + ["--load", str(tmp_path / "jax_ckpt"),
                                      "--name", "jax"])
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    got = port_cli.test_main(flags + ["--load", str(tmp_path / "port_ckpt"),
                                      "--name", "port", "--device", "cpu"])
    pline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(jline) == len(pline) == 1
    assert json.loads(pline[0]).keys() == json.loads(jline[0]).keys()
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])
    suffix = "_modelLSTM_bptt6_lr20_drop0.0_layers2_nhid10_emsize10"
    rows = _dump_rows(tmp_path / "predictions" / f"lm_test_port{suffix}")
    ref = _dump_rows(tmp_path / "predictions" / f"lm_test_jax{suffix}")
    assert len(rows) == len(ref) > 2
    for r, s in zip(rows, ref):
        assert r[:2] == s[:2]
        np.testing.assert_allclose([float(x) for x in r[2:]],
                                   [float(x) for x in s[2:]], rtol=1e-5)

    out = port_cli.convert_main(["--load", str(tmp_path / "port_ckpt"),
                                 "--save", str(tmp_path / "fused"),
                                 "--device", "cpu"])
    jax_cli.convert_main(["--load", str(tmp_path / "jax_ckpt"), "--save",
                          str(tmp_path / "jax_fused")])
    jsc = JaxScorer.load(str(tmp_path / "jax_fused"))
    psc = LMScorer.load(out, CPU)
    vocab = scorers[2]
    ids = _ids(vocab, SEQS["mixed"])
    want = jsc.score_ids(ids, JaxVocab.from_labels(vocab.id2label[4:]))
    got = psc.score_ids(ids, vocab)
    assert got[1:] == want[1:]
    assert math.isclose(got[0], want[0], rel_tol=1e-5)


def test_lm_test_refuses_words_outside_the_lm(corpus, tmp_path,
                                              monkeypatch):
    """A test corpus with a word the checkpoint's dictionary lacks gives
    ids past the LM's vocabulary: the port raises before the model runs."""
    monkeypatch.chdir(tmp_path)
    _, _, c, _, _, model, _ = corpus
    args = port_cli.lm_parser("").parse_args(["--emsize", "10", "--nhid",
                                              "10"])
    port_cli.save_lm_ckpt(str(tmp_path / "ckpt"), model, c.dictionary, args,
                          len(c.dictionary))
    (tmp_path / "new.txt").write_text("the cat zebra\n", encoding="utf-8")
    with pytest.raises(ValueError, match="not trained on"):
        port_cli.test_main(["--load", str(tmp_path / "ckpt"), "--test_path",
                            str(tmp_path / "new.txt"), "--device", "cpu"])


@pytest.mark.parametrize("main", ["main_main", "main_joint_main",
                                  "main_meta_transfer_main",
                                  "finetune_main"])
def test_lm_training_mains_are_refused(main):
    with pytest.raises(ValueError, match="not ported yet"):
        getattr(port_cli, main)([])
