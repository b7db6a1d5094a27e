"""The port's beam search (``mtl_tpu_torch/decode/beam.py``) and the beam
branch of its ``test_main`` against the JAX package's, on the CPU.

One Flax param tree of a tiny ASR Transformer (f32, dropout 0) goes into
both packages through ``mtl_tpu_torch.interop``; features come from numpy.
Three weight variants: as drawn; ``eos``, where the last decoder layer's
LayerNorm holds feature 0 at 1, so that row 0 of the output kernel acts as
an output bias, which makes EOS likely and retires hypotheses early; and
``tie``, where two tokens get the same output column, so that their
expansions tie exactly and the order of a top-k on ties decides the beam.
Tolerances: bank tokens, lengths and word counts equal; raw scores (f32
sums of log-softmax values, summation order only) within 1e-4; final
scores within 1e-4; strings equal.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.decode.beam import beam_decode_ids as jax_beam_ids
from mtl_tpu.decode.beam import beam_search_grouped as jax_grouped
from mtl_tpu.lm.fusion import LMScorer as JaxScorer
from mtl_tpu.lm.fusion import save_lm_fusion as jax_save_fusion
from mtl_tpu.lm.model import RNNLM as JaxLM
from mtl_tpu.models.transformer import ASRTransformer as JaxASR
from mtl_tpu_torch.data.vocab import EOS_ID, SOS_ID, Vocab, post_process
from mtl_tpu_torch.decode.beam import (NEG_INF, beam_decode_ids,
                                       beam_search, beam_search_grouped,
                                       topk_stable)
from mtl_tpu_torch.decode.greedy import greedy_search
from mtl_tpu_torch.interop import flax_params_to_torch, lm_params_to_torch
from mtl_tpu_torch.lm.fusion import LMScorer, save_lm_fusion
from mtl_tpu_torch.lm.model import RNNLM
from mtl_tpu_torch.models.decoder import reorder_caches
from mtl_tpu_torch.models.transformer import ASRTransformer

LABELS = list("abcd efg") + ["中", "文"]
MODEL_KW = dict(feat_extractor="vgg_cnn", num_enc_layers=1,
                num_dec_layers=2, num_heads=2, dim_model=16, dim_key=8,
                dim_value=8, dim_input=(12 // 4) * 128, dim_inner=16,
                dim_emb=16, dropout=0.0, src_max_length=64,
                trg_max_length=32, r=4)
STEPS = 8


def _variant(params, name, vocab):
    """The weight variants of the module docstring."""
    p = jax.tree.map(np.array, params)
    dec = p["params"]["decoder"]
    kernel = dec["output_linear"]["kernel"]  # [d_model, V]
    if name in ("eos", "tie"):
        ln = dec["layers_1"]["pos_ffn"]["layer_norm"]
        ln["scale"][0], ln["bias"][0] = 0.0, 1.0
        kernel[0, :] = 0.0
    if name == "eos":
        kernel[0, EOS_ID] = 3.0
    elif name == "tie":
        a, b = vocab.label2id["a"], vocab.label2id["b"]
        kernel[:, b] = kernel[:, a]
        kernel[0, a] = kernel[0, b] = 2.5
    return p


@pytest.fixture(scope="module")
def setup():
    vocab = Vocab.from_labels(LABELS)
    rng = np.random.RandomState(5)
    jmodel = JaxASR(vocab_size=len(vocab), dtype=jnp.float32, **MODEL_KW)
    feats = (rng.randn(2, 12, 12) * 0.5).astype(np.float32)
    lengths = np.array([12, 9], np.int32)
    params = jmodel.init(jax.random.PRNGKey(rng.randint(2 ** 31)),
                         jnp.asarray(feats), jnp.asarray(lengths),
                         jnp.zeros((2, 3), jnp.int32))
    variants = {}
    for name in ("plain", "eos", "tie"):
        p = _variant(params, name, vocab)
        model = ASRTransformer(vocab_size=len(vocab), dtype=torch.float32,
                               **MODEL_KW)
        model.load_state_dict(flax_params_to_torch(p))
        variants[name] = (p, model.eval())
    return jmodel, variants, vocab, feats, lengths


def _both(setup, variant, w, bank=0, c_weight=0.3):
    jmodel, variants, vocab, feats, lengths = setup
    params, model = variants[variant]
    space = vocab.label2id[" "]
    want = jax_beam_ids(jmodel, params, jnp.asarray(feats),
                        jnp.asarray(lengths), w, STEPS, SOS_ID, bank, space,
                        jnp.asarray(c_weight, jnp.float32))
    got = beam_decode_ids(model, torch.from_numpy(feats),
                          torch.from_numpy(lengths), w, STEPS, SOS_ID, bank,
                          space, c_weight)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("variant", ["plain", "eos", "tie"])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_beam_decode_ids_matches_jax(setup, variant, w):
    (jt, js, jw, jl), (pt, ps, pw, pl) = _both(setup, variant, w)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pw, jw)
    real = js > NEG_INF / 2
    np.testing.assert_array_equal(ps > NEG_INF / 2, real)
    np.testing.assert_allclose(ps[real], js[real], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ps[~real], js[~real])
    if variant == "eos" and w == 3:
        # hypotheses retired before the horizon
        assert (jl[real] < STEPS + 1).sum() >= 2


def test_planted_tie_is_taken_lowest_index_first(setup, monkeypatch):
    """Tokens a and b tie exactly and lead the beam: the port's bank is the
    JAX one, and breaking the ties the other way gives another bank, so
    the order on ties is what the comparison checks."""
    import mtl_tpu_torch.decode.beam as beam

    for w in (1, 2):
        (jt, _, _, jl), (pt, _, _, pl) = _both(setup, "tie", w, bank=4)
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pl, jl)

    def highest_index_first(x, k):
        v, i = topk_stable(x.flip(-1), k)
        return v, x.shape[-1] - 1 - i

    monkeypatch.setattr(beam, "topk_stable", highest_index_first)
    _, (flipped, _, _, _) = _both(setup, "tie", 1, bank=4)
    assert not np.array_equal(flipped, jt)


def test_topk_stable_orders_ties_like_lax_top_k():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 4, size=(6, 40)).astype(np.float32)
    x[:, :5] = -2e9  # the bank's fillers
    for k in (1, 3, 17):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_reorder_caches_gathers_without_aliasing():
    k = torch.arange(24, dtype=torch.float32).view(4, 3, 1, 2)
    caches = [(k, k + 100)]
    out = reorder_caches(caches, torch.tensor([1, 1, 3, 0]))
    assert torch.equal(out[0][0], k[[1, 1, 3, 0]])
    assert torch.equal(out[0][1], k[[1, 1, 3, 0]] + 100)
    out[0][0][0, 0] = -1.0  # a decode step writes its cache in place
    assert float(k[1, 0].min()) >= 0.0
    assert out[0][0].data_ptr() != k.data_ptr()


def test_width_one_beam_equals_greedy(setup):
    """W = 1: the beam keeps the argmax path, so its one hypothesis is the
    greedy string up to its first EOS (or the horizon)."""
    _, variants, vocab, feats, lengths = setup
    for name in ("plain", "eos"):
        model = variants[name][1]
        f, n = torch.from_numpy(feats), torch.from_numpy(lengths)
        grouped = beam_search_grouped(model, f, n, vocab, beam_width=1,
                                      nbest=1, max_steps=STEPS,
                                      start_token=SOS_ID)
        greedy = greedy_search(model, f, n, vocab, STEPS, SOS_ID)
        assert [g[0][2] for g in grouped] == [
            post_process(s, vocab.special_token_list) for s in greedy]


@pytest.fixture(scope="module")
def fusion_lm(setup, tmp_path_factory):
    """(JAX scorer, port scorer) on one flax LM over the words the beam can
    emit; the fusion directory in each package's format."""
    root = tmp_path_factory.mktemp("fusion")
    word2idx = {"<oov>": 0, "<eos>": 1, "ab": 2, "cd": 3, "a": 4, "中": 5,
                "文": 6, "efg": 7}
    arch = {"rnn_type": "LSTM", "ntoken": 8, "ninp": 8, "nhid": 8,
            "nlayers": 2, "dropout": 0.0, "tie_weights": False}
    jlm = JaxLM("LSTM", 8, 8, 8, 2, 0.0, False)
    rng = np.random.RandomState(9)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.5 * rng.randn(*x.shape).astype(
            np.float32),
        jlm.init(jax.random.PRNGKey(3), jnp.zeros((2, 1), jnp.int32)))
    jax_save_fusion(str(root / "jax"), params, word2idx, arch)
    model = RNNLM("LSTM", 8, 8, 8, 2, 0.0, False)
    model.load_state_dict(lm_params_to_torch(params, arch))
    save_lm_fusion(str(root / "port"), model, word2idx, arch)
    return (JaxScorer.load(str(root / "jax")),
            LMScorer.load(str(root / "port"), torch.device("cpu")), root)


@pytest.mark.parametrize("lm_rescoring", [False, True],
                         ids=["no_lm", "lm_fusion"])
def test_beam_search_grouped_matches_jax(setup, fusion_lm, lm_rescoring):
    jmodel, variants, vocab, feats, lengths = setup
    params, model = variants["eos"]
    jlm, plm, _ = fusion_lm
    kw = dict(beam_width=3, nbest=4, max_steps=STEPS, start_token=SOS_ID,
              c_weight=0.3, lm_rescoring=lm_rescoring, lm_weight=0.5)
    want = jax_grouped(jmodel, params, jnp.asarray(feats),
                       jnp.asarray(lengths), JaxVocab.from_labels(LABELS),
                       lm=jlm, **kw)
    got = beam_search_grouped(model, torch.from_numpy(feats),
                              torch.from_numpy(lengths), vocab, lm=plm, **kw)
    assert [[(ids, s) for _, ids, s in g] for g in got] == \
        [[(ids, s) for _, ids, s in g] for g in want]
    np.testing.assert_allclose([h[0] for g in got for h in g],
                               [h[0] for g in want for h in g],
                               rtol=1e-4, atol=1e-4)
    ids, strs = beam_search(model, torch.from_numpy(feats),
                            torch.from_numpy(lengths), vocab, lm=plm, **kw)
    assert strs == [s for g in got for _, _, s in g]
    assert all(row[0] == SOS_ID for row in ids)


# -- test_main end to end ----------------------------------------------------

def _report(out):
    lines = [ln for ln in out.splitlines() if ln.startswith(
        ("PRED:", "GOLD:", "NBEST", "TOTAL CER", ">>>>>>>"))]
    return [re.sub(r" TIME: .*$", "", ln) for ln in lines]


@pytest.mark.parametrize("lm_rescoring,eos_bias", [
    (False, 1.8), (True, 1.8), (False, 1.9)],
    ids=["no_lm", "lm_fusion", "switch_to_greedy"])
def test_beam_test_main_matches_jax(tmp_path, monkeypatch, capsys,
                                    fusion_lm, lm_rescoring, eos_bias):
    """Both ``test_main``s with ``--beam-search --beam-width 2
    --beam-nbest 2``: the same PRED/GOLD/NBEST and TOTAL lines. The EOS
    bias (as in the "eos" variant) retires hypotheses before the horizon;
    at 1.9 the first hypothesis of both batches is empty, and both switch
    to greedy."""
    from mtl_tpu.cli.asr import test_main as jax_test_main
    from mtl_tpu.data.synthetic import make_synthetic_corpus
    from mtl_tpu.models.transformer import build_model as jax_build_model
    from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_ckpt
    from mtl_tpu_torch.cli.asr import test_main as port_test_main
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    manifests, labels_path = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=1, utts_per_task=3, min_sec=0.2,
        max_sec=0.6, max_chars=6, seed=4)
    with open(labels_path, encoding="utf-8") as f:
        jvocab = JaxVocab.from_labels(json.load(f))
    cfg = JaxConfig()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 2, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 128, 320
    cfg.name, cfg.save_folder = "jax_ckpt", str(tmp_path / "models")
    cfg.finalize()
    jmodel = jax_build_model(cfg, len(jvocab))
    rng = np.random.RandomState(13)
    params = jax.tree.map(np.array, jmodel.init(
        jax.random.PRNGKey(rng.randint(2 ** 31)),
        jnp.zeros((1, 32, cfg.audio.num_freq), jnp.float32),
        jnp.array([32], jnp.int32), jnp.zeros((1, 4), jnp.int32)))
    dec = params["params"]["decoder"]
    ln = dec[f"layers_{cfg.model.num_dec_layers - 1}"]["pos_ffn"][
        "layer_norm"]
    ln["scale"][0], ln["bias"][0] = 0.0, 1.0
    dec["output_linear"]["kernel"][0, :] = 0.0
    dec["output_linear"]["kernel"][0, EOS_ID] = eos_bias
    jax_path = jax_save_ckpt(cfg, jvocab, {"params": params}, step=0,
                             best_model=True)
    port_cfg = Config.from_dict(json.loads(cfg.to_json()))
    port_cfg.name = "port_ckpt"
    port_path = save_checkpoint(port_cfg, Vocab.from_dict(jvocab.to_dict()),
                                flax_params_to_torch(params), 0,
                                best_model=True)

    common = ["--test-manifest-list", manifests[0], "--labels-path",
              labels_path, "--k-test", "2", "--src-buckets", "64",
              "--tgt-buckets", "16", "--beam-search", "--beam-width", "2",
              "--beam-nbest", "2", "--tgt-max-len", "12"]
    root = fusion_lm[2]
    jax_lm = ["--lm-rescoring", "--lm-path", str(root / "jax")]
    port_lm = ["--lm-rescoring", "--lm-path", str(root / "port")]
    jax_test_main(common + ["--name", "jax_test", "--continue-from",
                            jax_path] + (jax_lm if lm_rescoring else []))
    want = _report(capsys.readouterr().out)
    result = port_test_main(common + [
        "--name", "port_test", "--continue-from", port_path, "--device",
        "cpu"] + (port_lm if lm_rescoring else []))
    got = _report(capsys.readouterr().out)
    assert result["utterances"] == 3
    switched = want.count(">>>>>>> switch to greedy")
    assert result["switched_to_greedy"] == switched == (
        2 if eos_bias > 1.85 else 0)
    assert sum(ln.startswith("NBEST") for ln in want) == (
        0 if switched else 6)
    assert got == want
