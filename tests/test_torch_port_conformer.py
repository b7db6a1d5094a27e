"""The port's Conformer encoder and remat against the JAX package's, on the
CPU.

One Flax param tree per case, moved into the port through
``mtl_tpu_torch.interop``; inputs drawn with numpy; the JAX side jitted.
Tolerances: at f32 rtol = atol = 1e-5 (only the order of the sums
differs); at bf16 an atol of 2^-6 of the largest |value| (two bf16 ulps of
it; the compute-dtype roundings fall at the same points, but a sum taken
in another order can round to the neighbouring bf16 value and carry on).
The port's VGG stack runs its plain version (CPU tensors), JAX its XLA
convs. ``--remat`` and ``--remat-conv`` are held within the port (same
loss, gradients and dropout stream with and without, at dropout 0.1) and,
for emb_cnn's running-average quirk, against JAX.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.models import conformer as jconf
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.interop import (adam_state_from_optax, adam_state_to_optax,
                                   flax_params_to_torch, torch_to_flax_params)
from mtl_tpu_torch.models import conformer
from mtl_tpu_torch.models.transformer import build_model, init_weights
from tests.torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D, HEADS, T, VOCAB = 16, 2, 10, 12


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -6 * np.abs(want).max())


def _to_port(tree):
    """A flax submodule's params -> the port module's state_dict (the
    generic interop rules under a neutral top-level name)."""
    sd = flax_params_to_torch({"m": tree["params"]})
    return {k[len("m."):]: v for k, v in sd.items()}


def _masks(lengths):
    from mtl_tpu_torch.ops.masks import (attn_pad_mask_from_lengths,
                                         non_pad_mask_from_lengths)

    lt = torch.from_numpy(lengths)
    return non_pad_mask_from_lengths(lt, T), attn_pad_mask_from_lengths(
        lt, T, T)


def test_rope_matches_jax():
    np.testing.assert_array_equal(conformer.rope_angles(7, 8),
                                  jconf.rope_angles(7, 8))
    x = np.random.RandomState(0).randn(2, 7, 2, 8).astype(np.float32)
    ang = jconf.rope_angles(7, 8)
    want = jconf.apply_rope(jnp.asarray(x), jnp.asarray(ang))
    got = conformer.apply_rope(torch.from_numpy(x), torch.from_numpy(ang))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # a bf16 q comes out f32, as JAX promotes it (conformer.py:42-46)
    want = jconf.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ang))
    got = conformer.apply_rope(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(ang))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# name -> (flax module, port module, whether it takes the pad masks)
def _modules(jdt, tdt):
    return {
        "ffn": (jconf.ConformerFFN(D, 4, 0.0, jdt),
                conformer.ConformerFFN(D, 4, 0.0, tdt), None),
        "attention": (jconf.ConformerAttention(HEADS, D, 0.0, jdt),
                      conformer.ConformerAttention(HEADS, D, 0.0, tdt),
                      "attn"),
        "conv_module": (jconf.ConformerConvModule(D, 31, 0.0, jdt),
                        conformer.ConformerConvModule(D, 31, 0.0, tdt),
                        "pad"),
        # the --second-order route of the depthwise conv
        "conv_module_unfolded": (
            jconf.ConformerConvModule(D, 31, 0.0, jdt),
            conformer.ConformerConvModule(D, 31, 0.0, tdt,
                                          second_order=True), "pad"),
        "block": (jconf.ConformerBlock(HEADS, D, 4, 31, 0.0, jdt),
                  conformer.ConformerBlock(HEADS, D, 4, 31, 0.0, tdt),
                  "both"),
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["ffn", "attention", "conv_module",
                                  "conv_module_unfolded", "block"])
def test_conformer_submodule_matches_jax(name, dtype):
    """Each submodule on a compute-dtype input of two rows, the second
    padded to 6 of 10 frames (its masks from the lengths, as the encoder
    builds them)."""
    from mtl_tpu.ops.masks import (attn_pad_mask_from_lengths,
                                   non_pad_mask_from_lengths)

    jdt, tdt = DTYPES[dtype]
    jmod, tmod, masks = _modules(jdt, tdt)[name]
    rng = np.random.RandomState(1)
    x = rng.randn(2, T, D).astype(np.float32)
    lengths = np.array([T, 6], np.int32)
    jnp_pad = non_pad_mask_from_lengths(jnp.asarray(lengths), T)
    j_attn = attn_pad_mask_from_lengths(jnp.asarray(lengths), T, T)
    t_pad, t_attn = _masks(lengths)
    jargs = {None: (), "attn": (j_attn,), "pad": (jnp_pad,),
             "both": (jnp_pad, j_attn)}[masks]
    targs = {None: (), "attn": (t_attn,), "pad": (t_pad,),
             "both": (t_pad, t_attn)}[masks]
    jx = jnp.asarray(x, jdt)
    params = jmod.init(jax.random.PRNGKey(2), jx, *jargs)
    params = jax.tree.map(np.asarray, params)
    want = jax.jit(jmod.apply)(params, jx, *jargs)
    tmod.load_state_dict(_to_port(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(tdt), *targs)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conformer_encoder_matches_jax(dtype):
    """Two blocks over [2, 10, 24] inputs, the second row padded to 6:
    every padded frame of the output is zero on both sides."""
    jdt, tdt = DTYPES[dtype]
    jenc = jconf.ConformerEncoder(num_layers=2, num_heads=HEADS,
                                  dim_model=D, dim_input=24, dropout=0.0,
                                  dtype=jdt)
    x = np.random.RandomState(3).randn(2, T, 24).astype(np.float32)
    lengths = np.array([T, 6], np.int32)
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(4), x,
                                                lengths))
    want = jax.jit(jenc.apply)(params, x, lengths)
    enc = conformer.ConformerEncoder(2, HEADS, D, 24, dropout=0.0, dtype=tdt)
    enc.load_state_dict(_to_port(params))
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.dtype == tdt and bool((got[1, 6:] == 0).all())
    _close(got, want, dtype)


def _jax_cfg(dtype="float32", dropout=0.0, feat_extractor="vgg_cnn",
             remat_conv=False):
    cfg = JaxConfig()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 1, HEADS
    m.dim_model = m.dim_emb = m.dim_inner = D
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, dtype, dropout
    m.src_max_len, m.tgt_max_len = 64, 32
    m.encoder_type, m.feat_extractor = "conformer", feat_extractor
    m.remat_conv = remat_conv
    if feat_extractor == "vgg_cnn":
        cfg.audio.window_size = 0.0015  # n_fft 24: 13 bins
    return cfg.finalize()


def _flax_model(jcfg, frames=24, seed=5):
    model = jax_build_model(jcfg, VOCAB)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, frames, jcfg.audio.num_freq)),
                        jnp.array([frames], jnp.int32),
                        jnp.zeros((1, 4), jnp.int32))
    return model, jax.tree.map(np.asarray, params)


def _port_model(jcfg, params):
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    model = build_model(cfg, VOCAB)
    model.load_state_dict(flax_params_to_torch(params))
    return cfg, model


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conformer_asr_logits_match_jax(dtype):
    """The Conformer ``ASRTransformer``'s teacher-forced logits (vgg_cnn
    -> Conformer -> decoder); row 1 is 14 raw frames of 24, its decoder
    input EOS-padded."""
    jcfg = _jax_cfg(dtype)
    jmodel, params = _flax_model(jcfg)
    rng = np.random.RandomState(6)
    feats = (rng.randn(2, 24, jcfg.audio.num_freq) * 0.5).astype(np.float32)
    lengths = np.array([24, 14], np.int32)
    seq_in = np.array([[1, 5, 6, 7], [1, 8, 2, 2]], np.int32)
    want = jax.jit(jmodel.apply)(params, feats, lengths, seq_in)
    _, model = _port_model(jcfg, params)
    assert model.encoder.blocks[0].conv.dw.weight.shape == (D, 1, 31)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(lengths),
                    torch.from_numpy(seq_in).long())
    _close(got, want, dtype)


def test_conformer_interop_round_trips():
    """Flax -> port -> flax gives back the same tree, the 3-D depthwise
    kernel included; optax Adam moments of the Conformer map by the same
    rules both ways."""
    jcfg = _jax_cfg()
    _, params = _flax_model(jcfg)
    sd = flax_params_to_torch(params)
    assert "encoder.blocks.1.attn.q.weight" in sd
    assert "encoder.blocks.0.conv.dw.weight" in sd
    back = torch_to_flax_params(sd)
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 params["params"])
    np.testing.assert_array_equal(
        sd["encoder.blocks.0.conv.dw.weight"].numpy(),
        params["params"]["encoder"]["block_0"]["conv"]["dw"][
            "kernel"].transpose(2, 1, 0))
    tx = optax.adam(1e-3)
    grads = jax.tree.map(lambda a: np.full_like(a, 0.5), params)
    _, state = tx.update(grads, tx.init(params), params)
    adam = state[0]
    port = adam_state_from_optax(adam.mu, adam.nu, adam.count)
    assert set(port.mu) == set(sd)
    mu, nu, count = adam_state_to_optax(port)
    jax.tree.map(np.testing.assert_array_equal, mu["params"],
                 jax.tree.map(np.asarray, adam.mu["params"]))
    assert int(count) == 1


def _report(out):
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("PRED:", "GOLD:", "TOTAL CER"))]
    return [re.sub(r" TIME: .*$", "", ln) for ln in lines]


def test_conformer_test_main_matches_jax(tmp_path, monkeypatch, capsys):
    """A Conformer checkpoint saved by the JAX package and moved into a
    port checkpoint: both ``test_main``s decode one corpus greedily to the
    same PRED/GOLD lines and TOTAL figures."""
    from mtl_tpu.cli.asr import test_main as jax_test_main
    from mtl_tpu.data.synthetic import make_synthetic_corpus
    from mtl_tpu.data.vocab import Vocab as JaxVocab
    from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save
    from mtl_tpu_torch.cli.asr import test_main as port_test_main
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=1, utts_per_task=5, min_sec=0.2,
        max_sec=0.6, max_chars=6, seed=3)
    with open(labels, encoding="utf-8") as f:
        vocab = JaxVocab.from_labels(json.load(f))
    jcfg = _jax_cfg()
    jcfg.model.tgt_max_len = 320
    jcfg.name, jcfg.save_folder = "jax_conf", str(tmp_path / "models")
    jmodel = jax_build_model(jcfg, len(vocab))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(11), jnp.zeros((1, 32, jcfg.audio.num_freq)),
        jnp.array([32], jnp.int32), jnp.zeros((1, 4), jnp.int32)))
    jax_path = jax_save(jcfg, vocab, {"params": params}, step=0,
                        best_model=True)
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    cfg.name = "port_conf"
    port_path = save_checkpoint(cfg, Vocab.from_dict(vocab.to_dict()),
                                flax_params_to_torch(params), 0,
                                best_model=True)
    common = ["--test-manifest-list", manifests[0], "--labels-path", labels,
              "--k-test", "2", "--src-buckets", "64", "--tgt-buckets", "16"]
    jax_test_main(common + ["--name", "jax_test", "--continue-from",
                            jax_path])
    want = _report(capsys.readouterr().out)
    result = port_test_main(common + ["--name", "port_test", "--continue-from",
                                      port_path, "--device", "cpu"])
    got = _report(capsys.readouterr().out)
    assert result["utterances"] == 5
    assert sum(ln.startswith("PRED:") for ln in want) == 5
    assert got == want


def test_port_conformer_checkpoint_trains_serves_and_resumes(
        tmp_path, monkeypatch, capsys):
    """The port's meta-transfer trainer with ``--encoder-type conformer
    --remat``: its checkpoint serves through ``test_main`` (greedy and
    beam) and resumes at the next iteration."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main, test_main
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus

    monkeypatch.chdir(tmp_path)
    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=3, utts_per_task=4, max_sec=0.4,
        max_chars=5, seed=8)
    models = str(tmp_path / "models")
    common = ["--train-manifest-list", *manifests, "--valid-manifest-list",
              manifests[-1], "--labels-path", labels, "--device", "cpu",
              "--encoder-type", "conformer", "--remat", "--num-enc-layers",
              "2", "--num-dec-layers", "1", "--num-heads", "2",
              "--dim-model", "16", "--dim-key", "8", "--dim-value", "8",
              "--dim-inner", "16", "--dim-emb", "16", "--dropout", "0.1",
              "--dtype", "float32", "--window-size", "0.0015",
              "--src-max-len", "64", "--tgt-max-len", "32", "--src-buckets",
              "64", "--tgt-buckets", "16", "--k-train", "2", "--k-valid",
              "2", "--evaluate-every", "2", "--save-every", "2",
              "--save-folder", models]
    state = meta_transfer_train_main(common + ["--epochs", "2", "--name",
                                               "conf"])
    assert state.step == 2
    assert any(k.startswith("encoder.blocks.1.conv.dw") for k in state.params)
    ckpt = os.path.join(models, "conf", "step_2")
    capsys.readouterr()
    for extra in ([], ["--beam-search", "--beam-width", "2"]):
        result = test_main(["--test-manifest-list", manifests[-1],
                            "--labels-path", labels, "--continue-from",
                            ckpt, "--k-test", "2", "--src-buckets", "64",
                            "--tgt-buckets", "16", "--device", "cpu",
                            "--name", "serve_conf"] + extra)
        assert result["utterances"] == 4
    state = meta_transfer_train_main(common + [
        "--epochs", "3", "--name", "conf_resume", "--continue-from", ckpt])
    out = capsys.readouterr().out
    assert re.findall(r"\(Iteration (\d+)\) TRAIN LOSS", out) == ["3"]
    assert state.step == 3 and state.opt_state.count == 3


# -- remat within the port ---------------------------------------------------

REMAT_CASES = {  # name -> (encoder_type, feat_extractor, model flag)
    "transformer-remat": ("transformer", "vgg_cnn", "remat"),
    "conformer-remat": ("conformer", "vgg_cnn", "remat"),
    "vgg_cnn-remat_conv": ("transformer", "vgg_cnn", "remat_conv"),
}


def _remat_run(name, on):
    """Two training forwards (two tasks' batches) and the gradient of the
    first at dropout 0.1 from one generator: (losses, gradients, the
    generator's state after each, calls of the recomputed modules)."""
    from mtl_tpu_torch.train.steps import make_forward_fn

    encoder, feat, flag = REMAT_CASES[name]
    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 1, HEADS
    m.dim_model = m.dim_emb = m.dim_inner = D
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.1
    m.encoder_type, m.feat_extractor = encoder, feat
    setattr(m, flag, on)
    cfg.audio.window_size = 0.0015
    cfg.finalize()
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    calls = []
    watched = [model.conv] if flag == "remat_conv" else \
        list(model.encoder.layers if encoder == "transformer"
             else model.encoder.blocks)
    for mod in watched:
        mod.register_forward_pre_hook(lambda *_: calls.append(1))
    rng = np.random.RandomState(2)
    batches = [{"features": torch.from_numpy(
                    (rng.randn(2, 24, 13) * 0.5).astype(np.float32)),
                "input_lengths": torch.tensor([24, 16]),
                "targets": torch.from_numpy(rng.randint(3, VOCAB, (2, 5)))}
               for _ in range(2)]
    forward = make_forward_fn(model, cfg)
    gen = torch.Generator().manual_seed(9)
    params = dict(model.named_parameters())
    loss, _ = forward(params, batches[0], gen, False)
    grads = torch.autograd.grad(loss, list(params.values()))
    states = [gen.get_state()]
    loss2, _ = forward(params, batches[1], gen, False)
    states.append(gen.get_state())
    return [loss, loss2], grads, states, len(calls) / len(watched)


@pytest.mark.parametrize("name", list(REMAT_CASES))
def test_remat_keeps_loss_gradients_and_dropout_stream(name):
    """With remat the watched modules run twice in a forward and backward
    (the recompute), once without; the losses, the gradients and the
    generator's state after the backward and after the next forward are
    the same: the recompute replays the forward's dropout masks, on the
    parameters the forward saw (here through ``functional_call``, as the
    meta step's adapted weights)."""
    want_loss, want_g, want_states, calls_off = _remat_run(name, False)
    got_loss, got_g, got_states, calls_on = _remat_run(name, True)
    assert calls_off == 2 and calls_on == 3  # 2 forwards + 1 recompute
    for a, b in zip(got_loss, want_loss):
        assert torch.equal(a, b)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got_states, want_states):
        assert torch.equal(a, b)


def test_remat_conv_emb_cnn_uses_running_averages_as_jax():
    """JAX's ``remat_conv`` calls the front-end without ``train``
    (mtl_tpu/models/transformer.py:91-96): emb_cnn's BatchNorm normalizes
    by its running averages in a training forward and its statistics stay
    as they were. The port's training forward under ``--remat-conv``
    reports no statistics, and its loss and gradients match JAX's (f32,
    dropout 0; running statistics moved off their init so that they
    matter)."""
    from mtl_tpu.train.steps import make_forward_fn as jax_forward_fn
    from mtl_tpu_torch.train.steps import make_forward_fn

    jcfg = _jax_cfg(feat_extractor="emb_cnn", remat_conv=True)
    jcfg.model.encoder_type = "transformer"
    jmodel, params = _flax_model(jcfg, frames=40)
    rng = np.random.RandomState(7)
    for bn in params["batch_stats"]["conv"]["conv"].values():
        bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    batch = {"features": (rng.randn(2, 40, 161) * 0.5).astype(np.float32),
             "input_lengths": np.array([40, 30], np.int32),
             "targets": rng.randint(3, VOCAB, (2, 5)).astype(np.int32),
             "src_percentages": np.ones(2, np.float32)}
    jf = jax_forward_fn(jmodel, jcfg)
    (want_loss, aux), want_g = jax.jit(jax.value_and_grad(
        lambda p: jf(p, batch, jax.random.PRNGKey(0), False),
        has_aux=True))(params)
    jax.tree.map(np.testing.assert_array_equal, aux["batch_stats"],
                 params["batch_stats"])
    cfg, model = _port_model(jcfg, params)
    assert model.remat_conv
    stats = []
    loss, _ = make_forward_fn(model, cfg)(
        None, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        False, stats_out=stats)
    assert stats == []
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = flax_params_to_torch({"params": jax.tree.map(
        np.asarray, want_g["params"])})
    scale = max(float(v.abs().max()) for v in want.values())
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=1e-4,
                                   atol=1e-5 * scale, msg=k)
