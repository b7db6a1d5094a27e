"""The port's model against the JAX package's, on one shared weight set.

One Flax param tree (``build_model(...).init`` from a numpy-drawn PRNG seed)
goes into both packages through ``mtl_tpu_torch.interop``; features come
from numpy. At f32 both sides compute the same function, so tolerances are
f32 summation-order ones (1e-4 absolute and relative on O(1) activations).
The JAX conv runs its XLA path (``vgg_block_reference`` semantics); the
port's runs the plain version of its VGG kernels, held against the Pallas
kernels in tests/test_torch_port_vgg.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.decode.greedy import greedy_decode_ids as jax_greedy_ids
from mtl_tpu.models.transformer import ASRTransformer as JaxASR
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.decode.greedy import greedy_decode_ids
from mtl_tpu_torch.interop import flax_params_to_torch, torch_to_flax_params
from mtl_tpu_torch.models.transformer import build_model
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB = 11
TOL = dict(rtol=1e-4, atol=1e-4)


def _tiny(cfg, factorized):
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 2, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.tgt_max_len = 64
    m.is_factorized = factorized
    return cfg.finalize()


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense_ffn", "factorized"])
def pair(request):
    """(jax model, flax params, port model, features, lengths)."""
    rng = np.random.RandomState(7)
    jcfg = _tiny(JaxConfig(), request.param)
    jmodel = jax_build_model(jcfg, VOCAB)
    feats = rng.randn(2, 36, jcfg.audio.num_freq).astype(np.float32)
    # raw frame counts: row 1 is shorter than the downsampled axis (9), so
    # the raw-length encoder masks pad positions 5..8 of that row
    lengths = np.array([36, 5], np.int32)
    params = jmodel.init(jax.random.PRNGKey(rng.randint(2 ** 31)),
                         jnp.asarray(feats), jnp.asarray(lengths),
                         jnp.zeros((2, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    model = build_model(_tiny(Config(), request.param), VOCAB)
    model.load_state_dict(flax_params_to_torch(params))
    return jmodel, params, model.eval(), feats, lengths


def test_interop_round_trip_is_identical(pair):
    _, params, model, _, _ = pair
    back = torch_to_flax_params(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


@torch.no_grad()
def test_encoder_and_cross_kv_match_jax(pair):
    jmodel, params, model, feats, lengths = pair
    enc_j, kv_j = jmodel.apply(params, jnp.asarray(feats),
                               jnp.asarray(lengths),
                               method=JaxASR.prepare_decode)
    enc, kv = model.prepare_decode(torch.from_numpy(feats),
                                   torch.from_numpy(lengths))
    assert enc.shape == enc_j.shape == (2, 9, 16)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), **TOL)
    assert len(kv) == len(kv_j) == 2
    for (k, v), (kj, vj) in zip(kv, kv_j):
        np.testing.assert_allclose(k.numpy(), np.asarray(kj), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(vj), **TOL)


@torch.no_grad()
def test_decode_steps_match_jax(pair):
    """Five successive KV-cache steps: PE at offset t, cache slots > t
    masked, no decoder-encoder mask."""
    jmodel, params, model, feats, lengths = pair
    _, kv_j = jmodel.apply(params, jnp.asarray(feats), jnp.asarray(lengths),
                           method=JaxASR.prepare_decode)
    caches_j = jmodel.apply(params, 2, 8, method=JaxASR.init_cache)
    _, kv = model.prepare_decode(torch.from_numpy(feats),
                                 torch.from_numpy(lengths))
    caches = model.init_cache(2, 8, torch.device("cpu"))
    tokens = np.array([[1, 1], [5, 9], [7, 2], [4, 10], [6, 3]], np.int32)
    for t, y in enumerate(tokens):
        logits_j, caches_j = jmodel.apply(params, jnp.asarray(y), t, kv_j,
                                          caches_j,
                                          method=JaxASR.decode_step)
        logits, caches = model.decode_step(torch.from_numpy(y).long(), t, kv,
                                           caches)
        assert logits.shape == (2, VOCAB) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   **TOL)


def test_greedy_ids_match_jax(pair):
    jmodel, params, model, feats, lengths = pair
    ids_j = np.asarray(jax_greedy_ids(jmodel, params, jnp.asarray(feats),
                                      jnp.asarray(lengths), 24, 1))
    ids = greedy_decode_ids(model, torch.from_numpy(feats),
                            torch.from_numpy(lengths), 24, 1).numpy()
    np.testing.assert_array_equal(ids, ids_j)


def test_pe_offset_clamps_like_dynamic_slice():
    from mtl_tpu.models.layers import PositionalEncoding as JaxPE
    from mtl_tpu_torch.models.layers import PositionalEncoding

    pe = PositionalEncoding(8, max_length=10)
    jpe = JaxPE(8, 10)
    for length, offset in ((1, 0), (1, 9), (1, 12), (4, 8)):
        want = np.asarray(jpe.apply({}, length, offset))
        np.testing.assert_array_equal(pe(length, offset).numpy(), want)


@pytest.mark.parametrize("name", ["non_pad_mask_from_lengths",
                                  "attn_pad_mask_from_lengths",
                                  "attn_key_pad_mask"])
def test_masks_match_jax(name):
    """Raw lengths may exceed the (downsampled) axis, as the encoder's
    reference quirk passes them."""
    from mtl_tpu.ops import masks as jmasks
    from mtl_tpu_torch.ops import masks

    lengths = np.array([9, 3, 0, 40], np.int32)
    ids = np.array([[5, 2, 2], [2, 7, 2], [4, 4, 4], [2, 2, 2]], np.int32)
    args = {"non_pad_mask_from_lengths": (lengths, 9),
            "attn_pad_mask_from_lengths": (lengths, 9, 4),
            "attn_key_pad_mask": (ids, 5, 2)}[name]
    want = np.asarray(getattr(jmasks, name)(jnp.asarray(args[0]), *args[1:]))
    got = getattr(masks, name)(torch.from_numpy(args[0]), *args[1:])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
