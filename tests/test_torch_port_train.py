"""The port's training slice against the JAX package's, on the CPU.

Everything runs at tiny width in f32 with dropout 0, on one shared weight
set (a Flax param tree moved into the port by ``mtl_tpu_torch.interop``)
and inputs drawn with numpy. Tolerances, unless a test says otherwise:
rtol = atol = 1e-5 on O(1) losses, activations and logits (f32, only the
order of the sums differs); gradients rtol 1e-4 with an atol scaled to the
largest gradient (1e-5 of it), since small entries are differences of
larger ones. The port's VGG stack runs its plain version (CPU tensors) and
JAX its XLA convs, except where a test names the fused Pallas stack, which
runs in interpret mode as tests/test_vgg_pallas.py runs it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.train.steps import make_meta_step as jax_make_meta_step
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.dataset import SpectrogramDataset
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import (adam_state_from_optax, adam_state_to_optax,
                                   flax_params_to_torch, torch_to_flax_params)
from mtl_tpu_torch.models.transformer import build_model
from mtl_tpu_torch.train.optim import Adam
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       make_meta_step)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny(cfg, factorized=False, dtype="float32", dropout=0.0):
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 2, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, dtype, dropout
    m.src_max_len, m.tgt_max_len = 64, 32
    m.is_factorized = factorized
    cfg.data.src_bucket_frames, cfg.data.tgt_bucket_len = (64,), (16,)
    t = cfg.train
    t.k_train = t.k_valid = 2
    t.lr, t.meta_lr = 1e-2, 1e-3
    return cfg.finalize()


def _port_cfg(jcfg):
    return Config.from_dict(json.loads(jcfg.to_json()))


def _flax_params(jcfg, vocab_size, seed):
    model = jax_build_model(jcfg, vocab_size)
    rng = np.random.RandomState(seed)
    params = model.init(jax.random.PRNGKey(rng.randint(2 ** 31)),
                        jnp.zeros((1, 32, jcfg.audio.num_freq), jnp.float32),
                        jnp.array([32], jnp.int32), jnp.zeros((1, 4),
                                                              jnp.int32))
    return model, jax.tree.map(np.asarray, params)


def _port_model(cfg, vocab_size, params):
    model = build_model(cfg, vocab_size)
    model.load_state_dict(flax_params_to_torch(params))
    return model


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    manifests, labels = make_synthetic_corpus(root, num_tasks=3,
                                              utts_per_task=6, max_sec=0.5,
                                              max_chars=6, seed=2)
    with open(labels, encoding="utf-8") as f:
        label_list = json.load(f)
    return manifests, JaxVocab.from_labels(label_list), \
        Vocab.from_labels(label_list)


# -- targets and masks ------------------------------------------------------

@pytest.mark.parametrize("targets", [
    [[5, 6, 7, 0], [8, 0, 0, 0]],
    [[4, 4, 4, 4], [0, 0, 0, 0]],
    [[9]],
])
def test_teacher_forcing_matches_jax(targets):
    from mtl_tpu.ops.targets import make_teacher_forcing as jax_tf
    from mtl_tpu.ops.targets import target_lengths as jax_len
    from mtl_tpu_torch.ops.targets import make_teacher_forcing, target_lengths

    t = np.asarray(targets, np.int32)
    want_in, want_out = (np.asarray(a) for a in jax_tf(jnp.asarray(t)))
    got_in, got_out = make_teacher_forcing(torch.from_numpy(t))
    np.testing.assert_array_equal(got_in.numpy(), want_in)
    np.testing.assert_array_equal(got_out.numpy(), want_out)
    np.testing.assert_array_equal(target_lengths(torch.from_numpy(t)).numpy(),
                                  np.asarray(jax_len(jnp.asarray(t))))


@pytest.mark.parametrize("name", ["non_pad_mask_from_ids", "subsequent_mask"])
def test_decoder_masks_match_jax(name):
    from mtl_tpu.ops import masks as jmasks
    from mtl_tpu_torch.ops import masks

    if name == "subsequent_mask":
        for n in (1, 2, 7):
            np.testing.assert_array_equal(masks.subsequent_mask(n).numpy(),
                                          np.asarray(jmasks.subsequent_mask(n)))
        return
    ids = np.array([[1, 5, 2, 2], [1, 2, 7, 2]], np.int32)
    np.testing.assert_array_equal(
        masks.non_pad_mask_from_ids(torch.from_numpy(ids), 2).numpy(),
        np.asarray(jmasks.non_pad_mask_from_ids(jnp.asarray(ids), 2)))


# -- teacher-forced forward ------------------------------------------------

@pytest.mark.parametrize("factorized", [False, True],
                         ids=["dense_ffn", "factorized"])
def test_teacher_forced_logits_match_jax(factorized):
    """``ASRTransformer.__call__`` (XLA convs) against the port's forward;
    row 1 has raw length 20 against 9 downsampled frames and EOS padding in
    its input, so all three decoder masks matter."""
    from mtl_tpu.ops.targets import make_teacher_forcing

    vocab = 11
    jcfg = _tiny(JaxConfig(), factorized)
    jmodel, params = _flax_params(jcfg, vocab, 5)
    model = _port_model(_port_cfg(jcfg), vocab, params)
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 36, jcfg.audio.num_freq).astype(np.float32)
    lengths = np.array([36, 20], np.int32)
    targets = np.array([[5, 6, 7, 8, 9], [4, 10, 0, 0, 0]], np.int32)
    seq_in, _ = make_teacher_forcing(jnp.asarray(targets))
    want = np.asarray(jmodel.apply(params, jnp.asarray(feats),
                                   jnp.asarray(lengths), seq_in))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(lengths),
                    torch.from_numpy(np.asarray(seq_in)))
    assert got.shape == want.shape == (2, 6, vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_ce_losses_match_jax(smoothing):
    from mtl_tpu.train import losses as jl
    from mtl_tpu_torch.train import losses

    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 5, 9) * 3).astype(np.float32)
    gold = np.array([[4, 5, 2, 0, 0], [6, 2, 0, 0, 0], [0, 0, 0, 0, 0]],
                    np.int32)
    logits[0, 1] = logits[0, 1, 5] + 1.0  # a tie for argmax: first index
    rl_j, rt_j = jl.ce_row_losses(jnp.asarray(logits), jnp.asarray(gold),
                                  smoothing=smoothing)
    rl, rt = losses.ce_row_losses(torch.from_numpy(logits),
                                  torch.from_numpy(gold), smoothing=smoothing)
    np.testing.assert_allclose(rl.numpy(), np.asarray(rl_j), **TOL)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rt_j))
    loss_j, nc_j = jl.ce_loss(jnp.asarray(logits), jnp.asarray(gold),
                              smoothing=smoothing)
    loss, nc = losses.ce_loss(torch.from_numpy(logits),
                              torch.from_numpy(gold), smoothing=smoothing)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    assert int(nc) == int(nc_j)


def test_masked_loss_guard_matches_jax():
    from mtl_tpu.train.losses import masked_loss_guard as jax_guard
    from mtl_tpu_torch.train.losses import masked_loss_guard

    for v in (1.5, np.inf, -np.inf, np.nan):
        want = float(jax_guard(jnp.float32(v)))
        assert float(masked_loss_guard(torch.tensor(v))) == want


# -- the VGG stack's autograd Function ------------------------------------

def _vgg_inputs(seed, t=32, f=13, c1=8, c2=16):
    rng = np.random.RandomState(seed)

    def mk(*s, sc=0.1):
        return (rng.randn(*s) * sc).astype(np.float32)

    x = rng.randn(2, t, f).astype(np.float32)
    w = [mk(3, 3, 1, c1), mk(c1), mk(3, 3, c1, c1), mk(c1),
         mk(3, 3, c1, c2, sc=0.2), mk(c2), mk(3, 3, c2, c2, sc=0.2), mk(c2)]
    g = rng.randn(2, t // 4, (f // 4) * c2).astype(np.float32)
    return x, w, g


def _port_vjp(x, w, g, out_dtype=torch.float32):
    from mtl_tpu_torch.ops.vgg import vgg_stack

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    y = vgg_stack(xt, wt, out_dtype=out_dtype)
    grads = torch.autograd.grad(y, [xt] + wt, torch.from_numpy(g).to(y.dtype))
    return y, [gr.numpy() for gr in grads]


def _assert_grads_close(got, want, rtol, scale):
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=scale * float(np.abs(b).max()) + 1e-30)


def test_vgg_stack_grads_match_xla_f32_vjp():
    """f32 route: the Function's forward and its recomputed VJP against
    ``jax.vjp`` of the JAX package's f32 conv subsampler
    (``FeatureExtractor("large_cnn", float32)``, XLA convs: the function
    its meta step trains at f32)."""
    from mtl_tpu.models.subsampler import FeatureExtractor

    x, w, g = _vgg_inputs(1, c1=32, c2=64)
    fe = FeatureExtractor("large_cnn", dtype=jnp.float32)

    def run(x, *w):
        convs = {f"Conv_{i}": {"kernel": w[2 * i], "bias": w[2 * i + 1]}
                 for i in range(4)}
        return fe.apply({"params": {"conv": convs}}, x)

    y_j, vjp = jax.vjp(run, jnp.asarray(x), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(g))
    y, got = _port_vjp(x, w, g)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    _assert_grads_close(got, want, rtol=1e-4, scale=1e-5)


def _reference_chain_vjp(x, w, g):
    """The port's plain blocks composed as ``vgg_stack_reference`` composes
    its blocks: f32 convs, each block's output rounded to bf16
    (mtl_tpu/ops/vgg_pallas.py:381)."""
    from mtl_tpu_torch.ops.vgg import vgg_block_plain

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    y = vgg_block_plain(xt, *wt[:4], out_dtype=torch.float32)
    y = vgg_block_plain(y.to(torch.bfloat16).float(), *wt[4:],
                        out_dtype=torch.float32).to(torch.bfloat16)
    y = y.reshape(y.shape[0], y.shape[1], -1)
    grads = torch.autograd.grad(y, [xt] + wt,
                                torch.from_numpy(g).to(torch.bfloat16))
    return y, [gr.float().numpy() for gr in grads]


def test_vgg_blocks_match_reference_stack_vjp():
    """``jax.vjp`` of ``vgg_stack_reference`` against the port's plain
    blocks with the same bf16 roundings at the block outputs (the
    reference rounds there, so it is not the f32 route's function); the
    cotangent is bf16, as the reference's output is. Tight: f32 sums in
    another order, the same roundings."""
    from mtl_tpu.ops.vgg_pallas import vgg_stack_reference

    x, w, g = _vgg_inputs(2)
    g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    y_j, vjp = jax.vjp(vgg_stack_reference, jnp.asarray(x),
                       *map(jnp.asarray, w))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    y, got = _reference_chain_vjp(x, w, g)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(y_j, np.float32))
    _assert_grads_close(got, want, rtol=1e-4, scale=1e-5)


def test_vgg_stack_grads_match_fused_pallas_vjp():
    """``fused_vgg_stack``'s custom VJP with the Pallas kernels in
    interpret mode, given an f32 cotangent that its backward rounds to
    bf16 (vgg_pallas.py:445), against the same chain as above given the
    f32 cotangent unrounded. The gradients are linear in the cotangent, so
    they differ by the VJP of its bf16 rounding error, 2^-9 of each entry:
    held to 1e-2 of the largest entry."""
    from mtl_tpu.ops import vgg_pallas as vp

    x, w, g = _vgg_inputs(3)
    old = vp.INTERPRET
    vp.INTERPRET = True
    try:
        _, vjp = jax.vjp(vp.fused_vgg_stack, jnp.asarray(x),
                         *map(jnp.asarray, w))
        want = vjp(jnp.asarray(g, jnp.bfloat16))
    finally:
        vp.INTERPRET = old
    from mtl_tpu_torch.ops.vgg import vgg_block_plain

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    y = vgg_block_plain(xt, *wt[:4], out_dtype=torch.float32)
    y = vgg_block_plain(y.to(torch.bfloat16).float(), *wt[4:],
                        out_dtype=torch.float32)
    y = y.reshape(y.shape[0], y.shape[1], -1)
    got = torch.autograd.grad(y, [xt] + wt, torch.from_numpy(g))
    _assert_grads_close([a.numpy() for a in got], want, rtol=0, scale=1e-2)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_vgg_stack_function_is_the_plain_vjp(out_dtype):
    """On the CPU the Function computes exactly autograd through the
    route's plain version (the bf16-operand form for bf16), and counts no
    launch: its backward counter belongs to the card."""
    from mtl_tpu_torch.ops import native
    from mtl_tpu_torch.ops.vgg import vgg_stack_plain

    x, w, g = _vgg_inputs(3, t=20, f=11)
    before = dict(native.launch_counts)
    y, got = _port_vjp(x, w, g, out_dtype)
    assert native.launch_counts == before
    xt = torch.from_numpy(x)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    y_ref = vgg_stack_plain(xt.requires_grad_(True), wt, out_dtype)
    want = torch.autograd.grad(y_ref, [xt] + wt,
                               torch.from_numpy(g).to(y_ref.dtype))
    assert y.dtype == out_dtype
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def test_vgg_stack_skips_the_input_gradient():
    """Features need no gradient: the backward leaves x's out."""
    from mtl_tpu_torch.ops.vgg import vgg_stack

    x, w, g = _vgg_inputs(4, t=16, f=9)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    xt = torch.from_numpy(x)
    y = vgg_stack(xt, wt, out_dtype=torch.float32)
    (y * torch.from_numpy(g)).sum().backward()
    assert xt.grad is None and all(t.grad is not None for t in wt)


# -- dropout ---------------------------------------------------------------

def test_dropout_seeded_masks_and_identity():
    from mtl_tpu_torch.models.layers import dropout

    x = torch.ones(64, 128)
    a = dropout(x, 0.25, torch.Generator().manual_seed(7))
    b = dropout(x, 0.25, torch.Generator().manual_seed(7))
    c = dropout(x, 0.25, torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    kept = a != 0
    # flax's scaling: kept elements are x / (1 - rate)
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert 0.2 < 1 - kept.float().mean().item() < 0.3  # 8192 draws
    assert dropout(x, 0.25, None) is x
    assert dropout(x, 0.0, torch.Generator()) is x


def test_model_dropout_draws_from_generator_and_eval_is_identity():
    cfg = _tiny(Config(), dropout=0.3)
    model = build_model(cfg, 11)
    rng = np.random.RandomState(0)
    args = (torch.from_numpy(rng.randn(2, 16, 161).astype(np.float32)),
            torch.tensor([16, 10]), torch.tensor([[1, 5, 6], [1, 7, 2]]))
    with torch.no_grad():
        det = model(*args)
        det2 = model(*args, deterministic=True,
                     generator=torch.Generator().manual_seed(0))
        d1 = model(*args, deterministic=False,
                   generator=torch.Generator().manual_seed(4))
        d2 = model(*args, deterministic=False,
                   generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(det, det2, rtol=0, atol=0)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    assert not torch.allclose(d1, det)
    with pytest.raises(ValueError, match="generator"):
        model(*args, deterministic=False)


# -- f32 master parameters -------------------------------------------------

def test_bf16_meta_step_updates_f32_master_params(corpus):
    """At bf16 compute, one meta step at meta_lr 1e-6 moves every weight by
    about 1e-6, far below one bf16 ulp of weights of size ~0.1 (2^-10):
    stored in bf16 the update would round away; the f32 masters move."""
    manifests, jvocab, vocab = corpus
    cfg = _tiny(Config(), dtype="bfloat16")
    cfg.train.meta_lr = 1e-6
    model = build_model(cfg, len(vocab))
    from mtl_tpu_torch.models.transformer import init_weights

    init_weights(model, torch.Generator().manual_seed(0))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=0)
    support, query = ds.sample_meta_batch(2, 2)
    opt = Adam(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_meta_step(model, cfg, opt)
    step(state, batch_to_device(support, torch.device("cpu")),
         batch_to_device(query, torch.device("cpu")))
    w0 = before["encoder.layers.0.self_attn.query_linear.a.weight"]
    w1 = state.params["encoder.layers.0.self_attn.query_linear.a.weight"]
    delta = (w1 - w0).abs()
    big = w0.abs() > 0.1  # one bf16 ulp there is >= 2^-10
    assert bool((delta[big] > 0).any())
    assert float(delta.max()) < 2e-6 < 2.0 ** -10
    # the same update applied to bf16 storage is lost
    assert torch.equal((w0 + (w1 - w0)).to(torch.bfloat16)[big],
                       w0.to(torch.bfloat16)[big])


def test_serving_copy_computes_the_same_function():
    """Decoding with the linear weights cast to bf16 once gives exactly the
    values of the per-call casts of the f32 masters (flax's cast)."""
    from mtl_tpu_torch.models.transformer import init_weights, serving_copy

    cfg = _tiny(Config(), dtype="bfloat16")
    model = build_model(cfg, 11)
    init_weights(model, torch.Generator().manual_seed(1))
    feats = torch.from_numpy(
        np.random.RandomState(0).randn(2, 24, 161).astype(np.float32))
    lengths = torch.tensor([24, 14])

    def run():
        with torch.no_grad():
            _, kvs = model.prepare_decode(feats, lengths)
            caches = model.init_cache(2, 4, torch.device("cpu"))
            y = torch.tensor([1, 1])
            return [model.decode_step(y, t, kvs, caches)[0]
                    for t in range(3)]

    want = run()
    serving_copy(model)
    assert model.decoder.output_linear.weight.dtype == torch.bfloat16
    assert model.conv.convs[0].kernel.dtype == torch.float32
    for a, b in zip(run(), want):
        assert torch.equal(a, b)


# -- Adam and its interop ---------------------------------------------------

def test_adam_matches_optax_and_state_round_trips():
    """Three updates of the port's Adam against ``optax.adam`` from the
    same params and gradients (f32; the moments agree to rounding); then
    the state moves to optax's layout and back unchanged."""
    rng = np.random.RandomState(0)
    params = {"params": {"encoder": {"layers_0": {"w": {
        "kernel": rng.randn(4, 3).astype(np.float32),
        "bias": rng.randn(3).astype(np.float32)}}}}}
    tx = optax.adam(1e-3)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = tx.init(jp)
    port = flax_params_to_torch(params)
    opt = Adam(1e-3)
    state = opt.init(port)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.randn(*a.shape) * 10 ** -i)
                         .astype(np.float32), params)
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(flax_params_to_torch(g), state, port)
    for k, v in flax_params_to_torch(jax.tree.map(np.asarray, jp)).items():
        torch.testing.assert_close(port[k], v, rtol=1e-6, atol=1e-7)
    adam = js[0]
    mu, nu, count = adam_state_to_optax(state)
    assert int(count) == int(adam.count) == 3
    for a, b in ((mu, adam.mu), (nu, adam.nu)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=0)
    back = adam_state_from_optax(mu, nu, count)
    assert back.count == 3
    for k in state.mu:
        assert torch.equal(back.mu[k], state.mu[k])
        assert torch.equal(back.nu[k], state.nu[k])


# -- the first-order meta step ---------------------------------------------

class _Recorder:
    """An outer 'optimizer' that keeps the outer gradients and changes
    nothing: the step's gradients, read out on both sides."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in grads.items()}
        return state


def _jax_recorder():
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _meta_params(jcfg, vocab_size):
    """Shared weights for the meta-step tests, with conv biases drawn
    nonzero: at flax's zero init the zeroed padded frames give convs
    pre-activations that cancel to ~1e-8 at the edge of the padding, whose
    ReLU side (and so the conv gradients) depends on the order of an f32
    sum; trained biases are not zero."""
    jmodel, params = _flax_params(jcfg, vocab_size, 9)
    rng = np.random.RandomState(0)
    convs = params["params"]["conv"]["conv"]
    for conv in convs.values():
        conv["bias"] = (rng.randn(*conv["bias"].shape) * 0.1).astype(
            np.float32)
    return jmodel, params


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
def test_meta_step_matches_jax(corpus, clip):
    """Three meta steps on three meta batches (3 tasks, raw audio through
    the STFT), with and without ``--clip`` (max_norm 0.5, so both the inner
    and the outer clip scale).

    * The outer gradients of the first step, read by an outer 'optimizer'
      that records them on both sides: atol 3e-4 of the largest (the f32
      sums of the conv gradients run over ~1e4 products in other orders).
    * Each step starts both sides from the JAX state before it (params and
      Adam state through ``interop``): outer loss and support losses to
      1e-5; after the Adam update, the params to 1e-2 meta_lr wherever
      Adam's second moment is above 1e-3 of its largest. Below that the
      gradient entries are at the level of f32 rounding, and Adam, which
      divides each entry by its own size, moves them by up to meta_lr
      either way on both sides; every entry is held to 2 meta_lr."""
    manifests, jvocab, vocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.clip, jcfg.train.max_norm = clip, 0.5
    cfg = _port_cfg(jcfg)
    jmodel, params = _meta_params(jcfg, len(vocab))
    ds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=4)
    batches = [ds.sample_meta_batch(2, 2) for _ in range(3)]
    cpu = torch.device("cpu")

    rec = _jax_recorder()
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=rec.init(params))
    st, _ = jax_make_meta_step(jmodel, jcfg, rec)(st, *batches[0],
                                                  jax.random.PRNGKey(0))
    want_g = flax_params_to_torch(jax.tree.map(np.asarray, st.opt_state))
    model = _port_model(cfg, len(vocab), params)
    recorder = _Recorder()
    make_meta_step(model, cfg, recorder)(
        init_train_state(model, Adam(1.0)), batch_to_device(batches[0][0], cpu),
        batch_to_device(batches[0][1], cpu))
    scale = max(float(v.abs().max()) for v in want_g.values())
    for k, v in want_g.items():
        torch.testing.assert_close(recorder.grads[k], v, rtol=1e-4,
                                   atol=3e-4 * scale)

    lr = jcfg.train.meta_lr
    tx = optax.adam(lr)
    jstep = jax_make_meta_step(jmodel, jcfg, tx)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    model = _port_model(cfg, len(vocab), params)
    opt = Adam(lr)
    state = init_train_state(model, opt)
    step = make_meta_step(model, cfg, opt)
    for i, (sup, qry) in enumerate(batches):
        adam = jax.tree.map(np.asarray, st.opt_state[0])
        with torch.no_grad():
            for k, v in flax_params_to_torch(
                    jax.tree.map(np.asarray, st.params)).items():
                state.params[k].copy_(v)
        state.opt_state = adam_state_from_optax(adam.mu, adam.nu, adam.count)
        st, mj = jstep(st, sup, qry, jax.random.PRNGKey(i))
        state, m = step(state, batch_to_device(sup, cpu),
                        batch_to_device(qry, cpu))
        np.testing.assert_allclose(float(m["outer_loss"]),
                                   float(mj["outer_loss"]), **TOL)
        np.testing.assert_allclose(m["support_losses"].numpy(),
                                   np.asarray(mj["support_losses"]), **TOL)
        np.testing.assert_array_equal(m["support_gold"].numpy(),
                                      np.asarray(mj["support_gold"]))
        assert state.step == i + 1 and int(st.step) == 1 + i
        assert state.opt_state.count == i + 1
        want = flax_params_to_torch(jax.tree.map(np.asarray, st.params))
        nu = flax_params_to_torch(jax.tree.map(np.asarray,
                                               st.opt_state[0].nu))
        rms = {k: torch.sqrt(v / (1 - 0.999 ** (i + 1))) for k, v in nu.items()}
        top = max(float(v.max()) for v in rms.values())
        for k, v in want.items():
            d = (state.params[k].detach() - v).abs()
            sure = rms[k] > 1e-3 * top
            assert float(d.max()) <= 2 * lr, k
            assert not sure.any() or float(d[sure].max()) <= 1e-2 * lr, k


def test_interop_train_state_round_trip(corpus):
    """A JAX TrainState after one Adam meta step -> port (params + Adam
    state) -> back: identical trees."""
    manifests, jvocab, vocab = corpus
    jcfg = _tiny(JaxConfig())
    jmodel, params = _flax_params(jcfg, len(vocab), 3)
    tx = optax.adam(jcfg.train.meta_lr)
    ds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=1)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    st, _ = jax_make_meta_step(jmodel, jcfg, tx)(
        st, *ds.sample_meta_batch(2, 2), jax.random.PRNGKey(0))
    adam = jax.tree.map(np.asarray, st.opt_state[0])
    sd = flax_params_to_torch(jax.tree.map(np.asarray, st.params))
    port = adam_state_from_optax(adam.mu, adam.nu, adam.count)
    assert port.count == 1 and set(port.mu) == set(sd)
    mu, nu, count = adam_state_to_optax(port)
    for a, b in ((torch_to_flax_params(sd), st.params), (mu, adam.mu),
                 (nu, adam.nu)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (_, x), (_, y) in zip(fa, fb):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert int(count) == 1


# -- data ------------------------------------------------------------------

def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("partitions", [None, [0.5, 1.0, 0.4]])
def test_sample_meta_batch_matches_jax(corpus, partitions):
    manifests, jvocab, vocab = corpus
    jcfg = _tiny(JaxConfig())
    jds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=13,
                     partitions=partitions)
    ds = SpectrogramDataset(vocab, _port_cfg(jcfg), manifests, is_train=True,
                            seed=13, partitions=partitions)
    assert len(ds) == len(jds)
    for k_train, k_valid in ((2, 2), (3, 1), (2, 2)):
        s_j, q_j = jds.sample_meta_batch(k_train, k_valid)
        s, q = ds.sample_meta_batch(k_train, k_valid)
        assert s["audio"].shape[:2] == (3, k_train)
        _assert_batches_equal(s, s_j)
        _assert_batches_equal(q, q_j)
    for i in (0, 1, 5, 17):
        w, t = ds[i]
        w_j, t_j = jds[i]
        np.testing.assert_array_equal(w, w_j)
        assert t == t_j


def test_trainer_draws_the_jax_stream(corpus, tmp_path, monkeypatch):
    """The port's trainer draws one meta batch before it builds its state
    (as the JAX trainer does for init_train_state) and only then starts
    the prefetch thread: its iterations see the JAX stream's draws 2, 3."""
    from mtl_tpu_torch.train.trainer import TransientTrainer

    monkeypatch.chdir(tmp_path)
    manifests, jvocab, vocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.evaluate_every = 1000
    cfg = _port_cfg(jcfg)
    cfg.device = "cpu"
    jds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=21)
    want = [jds.sample_meta_batch(2, 2) for _ in range(3)]
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=21)
    drawn = []
    real = ds.sample_meta_batch

    def record(*a, **kw):
        out = real(*a, **kw)
        drawn.append(out)
        return out

    monkeypatch.setattr(ds, "sample_meta_batch", record)
    seen = []
    import mtl_tpu_torch.train.trainer as trainer_mod

    real_to_device = trainer_mod.batch_to_device

    def spy(batch, device):
        seen.append(batch)
        return real_to_device(batch, device)

    monkeypatch.setattr(trainer_mod, "batch_to_device", spy)
    model = build_model(cfg, len(vocab))
    TransientTrainer(model, cfg, vocab, torch.device("cpu")).train(
        ds, [], num_it=2)
    for (s, q), (s_j, q_j) in zip(drawn[:3], want):
        _assert_batches_equal(s, s_j)
        _assert_batches_equal(q, q_j)
    # iterations 1 and 2 trained on draws 2 and 3 (support, query each)
    _assert_batches_equal(seen[0], want[1][0])
    _assert_batches_equal(seen[2], want[2][0])


# -- trainer pieces --------------------------------------------------------

def test_prefetcher_reraises_and_stops():
    import threading

    from mtl_tpu_torch.train.trainer import Prefetcher

    calls = []

    def fetch():
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk")
        return len(calls)

    p = Prefetcher(fetch)
    assert p.get() == 1
    with pytest.raises(OSError, match="disk"):
        p.get()
    assert p.get() == 3
    p.stop()
    assert p._thread is None
    assert len(calls) == 4  # the fetch armed by the last get ran and ended
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t is not threading.main_thread()
                   and t.name.startswith("Thread-") and t.daemon)


def test_early_stopper_parity():
    from mtl_tpu.train.trainer import EarlyStopper as JaxStopper
    from mtl_tpu_torch.train.trainer import EarlyStopper

    for spec in ("loss,2", "cer,1"):
        a, b = EarlyStopper(spec), JaxStopper(spec)
        for loss, cer in ((3.0, 50.0), (2.0, 60.0), (2.5, 40.0), (2.6, 45.0),
                          (2.7, 41.0)):
            assert a.update(loss, cer) == b.update(loss, cer)
            assert (a.count, a.should_stop) == (b.count, b.should_stop)


@pytest.mark.parametrize("flag,value", [
    ("train.prefetch_workers", 2), ("train.device_cer", True),
    ("train.profile_dir", "/x"), ("train.second_order", True),
    ("model.remat", True), ("model.remat_conv", True),
    ("mesh.data", 2), ("mesh.task", 2), ("mesh.model", 2)])
def test_ported_training_options_are_accepted(flag, value):
    """The options refused until the training-options slice, the
    second-order slice, the mesh slice and the tensor-parallel slice
    build a trainer now (their behaviour: tests/test_torch_port_options.py,
    test_torch_port_second_order.py, test_torch_port_conformer.py,
    test_torch_port_mesh.py and test_torch_port_tp.py)."""
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.train.trainer import TransientTrainer
    from mtl_tpu_torch.data.vocab import Vocab

    cfg = Config()
    m = cfg.model
    m.num_enc_layers = m.num_dec_layers = 1
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.num_heads, m.dim_key, m.dim_value, m.r = 2, 8, 8, 4
    group, name = flag.split(".")
    setattr(getattr(cfg, group), name, value)
    vocab = Vocab.from_dict({"labels": ["_", "a", "b"]})
    trainer = TransientTrainer(build_model(cfg, len(vocab)), cfg, vocab,
                               torch.device("cpu"))
    assert trainer.cfg is cfg and trainer.evaluates


def test_batch_cer_matches_jax(corpus):
    from mtl_tpu.train.trainer import batch_cer as jax_batch_cer
    from mtl_tpu_torch.train.trainer import batch_cer

    _, jvocab, vocab = corpus
    rng = np.random.RandomState(0)
    hyp = rng.randint(0, len(vocab), (2, 3, 7))
    gold = rng.randint(0, len(vocab), (2, 3, 7))
    assert batch_cer(hyp, gold, vocab) == jax_batch_cer(hyp, gold, jvocab)
