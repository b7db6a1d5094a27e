"""The port's fused VGG blocks against the JAX package's.

On CPU tensors ``vgg_block1`` / ``vgg_block2`` / ``vgg_stack`` run their
plain versions (the CUDA kernels are held against those on the card, in
tests/test_torch_port_cuda.py and chip_smoke.py). ``out_dtype`` picks the
function, as it picks the kernel route on the card:

* f32: f32 convs. Held against the Pallas kernels in interpret mode
  (``vgg_block_forward_pallas(..., interpret=True)``) to 1e-4 (f32
  summation order).
* bf16: every conv operand (x, w1, the conv-1 activation, w2) rounded to
  bf16, f32 sums, bias and ReLU in f32, one rounding of the output. Held
  against the JAX package's bf16 path, flax ``nn.Conv(dtype=bfloat16)``
  (``_VGGBlockStack`` / ``FeatureExtractor(dtype=bfloat16, fused=False)``),
  which takes the same bf16 operands but rounds each conv's output to bf16
  before adding a bf16-rounded bias and rounds that sum again. So the two
  conv-1 activations differ by a rounding or two at a fraction of the
  positions, and those differences add up in conv 2 in proportion to the
  sum of its terms, not to the output element: the tolerance is one bf16
  ulp of the element plus one at the tensor's largest value,
  |d| <= 2^-7 |flax| + 2^-7 max|flax| (the cases here need under half of
  it).

Shapes follow tests/test_vgg_pallas.py: odd F, several time tiles,
C_in = 1 and C_in > 1, T != F and random (non-symmetric) weights so that a
swapped f/t axis fails; the vgg_cnn and large_cnn widths run through
``FeatureExtractor``. The tensor-core kernels' weight packing is checked
here too, by running the kernels' implicit GEMMs slice by slice on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtl_tpu.models.subsampler import FeatureExtractor, _VGGBlockStack
from mtl_tpu.ops import vgg_pallas as vp
from mtl_tpu_torch.ops.vgg import (pack_block1_tc, pack_block2_tc,
                                   vgg_block1, vgg_block2, vgg_block_plain,
                                   vgg_stack)
from tests.torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, t, f, c_in, c, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    shape = (b, t, f) if c_in == 1 else (b, t, f, c_in)
    return [rng.randn(*shape).astype(np.float32),
            (rng.randn(3, 3, c_in, c) * scale).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(3, 3, c, c) * scale / np.sqrt(c)).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32)]


def _port(arrs, out_dtype=torch.float32):
    x, *w = (torch.from_numpy(a) for a in arrs)
    fn = vgg_block1 if x.dim() == 3 else vgg_block2
    return fn(x, *w, out_dtype=out_dtype)


@pytest.mark.parametrize("b,t,f,c_in,c", [
    (2, 32, 13, 1, 8),    # odd F, single tile, C_in = 1 (block 1)
    (1, 64, 21, 8, 16),   # C_in > 1 (block 2)
    (2, 256, 9, 1, 8),    # several time tiles (halo)
    (1, 128, 11, 8, 16),  # several tiles, C_in > 1
])
def test_block_matches_pallas_interpret(b, t, f, c_in, c):
    """Block 2's Pallas kernel takes bf16 activations (it casts its input),
    so its input here is bf16-representable; weights stay f32 on both
    sides."""
    arrs = _inputs(b, t, f, c_in, c)
    if c_in > 1:
        arrs[0] = torch.from_numpy(arrs[0]).bfloat16().float().numpy()
    want = np.asarray(vp.vgg_block_forward_pallas(
        *map(jnp.asarray, arrs), interpret=True, out_dtype=jnp.float32))
    got = _port(arrs)
    assert got.shape == want.shape == (b, t // 2, f // 2, c)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _close_to_flax(got, want):
    """|d| <= 2^-7 |want| + 2^-7 max|want| (see the module note)."""
    got = got.float().numpy()
    d = np.abs(got - want)
    tol = 2.0 ** -7 * (np.abs(want) + np.abs(want).max())
    assert (d <= tol).all(), (float(d.max()), float((d / tol).max()))


def _flax_block(arrs, channels):
    """flax bf16 conv blocks (the JAX package's default, non-fused path) on
    [B, T, F(, C_in)] -> [B, T', F', C], weights HWIO with H = freq."""
    x, *ws = arrs
    if x.ndim == 3:
        x = x[..., None]
    params = {f"Conv_{i}": {"kernel": jnp.asarray(ws[2 * i]),
                            "bias": jnp.asarray(ws[2 * i + 1])}
              for i in range(len(ws) // 2)}
    y = _VGGBlockStack(tuple(channels), dtype=jnp.bfloat16).apply(
        {"params": params},
        jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)).astype(jnp.bfloat16))
    return np.asarray(jnp.transpose(y, (0, 2, 1, 3)), np.float32)


@pytest.mark.parametrize("b,t,f,c_in,c", [
    (2, 32, 13, 1, 8),
    (1, 64, 21, 8, 16),
    (2, 37, 13, 1, 8),    # T not a multiple of 16 (odd, floored)
    (1, 24, 15, 8, 16),   # T = 8 mod 16: the JAX fused path would fall back
])
def test_block_matches_reference_bf16(b, t, f, c_in, c):
    """bf16 output (the model's compute dtype at the flagship), any T. The
    port's bf16 function rounds every conv operand to bf16, so it is held
    against the JAX function with bf16 operands, flax's bf16 conv block,
    and no longer against ``vgg_block_reference``, whose convs take f32
    operands (their difference is the bf16 rounding of x, the weights and
    the conv-1 activation, up to 0.03 at these shapes)."""
    arrs = _inputs(b, t, f, c_in, c, seed=1)
    want = _flax_block(arrs, (c,))
    got = _port(arrs, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (b, t // 2, f // 2, c)
    _close_to_flax(got, want)


def test_weight_axes_are_freq_time():
    """HWIO with H = freq, W = time: a kernel that is nonzero only at
    (f-offset -1, t-offset 0) shifts along freq, not time."""
    x = np.zeros((1, 6, 8), np.float32)
    x[0, 2, 5] = 1.0
    w1 = np.zeros((3, 3, 1, 1), np.float32)
    w1[0, 1, 0, 0] = 1.0  # f - 1 tap at dt = 0: y[t, f] = x[t, f - 1]
    eye = np.zeros((3, 3, 1, 1), np.float32)
    eye[1, 1, 0, 0] = 1.0
    zero = np.zeros(1, np.float32)
    y = _port([x, w1, zero, eye, zero]).numpy()[0, :, :, 0]
    want = np.asarray(vp.vgg_block_reference(
        *map(jnp.asarray, [x, w1, zero, eye, zero])), np.float32)[0, :, :, 0]
    np.testing.assert_array_equal(y, want)
    assert y[1, 3] == 1.0 and y.sum() == 1.0  # pooled (t=2, f=6) -> (1, 3)


def test_stack_matches_reference():
    """Both blocks with (f, c) f-major flattening, as fused_vgg_stack and
    FeatureExtractor lay it out; bf16 like the flagship, so held against
    flax's bf16 conv stack (the JAX function with bf16 operands; see
    test_block_matches_reference_bf16)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 13).astype(np.float32)
    ws = [(rng.randn(*s) * sc).astype(np.float32)
          for s, sc in (((3, 3, 1, 8), 0.3), ((8,), 0.1), ((3, 3, 8, 8), 0.2),
                        ((8,), 0.1), ((3, 3, 8, 16), 0.2), ((16,), 0.1),
                        ((3, 3, 16, 16), 0.2), ((16,), 0.1))]
    want = _flax_block([x] + ws, (8, 16)).reshape(2, 8, 3 * 16)
    got = vgg_stack(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                    out_dtype=torch.bfloat16)
    assert got.shape == want.shape == (2, 8, 3 * 16)
    _close_to_flax(got, want)


def _stack_weights(channels, seed):
    """He-scaled random conv weights for the stack, flax tree and list."""
    rng = np.random.RandomState(seed)
    ws, tree, c_in = [], {}, 1
    for i, c in enumerate(ch for ch in channels for _ in "xx"):
        k = (rng.randn(3, 3, c_in, c) * np.sqrt(2.0 / (9 * c_in))).astype(
            np.float32)
        bias = (rng.randn(c) * 0.1).astype(np.float32)
        ws += [k, bias]
        tree[f"Conv_{i}"] = {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)}
        c_in = c
    return ws, tree


@pytest.mark.parametrize("feat,channels,b,t,f", [
    ("vgg_cnn", (64, 128), 2, 20, 13),
    ("vgg_cnn", (64, 128), 1, 37, 19),    # odd T and F
    ("large_cnn", (32, 64), 2, 24, 17),
])
def test_stack_matches_flax_feature_extractor_bf16(feat, channels, b, t, f):
    """The bf16 plain version through ``vgg_stack`` against the JAX
    package's default bf16 subsampler, ``FeatureExtractor(dtype=bfloat16,
    fused=False)``, at the model's widths; the flax tree's conv/Conv_{i}
    is the port's convs.{i}."""
    ws, tree = _stack_weights(channels, seed=t + f)
    x = np.random.RandomState(t).randn(b, t, f).astype(np.float32)
    want = np.asarray(FeatureExtractor(
        feat_extractor=feat, dtype=jnp.bfloat16, fused=False).apply(
            {"params": {"conv": tree}}, jnp.asarray(x)), np.float32)
    got = vgg_stack(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (b, t // 4, (f // 4) * channels[1])
    _close_to_flax(got, want)


@pytest.mark.parametrize("block,c_in,c", [(1, 1, 64), (1, 1, 32),
                                          (2, 64, 128), (2, 32, 64)])
def test_block_matches_flax_bf16_widths(block, c_in, c):
    """Each block alone at the vgg_cnn and large_cnn widths against flax's
    bf16 conv block; block 2 takes bf16 input, as on the served path."""
    arrs = _inputs(1, 22, 15, c_in, c, seed=c, scale=np.sqrt(2.0 / c_in))
    if block == 2:
        arrs[0] = np.maximum(arrs[0], 0).astype(jnp.bfloat16).astype(
            np.float32)
    x, *w = (torch.from_numpy(a) for a in arrs)
    if block == 2:
        x = x.bfloat16()
    got = (vgg_block1 if block == 1 else vgg_block2)(
        x, *w, out_dtype=torch.bfloat16)
    want = _flax_block(arrs, (c,))
    assert got.shape == want.shape == (1, 11, 7, c)
    _close_to_flax(got, want)


def _taps_conv(y, w, b):
    """SAME 3x3 conv as the kernels run it: sum over taps (dt, df) of the
    shifted [B, T, F, K] window @ w[dt*3 + df] [K, N], + b, ReLU."""
    t, f = y.shape[1], y.shape[2]
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    acc = sum(yp[:, dt:dt + t, df:df + f] @ w[dt * 3 + df]
              for dt in range(3) for df in range(3))
    return torch.relu(acc + b)


def _pool_bf16(y):
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return y.to(torch.bfloat16)


def _from_core_matrices(m, n, k):
    """Core matrices [n/8][k/8][8][8] (any leading shape) -> [-1, n, k]."""
    return m.reshape(-1, n // 8, k // 8, 8, 8).transpose(-3, -2).reshape(
        -1, n, k)


@pytest.mark.parametrize("block,c_in,c", [(1, 1, 64), (1, 1, 32),
                                          (2, 64, 128), (2, 32, 64)])
def test_tc_weight_packing(block, c_in, c):
    """The B operands that the tensor-core kernels read: unpack them as the
    kernels do (block 1: w1 [9][C], w2 per tap [n][k] as 8 x 8 core
    matrices; block 2: 18 conv-1 slices (half, tap) then 9 * C/64 conv-2
    slices (tap, k chunk), each [n][k] as core matrices) and run the
    implicit GEMMs tap by tap; the result must be the bf16-operand plain
    version up to f32 summation order (one bf16 ulp of the output,
    |d| <= 2^-7 |plain| + 2^-10, as on the card)."""
    arrs = _inputs(2, 14, 11, c_in, c, seed=5, scale=np.sqrt(2.0 / c_in))
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in arrs)
    xq = x.bfloat16().float()
    if block == 1:
        w1p, w2p = pack_block1_tc(w1, w2)
        assert w1p.dtype == w2p.dtype == torch.bfloat16
        assert w1p.shape == (9, c) and w2p.numel() == 9 * c * c
        y1 = _taps_conv(xq[..., None], w1p.float()[:, None, :], b1)
        w2t = _from_core_matrices(w2p.float(), c, c).transpose(1, 2)
    else:
        wp = pack_block2_tc(w1, w2).float()
        kch, nh = c // 64, c // 2
        assert wp.shape[0] == 18 + 9 * kch
        w1t = torch.zeros(9, c_in, c)
        for h in range(2):
            for tap in range(9):
                m = _from_core_matrices(wp[h * 9 + tap, :nh * c_in], nh,
                                        c_in)[0]
                w1t[tap, :, h * nh:(h + 1) * nh] = m.T
        w2t = torch.zeros(9, c, c)
        for tap in range(9):
            for k in range(kch):
                m = _from_core_matrices(wp[18 + tap * kch + k, :c * 64], c,
                                        64)[0]
                w2t[tap, k * 64:(k + 1) * 64] = m.T
        y1 = _taps_conv(xq, w1t, b1)
    got = _pool_bf16(_taps_conv(y1.bfloat16().float(), w2t, b2))
    ref = vgg_block_plain(x, w1, b1, w2, b2, out_dtype=torch.bfloat16)
    err = (got.float() - ref.float()).abs()
    assert got.shape == ref.shape
    assert bool((err <= 2.0 ** -7 * ref.float().abs() + 2.0 ** -10).all())


def test_plain_block_routes_a_tied_max_as_flax():
    """A 2 x 2 window whose maximum is tied: the plain version's gradient
    goes to the element flax's max_pool picks (the first in (freq, time)
    order), as the JAX package's VJP does. Convs that pass their input
    through (centre tap 1, bias 0) keep the planted ties."""
    import jax

    x = np.zeros((1, 4, 4), np.float32)  # [B, T, F]
    x[0, 1, 0] = x[0, 0, 1] = 1.0  # tie at (t1, f0) and (t0, f1)
    x[0, 2, 2] = x[0, 3, 3] = x[0, 3, 2] = 2.0  # a three-way tie
    w1 = np.zeros((3, 3, 1, 1), np.float32)
    w1[1, 1] = 1.0
    b = np.zeros(1, np.float32)
    seed = np.arange(1, 5, dtype=np.float32).reshape(1, 2, 2, 1)

    def flax_out(x_):
        params = {f"Conv_{i}": {"kernel": jnp.asarray(w1),
                                "bias": jnp.asarray(b)} for i in range(2)}
        y = _VGGBlockStack((1,), dtype=jnp.float32).apply(
            {"params": params}, jnp.transpose(x_, (0, 2, 1))[..., None])
        return (jnp.transpose(y, (0, 2, 1, 3)) * seed).sum()

    want = np.asarray(jax.grad(flax_out)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    w, bt = torch.from_numpy(w1), torch.from_numpy(b)
    y = vgg_block_plain(xt, w, bt, w, bt, out_dtype=torch.float32)
    (y * torch.from_numpy(seed)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert want[0, 1, 0] == 1.0 and want[0, 0, 1] == 0.0
