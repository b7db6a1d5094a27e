"""The 3xTF32 building block of the port's f32 tensor-core kernels, on the
CPU (``mtl_tpu_torch/ops/tf32.py``, ``csrc/tf32x3.cuh``).

* ``split_tf32`` against a numpy reference of ``cvt.rna.tf32.f32`` written
  apart from it (float64 arithmetic, not bit tricks): ties away from zero,
  both signs, subnormals, the largest finite values, inf and nan; hi + lo
  recovers a finite x to within 2^-22 relative.
* The packed B operands unpack (out of their core matrices, in the
  kernels' order) to the split of ``dft_matrices`` (hi, lo) and to the
  HWIO weights (f32: the VGG kernels split them themselves), zeros in the
  padding.
* A torch emulation of what the kernels compute: every product in three
  passes of split operands (lo.hi + hi.lo + hi.hi; tf32 x tf32 products are
  exact in f32, sums in f32), from the packed operands in the kernels'
  order: the direct STFT at n_fft 441 (and 320, 882), a small block 2
  (both (C_in, C) pairs) and a small block 1 (C 64 and 32; conv 1 in f32,
  conv 2 in three passes), against float64. The error stays inside the f32
  routes' 1e-4 (phase 3's tolerance); one pass (hi.hi alone) misses it, on
  the small bins of log1p(|X|) for the STFT. The block-1 emulation is also
  held to the JAX package's ``vgg_block1_fused`` in interpret mode (1e-4).

The kernels themselves run only on the card (tests/test_torch_port_cuda.py);
``cli/tf32_ablation.py``'s text variants are checked to apply here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtl_tpu.ops import vgg_pallas as vp
from mtl_tpu_torch.ops.stft import (dft_matrices, dft_tc_shape,
                                    frames_from_prepadded, pack_dft_tc)
from mtl_tpu_torch.ops.tf32 import (core_matrices_tf32, split_tf32,
                                    tf32_round)
from mtl_tpu_torch.ops.vgg import pack_block1_f32tc, pack_block2_f32tc
from tests.torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 in float64 arithmetic: round |x| to 11 significant
    bits (the subnormal grid below 2^-126 stays 2^-136), half away from
    zero; inf and nan unchanged."""
    x = x.astype(np.float64)
    out = x.copy()
    fin = np.isfinite(x) & (x != 0)
    a = np.abs(x[fin])
    e = np.floor(np.log2(a))
    # log2 may round at a power of two's edge: fix the exponent exactly
    e = np.where(2.0 ** e > a, e - 1, e)
    e = np.where(2.0 ** (e + 1) <= a, e + 1, e)
    step = 2.0 ** np.maximum(e - 10, -136.0)
    out[fin] = np.sign(x[fin]) * np.floor(a / step + 0.5) * step
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32).view(np.int32)


def _values() -> np.ndarray:
    rng = np.random.RandomState(0)
    normal = (rng.randn(4000) * 10.0 ** rng.uniform(-30, 30, 4000))
    normal = normal.astype(np.float32)
    # exact ties: low 13 bits 0x1000, both signs, and one ulp either side
    base = _bits(rng.randn(300).astype(np.float32)) & ~0x1FFF
    ties = np.concatenate([base | 0x1000, (base | 0x1000) - 1,
                           (base | 0x1000) + 1]).view(np.float32)
    # subnormals: exponent bits 0, random mantissas, both signs
    sub = (rng.randint(1, 1 << 23, 600).astype(np.int32)
           | (rng.randint(0, 2, 600).astype(np.int32) << 31)).view(np.float32)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -126, -(2.0 ** -126),
                     np.finfo(np.float32).max, -np.finfo(np.float32).max,
                     np.float32(np.finfo(np.float32).max) * np.float32(0.999),
                     np.inf, -np.inf, np.nan], dtype=np.float32)
    return np.concatenate([normal, ties, sub, edge]).astype(np.float32)


def test_tf32_round_matches_cvt_rna_reference():
    x = _values()
    got = tf32_round(torch.from_numpy(x)).numpy()
    want = _rna_reference(x)
    fin = np.isfinite(x)
    np.testing.assert_array_equal(_bits(got[fin]), _bits(want[fin]))
    assert not (_bits(got[fin]) & 0x1FFF).any()
    # ties went away from zero: |got| > |x| exactly at the 0x1000 ties
    tie = fin & ((_bits(x) & 0x1FFF) == 0x1000)
    assert tie.sum() >= 300 and (np.abs(got[tie]) > np.abs(x[tie])).all()
    # inf and nan pass through; FLT_MAX rounds up to inf, as cvt.rna does
    np.testing.assert_array_equal(got[np.isinf(x)], x[np.isinf(x)])
    assert np.isnan(got[np.isnan(x)]).all()
    assert np.isinf(got[np.abs(x) == np.finfo(np.float32).max]).all()


def test_split_recovers_x():
    x = _values()
    hi, lo = (t.numpy() for t in split_tf32(torch.from_numpy(x)))
    np.testing.assert_array_equal(_bits(hi), _bits(tf32_round(
        torch.from_numpy(x)).numpy()))
    assert not (_bits(lo) & 0x1FFF).any()
    ok = np.isfinite(hi)
    # lo is the rounded remainder: x - hi is exact in f32
    np.testing.assert_array_equal(_bits(lo[ok]), _bits(_rna_reference(
        (x[ok].astype(np.float64) - hi[ok]).astype(np.float32))))
    normal = ok & (np.abs(x) >= 2.0 ** -100)
    rel = (np.abs(hi[normal].astype(np.float64) + lo[normal] - x[normal])
           / np.abs(x[normal].astype(np.float64)))
    assert rel.max() <= 2.0 ** -22
    assert (lo[~ok] == 0).all() and np.isnan(hi[np.isnan(x)]).all()


def _unpack_f32(p: torch.Tensor) -> torch.Tensor:
    """Core matrices [..., N/8, K/4, 8, 4] -> [..., N, K]."""
    n8, k4 = p.shape[-4:-2]
    return p.transpose(-3, -2).reshape(*p.shape[:-4], 8 * n8, 4 * k4)


def _dft_parts(p: torch.Tensor):
    """The direct kernel's stage-ordered [tiles, chunks, 2, 14, 4, 8, 4]
    -> (hi, lo) f32 [N, K]."""
    tiles, chunks = p.shape[:2]
    m = p.permute(2, 0, 3, 5, 1, 4, 6).reshape(2, 112 * tiles, 16 * chunks)
    return m[0], m[1]


def test_core_matrices_layout():
    m = torch.arange(16 * 12, dtype=torch.float32).reshape(16, 12)
    c = core_matrices_tf32(m)
    assert c.shape == (2, 3, 8, 4)
    # core matrix (n8, k4) holds rows 8 n8 .. +7, columns 4 k4 .. +3
    assert torch.equal(c[1, 2], m[8:16, 8:12])
    assert torch.equal(c.reshape(-1)[:4], m[0, :4])


@pytest.mark.parametrize("n_fft", [441, 320, 882, 220, 446])
def test_packed_dft_basis_unpacks_to_dft_matrices(n_fft):
    p = pack_dft_tc(n_fft)
    n_pad, k_pad = dft_tc_shape(n_fft)
    f = n_fft // 2 + 1
    assert p.shape == (n_pad // 112, k_pad // 16, 2, 14, 4, 8, 4)
    assert n_pad - 112 < 2 * f <= n_pad and k_pad - 16 < n_fft <= k_pad
    cos_b, nsin_b = (torch.from_numpy(a).T for a in dft_matrices(n_fft))
    want = torch.zeros(n_pad, k_pad)
    want[0:2 * f:2, :n_fft], want[1:2 * f:2, :n_fft] = cos_b, nsin_b
    # hi and lo are the split of the interleaved bases, zeros in the padding
    hi, lo = _dft_parts(p)
    w_hi, w_lo = split_tf32(want)
    assert torch.equal(hi, w_hi) and torch.equal(lo, w_lo)
    m = hi.to(F64) + lo.to(F64)
    assert (m - want.to(F64)).abs().max() <= 2.0 ** -22 * m.abs().max()
    assert not m[2 * f:].any() and not m[:, n_fft:].any()


@pytest.mark.parametrize("cin,c", [(64, 128), (32, 64)])
def test_packed_block2_weights_unpack_to_hwio(cin, c):
    rng = np.random.RandomState(cin)
    w1 = torch.from_numpy(rng.randn(3, 3, cin, c).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(3, 3, c, c).astype(np.float32))
    wp = pack_block2_f32tc(w1, w2)
    ns1 = 9 * cin // 16
    assert wp.shape == (ns1 + 9 * c // 16, c // 8, 4, 8, 4)
    m = _unpack_f32(wp)  # [NS, C (n), 16 (k)]
    for s in range(wp.shape[0]):
        w, s0 = (w1, s) if s < ns1 else (w2, s - ns1)
        kch = w.shape[2] // 16
        tap, kc = divmod(s0, kch)
        dt, df = divmod(tap, 3)
        assert torch.equal(m[s], w[df, dt, 16 * kc:16 * (kc + 1), :].T)


@pytest.mark.parametrize("c", [64, 32])
def test_packed_block1_f32_weights_unpack_to_hwio(c):
    """Block 1's stream is conv 2's slices alone, in block 2's order."""
    rng = np.random.RandomState(c + 1)
    w2 = torch.from_numpy(rng.randn(3, 3, c, c).astype(np.float32))
    wp = pack_block1_f32tc(w2)
    assert wp.shape == (9 * c // 16, c // 8, 4, 8, 4) and wp.is_contiguous()
    m = _unpack_f32(wp)  # [NS, C (n), 16 (k)]
    for s in range(wp.shape[0]):
        tap, kc = divmod(s, c // 16)
        dt, df = divmod(tap, 3)
        assert torch.equal(m[s], w2[df, dt, 16 * kc:16 * (kc + 1), :].T)
    w1 = torch.from_numpy(rng.randn(3, 3, 16, c).astype(np.float32))
    assert torch.equal(wp, pack_block2_f32tc(w1, w2)[9:])


# -- emulation of the kernels' 3xTF32 products -----------------------------

def _parts(x):
    hi, lo = split_tf32(x.float().contiguous())
    return hi, lo


def _mm3(a, b_hi, b_lo, passes=3):
    """a @ B in the kernels' arithmetic: a split in registers, B packed;
    lo.hi + hi.lo + hi.hi (or hi.hi alone), f32 products and sums."""
    a_hi, a_lo = _parts(a)
    out = a_hi @ b_hi
    if passes == 3:
        out = a_lo @ b_hi + a_hi @ b_lo + out
    return out


def _stft_emulated(audio, n_fft, hop, n_frames, passes=3):
    b_hi, b_lo = (m.T for m in _dft_parts(pack_dft_tc(n_fft)))
    frames = frames_from_prepadded(audio, n_fft, hop, n_frames)
    frames = F.pad(frames, (0, b_hi.shape[0] - n_fft))
    y = _mm3(frames.reshape(-1, b_hi.shape[0]), b_hi, b_lo, passes)
    f = n_fft // 2 + 1
    re, im = y[:, 0:2 * f:2], y[:, 1:2 * f:2]
    return torch.log1p(torch.sqrt(re * re + im * im)).reshape(
        audio.shape[0], n_frames, f)


def _stft_f64(audio, n_fft, hop, n_frames):
    cos_b, nsin_b = (torch.from_numpy(a).to(F64) for a in dft_matrices(n_fft))
    frames = frames_from_prepadded(audio.to(F64), n_fft, hop, n_frames)
    re, im = frames @ cos_b, frames @ nsin_b
    return torch.log1p(torch.sqrt(re * re + im * im))


@pytest.mark.parametrize("n_fft,hop", [(441, 220), (320, 160), (882, 441)])
def test_3xtf32_stft_within_f32_tolerance_one_pass_misses(n_fft, hop):
    rng = np.random.RandomState(n_fft)
    n_frames = 60
    audio = torch.from_numpy(rng.uniform(
        -0.5, 0.5, (2, (n_frames - 1) * hop + n_fft)).astype(np.float32))
    want = _stft_f64(audio, n_fft, hop, n_frames)
    three = (_stft_emulated(audio, n_fft, hop, n_frames).to(F64) - want).abs()
    one = (_stft_emulated(audio, n_fft, hop, n_frames, passes=1).to(F64)
           - want).abs()
    print(f"n_fft {n_fft}: 3xTF32 max abs err {float(three.max()):.3e}, "
          f"one pass {float(one.max()):.3e}")
    assert float(three.max()) <= 1e-5
    assert bool((three <= 1e-4 + 1e-4 * want.abs()).all())
    # one pass misses the tolerance, worst relative to the value on the
    # small bins (log1p(|X|) < 0.5)
    assert not bool((one <= 1e-4 + 1e-4 * want.abs()).all())
    rel = one / want.clamp_min(1e-3)
    small = want < 0.5
    assert float(rel[small].max()) > 10 * float(rel[~small].max())


def _conv_emulated(x, wp, s0, bias, passes):
    """SAME conv3x3 of x [B, T, F, K] (zeros outside) as the kernel sums
    it: per slice s0 + tap * (K/16) + kc, the shifted window's 16-channel
    chunk @ that slice's [C][16] matrix, split and in three passes."""
    b, t, f, k = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    p = _unpack_f32(wp[s0:s0 + 9 * k // 16])  # [slices, C, 16]
    out = torch.zeros(b * t * f, p.shape[1])
    for s in range(p.shape[0]):
        tap, kc = divmod(s, k // 16)
        dt, df = divmod(tap, 3)
        a = xp[:, dt:dt + t, df:df + f, 16 * kc:16 * (kc + 1)].reshape(-1, 16)
        b_hi, b_lo = (m.T for m in split_tf32(p[s]))
        out = out + _mm3(a, b_hi, b_lo, passes)
    return torch.relu(out.reshape(b, t, f, -1) + bias)


@pytest.mark.parametrize("cin,c", [(64, 128), (32, 64)])
def test_3xtf32_block2_within_f32_tolerance(cin, c):
    """The block-2 kernel's arithmetic on its packed weight stream (conv-1
    slices, then conv-2 slices) against the float64 block."""
    rng = np.random.RandomState(c)
    x = torch.from_numpy(rng.randn(2, 9, 11, cin).astype(np.float32))
    w1, w2 = (torch.from_numpy((rng.randn(3, 3, k, c) * 0.3 / k ** 0.5)
                               .astype(np.float32)) for k in (cin, c))
    b1, b2 = (torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
              for _ in range(2))
    wp = pack_block2_f32tc(w1, w2)
    errs = {}
    for passes in (3, 1):
        y = _conv_emulated(x, wp, 0, b1, passes)
        y = _conv_emulated(y, wp, 9 * cin // 16, b2, passes)
        got = F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        xd = x.to(F64).permute(0, 3, 1, 2)
        yd = F.relu(F.conv2d(xd, w1.to(F64).permute(3, 2, 1, 0), b1.to(F64),
                             padding=1))
        yd = F.relu(F.conv2d(yd, w2.to(F64).permute(3, 2, 1, 0), b2.to(F64),
                             padding=1))
        want = F.max_pool2d(yd, 2).permute(0, 2, 3, 1)
        assert got.shape == want.shape == (2, 4, 5, c)
        errs[passes] = float((got.to(F64) - want).abs().max())
    print(f"block 2 ({cin}, {c}): 3xTF32 max abs err {errs[3]:.3e}, one "
          f"pass {errs[1]:.3e}")
    assert errs[3] <= 1e-5 and errs[1] > 1e-4


@pytest.mark.parametrize("c", [64, 32])
def test_3xtf32_block1_within_f32_tolerance(c):
    """The block-1 kernel's arithmetic: conv 1 in f32 (the kernel's nine
    FMAs), conv 2 in three passes on its packed weight stream, then pool,
    against the float64 block and the JAX package's Pallas block 1."""
    rng = np.random.RandomState(c + 2)
    arrs = [rng.randn(2, 16, 13).astype(np.float32),  # Pallas: T % 8 == 0
            (rng.randn(3, 3, 1, c) * 0.3).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(3, 3, c, c) * 0.3 / np.sqrt(c)).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32)]
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in arrs)
    wp = pack_block1_f32tc(w2)
    y1 = F.relu(F.conv2d(x[:, None], w1.permute(3, 2, 1, 0), b1, padding=1))
    y1 = y1.permute(0, 2, 3, 1)  # [B, T, F, C]
    xd = x.to(F64)[:, None]
    yd = F.relu(F.conv2d(xd, w1.to(F64).permute(3, 2, 1, 0), b1.to(F64),
                         padding=1))
    yd = F.relu(F.conv2d(yd, w2.to(F64).permute(3, 2, 1, 0), b2.to(F64),
                         padding=1))
    want = F.max_pool2d(yd, 2).permute(0, 2, 3, 1)
    got, errs = {}, {}
    for passes in (3, 1):
        y = _conv_emulated(y1, wp, 0, b2, passes)
        got[passes] = F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(
            0, 2, 3, 1)
        assert got[passes].shape == want.shape == (2, 8, 6, c)
        errs[passes] = float((got[passes].to(F64) - want).abs().max())
    print(f"block 1 (C {c}): 3xTF32 max abs err {errs[3]:.3e}, one pass "
          f"{errs[1]:.3e}")
    assert errs[3] <= 1e-5 and errs[1] > 1e-4
    pallas = np.asarray(vp.vgg_block_forward_pallas(
        *map(jnp.asarray, arrs), interpret=True, out_dtype=jnp.float32))
    np.testing.assert_allclose(got[3].numpy(), pallas, rtol=1e-4, atol=1e-4)


def test_tf32_ablation_variants_apply():
    """Every text variant of ``cli/tf32_ablation.py`` applies to today's
    sources, the block-1 tile edit keeps the lines it edits whole, and a
    line's registers are those of the kernel instance it times."""
    from mtl_tpu_torch.cli import tf32_ablation as ab

    v = ab.variants()
    assert set(v) == {(lib, n) for lib, _, names in ab.KERNELS.values()
                      for n in names}
    tile32 = v[("vgg_f32_tc", "tile32")]
    assert "TT = 32, TF = 16;  // block 1's conv-2 tile\n" in tile32
    assert "CTAS = 1;          // block 1's CTAs a SM\n" in tile32
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{n}' "
        f"for 'sm_90a'\n    0 bytes stack frame, {s} bytes spill stores, "
        f"0 bytes spill loads\nptxas info    : Used {r} registers\n"
        for n, r, s in (("23vgg_block1_f32tc_kernelILi32EEEvPKf", 110, 0),
                        ("23vgg_block1_f32tc_kernelILi64EEEvPKf", 124, 8),
                        ("23vgg_block2_f32tc_kernelILi64ELi128EEEv", 184, 0)))
    assert (ab.kernel_ptxas(log, "vgg_block1_f32tc_kernel")
            == "registers 124 spill stores 8")
    assert (ab.kernel_ptxas(log, "vgg_block2_f32tc_kernel")
            == "registers 184 spill stores 0")
    assert ab.kernel_ptxas(log, "stft_dft_tc_kernel") == "no ptxas report"
    assert ab.main([]) == 1  # no card here: it refuses to time
