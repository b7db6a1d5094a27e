"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. On such a
machine, where JAX may be absent, run them without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

(The mesh tests import ``torch_mesh_worker`` from this directory, which
pytest puts first on ``sys.path``: an environment's site-packages may hold
a ``tests`` package of its own.)

Shapes cover ragged time and freq tiles (odd T and F, T not a multiple of
16), both channel configurations (vgg_cnn 64/128, large_cnn 32/64), the
flagship shapes, both routes of the STFT, which n_fft chooses (every FFT
radix, an odd FFT half, T = 1, a waveform short of its last frame; the
direct route at n_fft 441, 882, 220 and 446, hops that break 16-byte
alignment, a waveform that starts off 16 bytes, ragged row and bin
tiles), and both routes of the VGG blocks,
which ``out_dtype`` chooses (both f32 blocks at 161, 80 and 221 bins, and
block 1 at 15, 17 and 33), a
3xTF32 library refused or a launch that fails raising with no fallback, the VGG
stack's autograd Function on both routes, one flagship-width meta step
with its launch counts, the beam's bank and the LM scorer (TF32 allowed
globally) against the CPU, the beam ``test_main``'s launches, an LM
training step (cuDNN's RNN backward, TF32 allowed globally) against the
same step with TF32 off and against the CPU, the LM's second-order cell
loop against the cuDNN forward, one flagship-width joint step with its
launch counts, and one f32 step each of MAML, the adversarial joint step,
the multitask meta step and the epoch trainer's step (Noam Adam) against
the CPU, both VGG routes at the log-fbank width (80 bins into block 1, 40
into block 2) and at the 22.05 kHz width (221 into block 1, 110 into
block 2), the device CER on CUDA tensors (equal integers), emb_cnn's
convs and BatchNorm in training and evaluation mode (outputs and running
statistics within 1e-4 relative) and the CTC loss with an infeasible row
(value 1e-5 relative, gradients 1e-4 of the largest) against the CPU; the
Conformer encoder at f32 against the CPU (1e-4), a second-order meta step
at f32 against the CPU (no VGG kernel launched; gradients 1e-3 of the
largest, as the first-order steps) and ``--remat`` on against off on the
card (equal loss and generator state, gradients within 2^-8 of the
largest, at dropout 0.1, bf16); a meta step on a 2-rank gloo mesh sharing
the card against the step in one process (gradients within 1e-4 of the
largest), and the sequence-parallel encode over 2 ranks on the card
against the unsharded encode; the meta step replayed as CUDA graphs
(``train/graphs.py``) against the eager step over seven steps of three
shape keys (the shared query and ``per_task_query`` on the VGG kernels,
emb_cnn's running statistics, an E-Branchformer encoder), bit-equal or within one bf16 ulp of the
largest element, its launch counts (each replay counted once, its kernels
at the capture) the eager step's.
Tolerances:
both STFT routes are f32 against the f32 plain version; the FFT and the
GEMM sum in other orders (rtol/atol 1e-4). The VGG f32 routes differ from
the f32 plain version in summation order (rtol/atol 1e-4). The direct STFT
and both f32 VGG blocks run 3xTF32 (csrc/tf32x3.cuh): products to ~2^-22
and the tensor cores' f32 sums, inside the same 1e-4. The bf16
tensor-core route and the bf16-operand plain version sum in f32 in other
orders, so a conv-1 value or an output near a bf16 rounding boundary may
round to its neighbour: one bf16 ulp of the output, |d| <= 2^-7 |plain| +
2^-10 (the absolute term for outputs near zero, where a neighbouring conv-1
value moves the sum by about 1e-4). The beam at f32: equal bank tokens,
lengths and word counts, raw scores (sums of f32 log-probabilities,
summation order only) within 1e-4; LM scores within 1e-5. LM training
steps: losses 1e-5 relative, parameters after an SGD step at lr 20 within
1e-5 * lr (f32, summation order only); the cell loop's outputs within 1e-5.
"""

import numpy as np
import pytest
import torch

from mtl_tpu_torch.ops import native
from mtl_tpu_torch.ops.frontend import dft_matrices
from mtl_tpu_torch.ops.stft import (device_dft_tc_operands, stft_logmag,
                                    stft_logmag_direct, stft_logmag_plain,
                                    stft_route)
from mtl_tpu_torch.ops.vgg import vgg_block1, vgg_block2, vgg_block_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.build()
    return torch.device("cuda")


def _close_bf16(k, p):
    k, p = k.float(), p.float()
    err = (k - p).abs()
    assert bool((err <= 2.0 ** -7 * p.abs() + 2.0 ** -10).all()), \
        float(err.max())


def _vgg_inputs(dev, shape, cin, c, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    if cin > 1:
        x = x.to(dtype)
    ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32)).to(dev)
          for s, sc in (((3, 3, cin, c), 0.3 / cin ** 0.5), ((c,), 0.1),
                        ((3, 3, c, c), 0.3 / c ** 0.5), ((c,), 0.1))]
    return x, ws


def _run_route(fn, x, ws, dtype, block):
    """One wrapper call; asserts that exactly its dtype's route launched."""
    name = f"vgg_block{block}"
    mine, other = ((name, f"{name}_f32") if dtype == torch.bfloat16
                   else (f"{name}_f32", name))
    before = dict(native.launch_counts)
    out = fn(x, *ws, out_dtype=dtype)
    torch.cuda.synchronize()
    assert native.launch_counts[mine] == before[mine] + 1
    assert native.launch_counts[other] == before[other]
    return out


# (b, t, n_fft, hop, samples short of (t - 1) * hop + n_fft); the FFT
# route's CTAs take 4 frames, so t = 37, 21, 33 and 50 leave a ragged last
# CTA. The direct route (n_fft 448, 441, 882, 220, 446 = 2 * 223) takes 128
# frame rows and 56 bins a CTA: b * t is no multiple of 128 below, 250 and
# 448 leave a ragged last bin tile, and hops 441 and 110 (and odd S) take
# its 4-byte frame copies.
STFT_SHAPES = [(2, 37, 320, 160, 0), (3, 200, 320, 160, 0),
               (1, 50, 400, 160, 0), (8, 800, 320, 160, 0),
               (2, 33, 160, 80, 0), (3, 1, 320, 160, 0),
               (2, 21, 320, 160, 250), (1, 9, 480, 160, 0),
               (1, 7, 512, 160, 0), (1, 12, 250, 100, 0),
               (1, 40, 448, 160, 0), (8, 800, 441, 220, 0),
               (2, 37, 441, 220, 0), (3, 50, 441, 441, 0),
               (2, 21, 882, 441, 7), (2, 33, 220, 110, 0),
               (1, 9, 446, 223, 0), (5, 77, 441, 220, 300)]
DIRECT_N_FFT = (448, 441, 882, 220, 446)


def _stft_inputs(dev, b, t, n_fft, hop, short):
    rng = np.random.RandomState(t + n_fft)
    s = (t - 1) * hop + n_fft - short
    audio = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (b, s)).astype(np.float32)).to(dev)
    cos_b, nsin_b = (torch.from_numpy(m).to(dev)
                     for m in dft_matrices(n_fft, "hamming"))
    return audio, cos_b, nsin_b


@pytest.mark.parametrize("b,t,n_fft,hop,short", STFT_SHAPES)
def test_stft_kernel_matches_plain(dev, b, t, n_fft, hop, short):
    """The wrapper launches the route its n_fft picks (the FFT for 448's
    factor 7 is refused: the direct kernel), and only that one."""
    audio, cos_b, nsin_b = _stft_inputs(dev, b, t, n_fft, hop, short)
    mine, other = (("stft_logmag", "stft_logmag_direct")
                   if stft_route(n_fft) == "fft"
                   else ("stft_logmag_direct", "stft_logmag"))
    assert (mine == "stft_logmag") == (n_fft not in DIRECT_N_FFT)
    before = dict(native.launch_counts)
    out = stft_logmag(audio, n_fft, hop, t, "hamming")
    torch.cuda.synchronize()
    assert native.launch_counts[mine] == before[mine] + 1
    assert native.launch_counts[other] == before[other]
    ref = stft_logmag_plain(audio, cos_b, nsin_b, t, hop)
    assert out.shape == ref.shape == (b, t, n_fft // 2 + 1)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t,n_fft,hop,short", STFT_SHAPES)
def test_stft_direct_route_matches_plain(dev, b, t, n_fft, hop, short):
    """The direct kernel takes every n_fft through its launcher."""
    audio, cos_b, nsin_b = _stft_inputs(dev, b, t, n_fft, hop, short)
    before = native.launch_counts["stft_logmag_direct"]
    packed = device_dft_tc_operands(n_fft, "hamming", dev)
    out = stft_logmag_direct(audio, packed, n_fft, t, hop)
    torch.cuda.synchronize()
    assert native.launch_counts["stft_logmag_direct"] == before + 1
    ref = stft_logmag_plain(audio, cos_b, nsin_b, t, hop)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_stft_direct_kernel_on_a_waveform_off_16_bytes(dev):
    """A waveform view that starts 4 bytes past a 16-byte boundary: the
    wrapper raises ValueError (no counter moves), and the kernel's own
    entry, called on it, takes the 4-byte frame copies (n_fft 448 and hop
    160 would take the 16-byte ones) and matches the plain version; the
    card stays usable."""
    b, t, n_fft, hop = 2, 37, 448, 160
    s = (t - 1) * hop + n_fft
    rng = np.random.RandomState(5)
    base = torch.from_numpy(rng.uniform(-0.5, 0.5, b * s + 4).astype(
        np.float32)).to(dev)
    audio = base[1:1 + b * s].view(b, s)
    assert audio.is_contiguous() and audio.data_ptr() % 16 == 4
    packed = device_dft_tc_operands(n_fft, "hamming", dev)
    before = dict(native.launch_counts)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stft_logmag_direct(audio, packed, n_fft, t, hop)
    assert native.launch_counts == before
    f = n_fft // 2 + 1
    out = torch.full((b, t, f), float("nan"), device=dev)
    rc = native.library("stft_dft_tc").stft_dft_tc_f32(
        audio.data_ptr(), packed.data_ptr(), out.data_ptr(), b, s, t, n_fft,
        hop, f, packed.shape[0], packed.shape[1],
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    cos_b, nsin_b = (torch.from_numpy(m).to(dev)
                     for m in dft_matrices(n_fft, "hamming"))
    ref = stft_logmag_plain(audio, cos_b, nsin_b, t, hop)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    aligned = audio.clone()
    torch.testing.assert_close(
        stft_logmag_direct(aligned, packed, n_fft, t, hop), ref, rtol=1e-4,
        atol=1e-4)


def test_stft_fft_library_refused_raises(dev, monkeypatch):
    """When the FFT library cannot be had, an n_fft of the FFT route
    raises; it does not run the direct kernel or the plain version."""
    real = native.library

    def refuse(name):
        if name == "stft_fft":
            raise RuntimeError("stft_fft refused")
        return real(name)

    monkeypatch.setattr(native, "library", refuse)
    audio, _, _ = _stft_inputs(dev, 1, 5, 320, 160, 0)
    before = dict(native.launch_counts)
    with pytest.raises(RuntimeError, match="stft_fft refused"):
        stft_logmag(audio, 320, 160, 5)
    assert native.launch_counts == before


def test_device_tf32_split_is_cvt_rna_and_its_torch_mirror(dev):
    """csrc/tf32x3.cuh's split on the card (tf32_split_f32): hi is what
    cvt.rna.tf32.f32 gives (low 13 bits cleared) on every finite normal
    value below the largest tf32, and (hi, lo) equal ops/tf32.py:
    split_tf32 bit for bit on every value, subnormals, inf and nan too."""
    from mtl_tpu_torch.ops.tf32 import split_tf32

    rng = np.random.RandomState(11)
    normal = rng.randn(20000) * 10.0 ** rng.uniform(-37, 37, 20000)
    base = rng.randn(2000).astype(np.float32).view(np.int32) & ~0x1FFF
    ties = np.concatenate([base | 0x1000, (base | 0x1000) + 1,
                           (base | 0x1000) - 1]).view(np.float32)
    sub = rng.randint(1, 1 << 23, 2000).astype(np.int32).view(np.float32)
    x = np.concatenate([normal.astype(np.float32), ties, sub, -sub, np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38], np.float32)])
    xt = torch.from_numpy(x).to(dev)
    hi, lo, cvt = (torch.empty(x.size, dtype=torch.int32, device=dev)
                   for _ in range(3))
    rc = native.library("stft_dft_tc").tf32_split_f32(
        xt.data_ptr(), hi.data_ptr(), lo.data_ptr(), cvt.data_ptr(), x.size,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want_hi, want_lo = (t.view(torch.int32) for t in split_tf32(
        torch.from_numpy(x)))
    hi, lo, cvt = hi.cpu(), lo.cpu(), cvt.cpu()
    nan = torch.from_numpy(np.isnan(x))
    assert torch.equal(hi[~nan], want_hi[~nan])
    assert torch.equal(lo, want_lo)
    mag = np.abs(x)
    normal = torch.from_numpy((mag >= 2.0 ** -126) & (mag < 3.4e38))
    assert torch.equal(cvt[normal], hi[normal])
    subn = torch.from_numpy((mag > 0) & (mag < 2.0 ** -126))
    print(f"cvt.rna vs the integer split on {int(subn.sum())} subnormals: "
          f"{int((cvt[subn] != hi[subn]).sum())} differ")


class _FailingLibrary:
    """Every entry returns a CUDA error code, as a refused launch does."""

    def __getattr__(self, entry):
        return lambda *args: 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("lib,block", [("stft_dft_tc", None),
                                       ("vgg_f32_tc", 2), ("vgg_f32_tc", 1)])
@pytest.mark.parametrize("how", ["refused", "launch_fails"])
def test_tf32_kernels_raise_without_fallback(dev, monkeypatch, lib, block,
                                             how):
    """The 3xTF32 routes (the direct STFT at n_fft 441, the f32 blocks 2
    and 1): a library that cannot be had, or a launch that returns a CUDA
    error, raises; no counter moves and neither the other route nor the
    plain version runs instead."""
    real = native.library

    def library(name):
        if name != lib:
            return real(name)
        if how == "refused":
            raise RuntimeError(f"{name} refused")
        return _FailingLibrary()

    monkeypatch.setattr(native, "library", library)
    if lib == "stft_dft_tc":
        audio, _, _ = _stft_inputs(dev, 2, 9, 441, 220, 0)
        call = lambda: stft_logmag(audio, 441, 220, 9)  # noqa: E731
    elif block == 2:
        x, ws = _vgg_inputs(dev, (1, 16, 13, 64), 64, 128, torch.float32, 6)
        call = lambda: vgg_block2(x, *ws, out_dtype=torch.float32)  # noqa
    else:
        x, ws = _vgg_inputs(dev, (1, 16, 13), 1, 64, torch.float32, 6)
        call = lambda: vgg_block1(x, *ws, out_dtype=torch.float32)  # noqa
    before = dict(native.launch_counts)
    match = "refused" if how == "refused" else "CUDA error 1"
    with pytest.raises(RuntimeError, match=match):
        call()
    assert native.launch_counts == before


@pytest.mark.parametrize("f", [161, 80, 221])
@pytest.mark.parametrize("cin,c", [(64, 128), (32, 64)])
def test_vgg_block2_f32_tensor_core_tiles(dev, f, cin, c):
    """The f32 block 2 (3xTF32, 8 x 16 conv-2 tiles) at 161, 80 and 221
    bins with an odd T: ragged tiles in both axes, floored at the pool."""
    x, ws = _vgg_inputs(dev, (2, 75, f, cin), cin, c, torch.float32, f + c)
    x = x.relu()  # like block 1's output
    out = _run_route(vgg_block2, x, ws, torch.float32, 2)
    ref = vgg_block_plain(x, *ws, out_dtype=torch.float32)
    assert out.shape == ref.shape == (2, 37, f // 2, c)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("f", [161, 80, 221, 15, 17, 33])
@pytest.mark.parametrize("c", [64, 32])
def test_vgg_block1_f32_tensor_core_tiles(dev, f, c):
    """The f32 block 1 (3xTF32 conv 2, 16 x 16 conv-2 tiles) at 161, 80 and
    221 bins and at widths one tile and one column either side of it, with
    an odd T: ragged tiles in both axes, floored at the pool."""
    x, ws = _vgg_inputs(dev, (2, 75, f), 1, c, torch.float32, f + c)
    out = _run_route(vgg_block1, x, ws, torch.float32, 1)
    ref = vgg_block_plain(x, *ws, out_dtype=torch.float32)
    assert out.shape == ref.shape == (2, 37, f // 2, c)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,f", [(16, 13), (37, 161), (100, 161)])
@pytest.mark.parametrize("cin,c", [(1, 64), (1, 32), (64, 128), (32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_kernel_matches_plain(dev, t, f, cin, c, dtype):
    """f32: the 3xTF32 route against the f32 plain version; bf16:
    the tensor-core route against the bf16-operand plain version."""
    shape = (2, t, f) if cin == 1 else (2, t, f, cin)
    x, ws = _vgg_inputs(dev, shape, cin, c, dtype, t + c)
    fn, block = (vgg_block1, 1) if cin == 1 else (vgg_block2, 2)
    out = _run_route(fn, x, ws, dtype, block)
    ref = vgg_block_plain(x, *ws, out_dtype=dtype)
    assert out.shape == ref.shape == (2, t // 2, f // 2, c)
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("block", [1, 2])
def test_vgg_tc_flagship_tiles(dev, block):
    """The flagship shapes (batch 8, 800 frames x 161 bins; block 2 at
    400 x 80 x 64): many tiles in both axes, block 1's odd F, and the
    persistent block-1 grid walking several tiles per CTA."""
    if block == 1:
        x, ws = _vgg_inputs(dev, (8, 800, 161), 1, 64, torch.bfloat16, 1)
        fn = vgg_block1
    else:
        x, ws = _vgg_inputs(dev, (8, 400, 80, 64), 64, 128, torch.bfloat16,
                            2)
        x = x.relu()  # like block 1's output
        fn = vgg_block2
    out = _run_route(fn, x, ws, torch.bfloat16, block)
    ref = vgg_block_plain(x, *ws, out_dtype=torch.bfloat16)
    assert out.shape == ref.shape
    _close_bf16(out, ref)


def test_vgg_tc_refuses_unbuilt_channels(dev):
    """C = 16 has no kernel: a bf16 CUDA call raises ValueError and neither
    route launches."""
    x, ws = _vgg_inputs(dev, (1, 16, 13), 1, 16, torch.bfloat16, 3)
    before = dict(native.launch_counts)
    with pytest.raises(ValueError):
        vgg_block1(x, *ws, out_dtype=torch.bfloat16)
    assert native.launch_counts == before


def test_vgg_tc_library_refused_raises(dev, monkeypatch):
    """When the tensor-core library cannot be had, a bf16 CUDA call raises;
    it does not run the f32 route or the plain version instead."""
    real = native.library

    def refuse(name):
        if name == "vgg_tc":
            raise RuntimeError("vgg_tc refused")
        return real(name)

    monkeypatch.setattr(native, "library", refuse)
    for cin, c, fn in ((1, 64, vgg_block1), (64, 128, vgg_block2)):
        shape = (1, 16, 13) if cin == 1 else (1, 16, 13, cin)
        x, ws = _vgg_inputs(dev, shape, cin, c, torch.bfloat16, 4)
        before = dict(native.launch_counts)
        with pytest.raises(RuntimeError, match="vgg_tc refused"):
            fn(x, *ws, out_dtype=torch.bfloat16)
        assert native.launch_counts == before


# -- the VGG stack's autograd Function and the meta step ------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_stack_grads_match_plain_autograd(dev, dtype):
    """The Function (kernels forward, recomputed plain VJP backward)
    against autograd through the route's plain version on the card (TF32
    off, as the Function's backward runs it) on a short batch: the same
    computation up to the order of cuDNN's sums (its weight-gradient
    algorithms are not deterministic). f32: rtol 1e-3 and 1e-3 of the
    largest entry. bf16: the bf16-operand form rounds the gradient that
    reaches each conv to bf16, and a value on a rounding boundary may round
    either way, moving a weight gradient by one bf16 ulp of one of its
    terms; rtol 2^-7 and 2^-6 of the largest entry."""
    from mtl_tpu_torch.ops.vgg import vgg_stack, vgg_stack_plain

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 64, 161).astype(np.float32)).to(dev)
    ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32)).to(dev)
          for s, sc in (((3, 3, 1, 64), 0.3), ((64,), 0.1),
                        ((3, 3, 64, 64), 0.04), ((64,), 0.1),
                        ((3, 3, 64, 128), 0.04), ((128,), 0.1),
                        ((3, 3, 128, 128), 0.03), ((128,), 0.1))]
    g = torch.from_numpy(rng.randn(2, 16, 40 * 128).astype(np.float32)).to(
        dev).to(dtype)
    w1 = [w.clone().requires_grad_(True) for w in ws]
    before = native.launch_counts["vgg_stack_bwd"]
    got = torch.autograd.grad(vgg_stack(x, w1, out_dtype=dtype), w1, g)
    torch.cuda.synchronize()
    assert native.launch_counts["vgg_stack_bwd"] == before + 1
    w2 = [w.clone().requires_grad_(True) for w in ws]
    want = torch.autograd.grad(vgg_stack_plain(x, w2, dtype), w2, g)
    rtol, scale = ((1e-3, 1e-3) if dtype == torch.float32
                   else (2.0 ** -7, 2.0 ** -6))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=scale * float(b.abs().max()))


def test_flagship_meta_step_launches_the_kernels(dev, tmp_path):
    """One bf16 meta step at the flagship width (3 tasks of 8 + 8
    utterances, 800 frames): every support and query forward runs both
    tensor-core VGG kernels and the FFT STFT, every backward the stack's
    recompute; the loss is finite and the weights move."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    manifests, labels = make_synthetic_corpus(
        str(tmp_path), num_tasks=3, utts_per_task=8, min_sec=4.0,
        max_sec=7.9, seed=1)
    vocab = Vocab.from_json(labels)
    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 4, 8
    m.dim_inner, m.dropout = 512, 0.1
    cfg.data.src_bucket_frames = (800,)
    cfg.finalize()
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=0)
    support, query = ds.sample_meta_batch(8, 8)
    assert support["audio"].shape[:2] == (3, 8)
    model = build_model(cfg, len(vocab), dev)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(1e-4)
    state = init_train_state(model, opt)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    native.reset_launch_counts()
    state, metrics = make_meta_step(model, cfg, opt)(
        state, batch_to_device(support, dev), batch_to_device(query, dev),
        torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    c = native.launch_counts
    assert c["vgg_block1"] == c["vgg_block2"] == c["vgg_stack_bwd"] == 6, c
    assert c["stft_logmag"] == 4 and c["stft_logmag_direct"] == 0, c
    assert c["vgg_block1_f32"] == c["vgg_block2_f32"] == 0, c
    assert torch.isfinite(metrics["outer_loss"])
    moved = sum(int((state.params[k] != v).sum()) for k, v in before.items())
    assert moved > 0.5 * sum(v.numel() for v in before.values())


def test_vgg_stack_forward_raises_instead_of_falling_back(dev, monkeypatch):
    """A kernel that cannot be had makes the stack's forward (and so the
    model's) raise; nothing runs the plain version in its place."""
    from mtl_tpu_torch.ops.vgg import vgg_stack

    real = native.library

    def refuse(name):
        if name in ("vgg_tc", "vgg_f32_tc"):
            raise RuntimeError(f"{name} refused")
        return real(name)

    monkeypatch.setattr(native, "library", refuse)
    x, ws1 = _vgg_inputs(dev, (1, 16, 13), 1, 64, torch.float32, 6)
    _, ws2 = _vgg_inputs(dev, (1, 8, 6, 64), 64, 128, torch.float32, 7)
    ws = [w.requires_grad_(True) for w in ws1 + ws2]
    for dtype in (torch.bfloat16, torch.float32):
        before = dict(native.launch_counts)
        with pytest.raises(RuntimeError, match="refused"):
            vgg_stack(x, ws, out_dtype=dtype)
        assert native.launch_counts == before


def _tiny_asr(vocab_size, dtype):
    """(config, seeded model) of a small vgg_cnn Transformer."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.models.transformer import build_model, init_weights

    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 2, 4
    m.dim_model = m.dim_emb = m.dim_inner = 64
    m.dim_key = m.dim_value = m.r = 16
    m.dropout, m.dtype = 0.0, dtype
    m.src_max_len, m.tgt_max_len = 400, 200
    cfg.finalize()
    model = build_model(cfg, vocab_size)
    init_weights(model, torch.Generator().manual_seed(3))
    return cfg, model.eval()


def test_beam_bank_on_the_card_matches_the_cpu(dev):
    """The beam's bank at f32 (B 2, W 3, 10 steps): the card (FFT STFT
    not involved; the f32 VGG kernels) and the CPU (plain versions) keep
    the same hypotheses; raw scores within 1e-4."""
    from mtl_tpu_torch.decode.beam import NEG_INF, beam_decode_ids

    _, model = _tiny_asr(71, "float32")
    rng = np.random.RandomState(8)
    feats = torch.from_numpy(rng.randn(2, 96, 161).astype(np.float32))
    lengths = torch.tensor([96, 70])
    out = []
    for d in (dev, torch.device("cpu")):
        before = dict(native.launch_counts)
        res = beam_decode_ids(model.to(d), feats.to(d), lengths.to(d), 3,
                              10, 1, 0, 30, 0.1)
        out.append([r.cpu() for r in res])
        if d == dev:
            torch.cuda.synchronize()
            assert native.launch_counts["vgg_block1_f32"] == \
                before["vgg_block1_f32"] + 1
    (ct, cs, cw, cl), (pt, ps, pw, pl) = out
    assert torch.equal(ct, pt) and torch.equal(cl, pl) and torch.equal(cw, pw)
    real = ps > NEG_INF / 2
    assert torch.equal(cs > NEG_INF / 2, real)
    torch.testing.assert_close(cs[real], ps[real], rtol=1e-4, atol=1e-4)


def _fusion_lm(path):
    from mtl_tpu_torch.lm.fusion import save_lm_fusion
    from mtl_tpu_torch.lm.model import RNNLM, init_lm_weights

    words = ["<oov>", "<eos>", "the", "cat"] + [chr(0x4E00 + i)
                                               for i in range(40)]
    arch = {"rnn_type": "LSTM", "ntoken": len(words), "ninp": 200,
            "nhid": 200, "nlayers": 2, "dropout": 0.2, "tie_weights": False}
    lm = RNNLM("LSTM", len(words), 200, 200, 2, 0.2, False)
    init_lm_weights(lm, torch.Generator().manual_seed(4))
    save_lm_fusion(str(path), lm, {w: i for i, w in enumerate(words)}, arch)


def test_lm_scorer_on_the_card_matches_the_cpu_with_tf32_on(dev, tmp_path,
                                                            monkeypatch):
    """LM scores of a bank-sized batch on the card against the CPU, with
    TF32 allowed globally (torch's cuDNN default): the LM's f32 context
    holds them to 1e-5 and restores the flags."""
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.lm.fusion import LMScorer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _fusion_lm(tmp_path / "lm")
    vocab = Vocab.from_labels(list("abcdefghijklmnopqrstuvwxyz ")
                              + [chr(0x4E00 + i) for i in range(40)])
    rng = np.random.RandomState(2)
    id_lists = [[1] + rng.randint(4, len(vocab), size=n).tolist() + [2]
                for n in rng.randint(0, 300, size=64)]
    card = LMScorer.load(str(tmp_path / "lm"), dev).score_batch(id_lists,
                                                                 vocab)
    cpu = LMScorer.load(str(tmp_path / "lm"), torch.device("cpu"))
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    for ids, got in zip(id_lists, card):
        want = cpu.score_ids(ids, vocab)
        assert got[1:] == want[1:]
        assert abs(got[0] - want[0]) <= 1e-5, (got, want)


def test_beam_test_main_launches_each_kernel_once_a_batch(dev, tmp_path,
                                                          monkeypatch):
    """test_main --beam-search --lm-rescoring on cuda at bf16: the FFT
    STFT once a batch, both tensor-core VGG kernels once a batch (again
    for a batch that switches to greedy), the direct STFT never."""
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=1, utts_per_task=5, min_sec=1.0,
        max_sec=1.9, seed=2)
    vocab = Vocab.from_json(labels)
    cfg, model = _tiny_asr(len(vocab), "bfloat16")
    cfg.name, cfg.save_folder = "beam", str(tmp_path / "models")
    path = save_checkpoint(cfg, vocab, model.state_dict(), 0,
                           best_model=True)
    _fusion_lm(tmp_path / "lm")
    native.reset_launch_counts()
    res = test_main(["--test-manifest-list", manifests[0], "--labels-path",
                     labels, "--continue-from", path, "--k-test", "2",
                     "--beam-search", "--beam-width", "4", "--beam-nbest",
                     "3", "--lm-rescoring", "--lm-path",
                     str(tmp_path / "lm"), "--name", "beam", "--device",
                     dev.type])
    torch.cuda.synchronize()
    c = native.launch_counts
    assert res["utterances"] == 5
    batches, switched = 3, res["switched_to_greedy"]
    assert c["stft_logmag"] == batches and c["stft_logmag_direct"] == 0, c
    assert c["vgg_block1"] == c["vgg_block2"] == batches + switched, c
    assert c["vgg_block1_f32"] == c["vgg_block2_f32"] == 0, c


def _lm_step_run(dev, tf32, monkeypatch):
    """One LM SGD step at lm_parser's widths (LSTM 200/200 x 2, 2,000
    words, batch 20, bptt 35, lr 20, clip 0.25) from seeded weights on
    ``dev``: (loss, carry, params after)."""
    from mtl_tpu_torch.lm.model import RNNLM, init_lm_weights
    from mtl_tpu_torch.lm.train import make_lm_sgd_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    model = RNNLM("LSTM", 2000, 200, 200, 2, 0.0, False)
    init_lm_weights(model, torch.Generator().manual_seed(5))
    model.to(dev)
    rng = np.random.RandomState(3)
    data = rng.randint(0, 2000, (35, 20))
    target = rng.randint(0, 2000, 35 * 20)
    loss, carry = make_lm_sgd_step(model, 0.25)(data, target, 20.0, None,
                                                model.init_carry(20))
    return (float(loss), [t.cpu() for c in carry for t in c],
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def test_lm_training_step_runs_cudnn_backward_in_f32(dev, monkeypatch):
    """An LM training step on the card with TF32 allowed globally equals
    the step with TF32 off (the step holds itself to f32, backward
    included) and the CPU's step; cuDNN's RNN backward runs, which it
    refuses after a forward outside training mode."""
    on = _lm_step_run(dev, True, monkeypatch)
    assert torch.backends.cudnn.allow_tf32
    off = _lm_step_run(dev, False, monkeypatch)
    cpu = _lm_step_run(torch.device("cpu"), False, monkeypatch)
    for other in (off, cpu):
        assert abs(on[0] - other[0]) <= 1e-5 * abs(other[0])
        for a, b in zip(on[1], other[1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for k, v in other[2].items():
            torch.testing.assert_close(on[2][k], v, rtol=0, atol=1e-5 * 20)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_lm_cell_loop_forward_equals_cudnn(dev, rnn_type):
    """The second-order route (the explicit cell loop) and cuDNN's
    recurrence give the same logits and carry on the card, at 200/200."""
    from mtl_tpu_torch.lm.model import RNNLM, init_lm_weights

    lib = RNNLM(rnn_type, 500, 200, 200, 2, 0.0, False)
    init_lm_weights(lib, torch.Generator().manual_seed(6))
    with torch.no_grad():
        for rnn in lib.rnns:
            rnn.bias.uniform_(-0.1, 0.1)
    loop = RNNLM(rnn_type, 500, 200, 200, 2, 0.0, False, cell_loop=True)
    loop.load_state_dict(lib.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, 500, (35, 20))).to(dev)
    outs = []
    for m in (lib.to(dev).train(), loop.to(dev).train()):
        logits, carry = m(tokens)
        outs.append([logits] + [t for c in carry for t in
                                (c if isinstance(c, tuple) else [c])])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flagship_joint_step_launches_the_kernels(dev, tmp_path):
    """One bf16 joint step at the flagship width (3 tasks of 8
    utterances, 800 frames): each task's forward runs the FFT STFT and both
    tensor-core VGG kernels, the one backward the stack's recompute per
    task; the loss is finite and the weights move."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step)

    manifests, labels = make_synthetic_corpus(
        str(tmp_path), num_tasks=3, utts_per_task=8, min_sec=4.0,
        max_sec=7.9, seed=1)
    vocab = Vocab.from_json(labels)
    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 4, 8
    m.dim_inner, m.dropout = 512, 0.1
    cfg.data.src_bucket_frames = (800,)
    cfg.finalize()
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=0)
    support, _ = ds.sample_meta_batch(8, 1)
    model = build_model(cfg, len(vocab), dev)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(1e-4)
    state = init_train_state(model, opt)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    native.reset_launch_counts()
    state, loss, _ = make_joint_step(model, cfg, opt)(
        state, batch_to_device(support, dev),
        torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    c = native.launch_counts
    assert c["vgg_block1"] == c["vgg_block2"] == c["vgg_stack_bwd"] == 3, c
    assert c["stft_logmag"] == 3 and c["stft_logmag_direct"] == 0, c
    assert torch.isfinite(loss)
    moved = sum(int((state.params[k] != v).sum()) for k, v in before.items())
    assert moved > 0.5 * sum(v.numel() for v in before.values())


class _GradRecorder:
    """An optimizer that keeps the gradients (on the CPU) and moves
    nothing."""

    def init(self, params):
        from mtl_tpu_torch.train.optim import AdamState

        return AdamState(0, {}, {})

    def update(self, grads, state, params):
        self.grads = {k: g.detach().cpu() for k, g in grads.items()}
        return state


def _trainer_inputs(tmp_path):
    """(config at f32, dropout 0, plain SGD for the discriminator; vocab;
    MAML support and per-task query of 3 tasks x 2 utterances; a shared
    query of 2; weights of the model and of the discriminator with nonzero
    conv biases)."""
    from mtl_tpu_torch.data.dataset import SpectrogramDataset
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.models.discriminator import (Discriminator,
                                                    init_discriminator)

    manifests, labels = make_synthetic_corpus(
        str(tmp_path), num_tasks=3, utts_per_task=4, min_sec=1.0,
        max_sec=1.9, seed=4)
    vocab = Vocab.from_json(labels)
    cfg, model = _tiny_asr(len(vocab), "float32")
    cfg.data.src_bucket_frames = (200,)
    t = cfg.train
    t.opt_name, t.lr, t.lr_disc, t.clip, t.max_norm = "sgd", 1e-2, 0.1, \
        True, 0.5
    ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True, seed=1)
    support, query = ds.sample_meta_batch(2, 2, per_task_query=True)
    shared = {k: v[-1] for k, v in query.items()}
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for conv in model.conv.convs:
            conv.bias.copy_(torch.from_numpy(
                rng.randn(conv.bias.numel()).astype(np.float32) * 0.1))
    disc = Discriminator(cfg.model.dim_model, t.num_class)
    init_discriminator(disc, torch.Generator().manual_seed(2))
    return cfg, vocab, (support, query, shared), model.state_dict(), \
        disc.state_dict()


def _trainer_step(kind, d, cfg, vocab, batches, weights, dweights):
    """One f32 step of ``kind`` on device ``d`` from the given weights:
    (loss, model gradients, discriminator params after its SGD update or
    None)."""
    from mtl_tpu_torch.models.discriminator import Discriminator
    from mtl_tpu_torch.models.transformer import build_model
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_joint_step, make_meta_step)
    from mtl_tpu_torch.train.steps_disc import (init_disc_state,
                                                make_joint_step_disc,
                                                make_meta_step_disc)

    cfg.train.adversarial = kind == "joint_adversarial"
    cfg.train.multitask = kind == "meta_multitask"
    support, query, shared = (batch_to_device(b, d) for b in batches)
    model = build_model(cfg, len(vocab), d)
    model.load_state_dict(weights)
    rec = _GradRecorder()
    state = init_train_state(model, rec)
    disc = None
    if kind in ("joint_adversarial", "meta_multitask"):
        disc = Discriminator(cfg.model.dim_model, cfg.train.num_class).to(d)
        state = init_disc_state(disc, cfg, state)
        disc.load_state_dict(dweights)
    if kind == "maml":
        _, m = make_meta_step(model, cfg, rec, per_task_query=True)(
            state, support, query)
        loss = m["outer_loss"]
    elif kind == "meta_multitask":
        _, m = make_meta_step_disc(model, disc, cfg, rec)(state, support,
                                                          shared)
        loss = m["outer_loss"]
    elif kind == "joint_adversarial":
        _, loss, _ = make_joint_step_disc(model, disc, cfg, rec)(
            state, support, None, 0.7)
    else:  # the epoch trainer's step: one task's batch as K = 1
        _, loss, _ = make_joint_step(model, cfg, rec)(
            state, {k: v[:1] for k, v in support.items()})
    after = None if disc is None else {
        k: v.detach().cpu() for k, v in disc.state_dict().items()}
    return float(loss), rec.grads, after


@pytest.mark.parametrize("kind", ["maml", "joint_adversarial",
                                  "meta_multitask", "epoch_noam"])
def test_maml_disc_epoch_f32_steps_on_the_card_match_the_cpu(dev, tmp_path,
                                                            kind):
    """One f32 step of each of these training paths on the card (the f32 VGG
    kernels and the stack's backward, the FFT STFT) against the CPU (plain
    versions) from the same weights and batches: the loss within 1e-3
    relative, the model's gradients rtol 1e-3 with atol 1e-3 of the
    largest (cuDNN's backward against the CPU's conv sums them in other
    orders), the discriminator's params after its plain SGD step within
    1e-3 of its largest move; for the epoch step also Noam Adam's update
    of the CPU's gradients on both devices: each param within 1e-6 of the
    larger of its values before and after the update (where the first
    step's move, ~lr, nearly cancels a param of the same size, the
    devices' rounding of the operands reads ~10x larger relative to the
    result)."""
    from mtl_tpu_torch.train.optim import make_epoch_optimizer

    cfg, vocab, batches, weights, dweights = _trainer_inputs(tmp_path)
    native.reset_launch_counts()
    card = _trainer_step(kind, dev, cfg, vocab, batches, weights, dweights)
    torch.cuda.synchronize()
    c = dict(native.launch_counts)
    cpu = _trainer_step(kind, torch.device("cpu"), cfg, vocab, batches,
                       weights, dweights)
    assert c["vgg_block1_f32"] >= 1 and c["vgg_block2_f32"] >= 1, c
    assert c["vgg_stack_bwd"] >= 1 and c["stft_logmag"] >= 1, c
    assert abs(card[0] - cpu[0]) <= 1e-3 * abs(cpu[0]), (card[0], cpu[0])
    scale = max(float(g.abs().max()) for g in cpu[1].values())
    for k, g in cpu[1].items():
        torch.testing.assert_close(card[1][k], g, rtol=1e-3,
                                   atol=1e-3 * scale)
    if cpu[2] is not None:
        top = max(float((cpu[2][k] - v).abs().max())
                  for k, v in dweights.items())
        assert top > 0
        for k, v in cpu[2].items():
            torch.testing.assert_close(card[2][k], v, rtol=0,
                                       atol=1e-3 * top)
    if kind == "epoch_noam":
        moved = []
        for d in (dev, torch.device("cpu")):
            opt = make_epoch_optimizer(cfg)
            params = {k: v.clone().to(d) for k, v in weights.items()
                      if k in cpu[1]}
            opt.update({k: g.to(d) for k, g in cpu[1].items()},
                       opt.init(params), params)
            moved.append({k: v.cpu() for k, v in params.items()})
        for k, v in moved[1].items():
            scale = torch.maximum(weights[k].abs(), v.abs())
            off = (moved[0][k] - v).abs()
            assert bool((off <= 1e-6 * scale).all()), (
                k, float(off.max()), float((off / scale).max()))


# -- the training-options and front-end slice ------------------------------

def _check_vgg_width(dev, block, dtype, bins):
    """Block 1 at F = ``bins`` (batch 8, 800 frames), block 2 at bins // 2,
    on the route ``dtype`` picks, against the plain version."""
    if block == 1:
        x, ws = _vgg_inputs(dev, (8, 800, bins), 1, 64, dtype, 3)
        fn = vgg_block1
    else:
        x, ws = _vgg_inputs(dev, (8, 400, bins // 2, 64), 64, 128, dtype, 4)
        x = x.relu()
        fn = vgg_block2
    out = _run_route(fn, x, ws, dtype, block)
    ref = vgg_block_plain(x, *ws, out_dtype=dtype)
    assert out.shape == ref.shape == (8, x.shape[1] // 2, x.shape[2] // 2,
                                      ws[0].shape[-1])
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("block", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_kernels_at_the_log_fbank_width(dev, block, dtype):
    """--feat logfbank: block 1 at F = 80 (batch 8, 800 frames), block 2
    at F = 40, both routes against their plain versions."""
    _check_vgg_width(dev, block, dtype, 80)


@pytest.mark.parametrize("block", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_kernels_at_the_22k_width(dev, block, dtype):
    """--sample-rate 22050: block 1 at F = 221 (odd F floors at the pool),
    block 2 at F = 110, both routes against their plain versions."""
    _check_vgg_width(dev, block, dtype, 221)


def test_device_cer_on_cuda_tensors_equals_the_cpu(dev):
    from mtl_tpu_torch.ops.edit_distance import device_cer

    g = torch.Generator().manual_seed(0)
    hyp = torch.randint(0, 40, (24, 65), generator=g)
    gold = torch.randint(0, 40, (24, 65), generator=g)
    gold[3, 20:] = 0
    want = [int(v) for v in device_cer(hyp, gold, space_id=5)]
    got = device_cer(hyp.to(dev), gold.to(dev), space_id=5)
    assert all(v.device.type == "cuda" for v in got)
    assert [int(v) for v in got] == want


def test_emb_cnn_batch_norm_on_the_card_equals_the_cpu(dev):
    """emb_cnn's convs (cuDNN, f32, TF32 off) and flax's BatchNorm in
    training mode: outputs and reported running statistics within 1e-4
    relative; evaluation mode reads the buffers."""
    from mtl_tpu_torch.models.subsampler import FeatureExtractor

    g = torch.Generator().manual_seed(1)
    fx = FeatureExtractor("emb_cnn", dtype=torch.float32)
    with torch.no_grad():
        for p in fx.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05 + (
                1.0 if p.dim() == 1 and p.shape[0] == 32 else 0.0))
    feats = torch.randn(4, 200, 161, generator=g)
    res = []
    for d in (dev, torch.device("cpu")):
        m = FeatureExtractor("emb_cnn", dtype=torch.float32).to(d)
        m.load_state_dict(fx.state_dict())
        stats = []
        y = m(feats.to(d), True, stats)
        res.append([y.cpu(), *(t.cpu() for s in stats for t in s),
                    m(feats.to(d)).cpu()])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_ctc_loss_on_the_card_equals_the_cpu(dev):
    """The optax-form CTC (an infeasible row included) and its gradients
    on the card against the CPU, f32, within 1e-5 relative."""
    from mtl_tpu_torch.train.losses import ctc_loss

    g = torch.Generator().manual_seed(2)
    logits = torch.randn(8, 33, 40, generator=g)
    targets = torch.randint(1, 40, (8, 32), generator=g)
    tlens = torch.tensor([32, 10, 0, 5, 20, 31, 1, 7])
    for i, n in enumerate(tlens):
        targets[i, n:] = 0
    in_lens = torch.tensor([33, 33, 10, 2, 33, 30, 33, 15])  # row 3 fails
    out = []
    for d in (dev, torch.device("cpu")):
        x = logits.to(d).requires_grad_(True)
        loss = ctc_loss(torch.log_softmax(x, -1), in_lens.to(d),
                        targets.to(d), tlens.to(d))
        loss.backward()
        out.append((loss.detach().cpu(), x.grad.cpu()))
    assert torch.isfinite(out[0][0])
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4,
                               atol=1e-4 * float(out[1][1].abs().max()))


# -- second order, remat and the Conformer ------------------------------------

def _small_cfg(encoder="transformer", dtype="float32", dropout=0.0):
    from mtl_tpu_torch.config import Config

    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 2, 1, 4
    m.dim_model = m.dim_emb = m.dim_inner = 64
    m.dim_key = m.dim_value = 16
    m.r, m.dtype, m.dropout, m.encoder_type = 8, dtype, dropout, encoder
    m.linear_units, m.cgmlp_linear_units = 128, 192
    m.cgmlp_conv_kernel, m.merge_conv_kernel = 31, 7
    cfg.train.lr, cfg.train.clip, cfg.train.max_norm = 0.05, True, 0.5
    return cfg.finalize()


def _audio_batches(k, b=2, samples=6400, seed=0, labels=6):
    rng = np.random.RandomState(seed)
    return {"audio": torch.from_numpy(
                (rng.randn(k, b, samples + 320) * 0.1).astype(np.float32)),
            "audio_lengths": torch.tensor([[samples, samples - 1600]] * k),
            "targets": torch.from_numpy(rng.randint(3, 20, (k, b, labels))),
            "src_percentages": torch.ones(k, b)}


def test_conformer_encoder_on_the_card_matches_the_cpu(dev):
    """A 2-block Conformer (d 64) at f32 on the card against the CPU, a
    padded row included: rtol/atol 1e-4 (summation order only)."""
    from mtl_tpu_torch.models.conformer import ConformerEncoder
    from mtl_tpu_torch.models.transformer import init_weights

    enc = ConformerEncoder(2, 4, 64, 96, dropout=0.0, dtype=torch.float32)
    init_weights(enc, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 50, 96).astype(np.float32))
    lengths = torch.tensor([50, 33, 50])
    with torch.no_grad():
        want = enc(x, lengths)
        got = enc.to(dev)(x.to(dev), lengths.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert bool((got[1, 33:] == 0).all())


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_second_order_meta_step_on_the_card_matches_the_cpu(dev, encoder):
    """One f32 second-order meta step (inner clip on) from the same weights
    and batches on the card and the CPU: the outer gradients rtol 1e-3
    with atol 1e-3 of the largest; the VGG stack runs its plain version
    (no VGG kernel, no ``vgg_stack_bwd``), the FFT STFT K + 1 times."""
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.train.steps import init_train_state, make_meta_step

    cfg = _small_cfg(encoder)
    cfg.train.second_order = True
    support = _audio_batches(2)
    query = {k: v[0] for k, v in _audio_batches(1, seed=1).items()}
    weights = None
    grads = []
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg, 20, d)
        if weights is None:
            init_weights(model, torch.Generator().manual_seed(0))
            weights = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        rec = _GradRecorder()
        native.reset_launch_counts()
        make_meta_step(model, cfg, rec)(
            init_train_state(model, rec),
            {k: v.to(d) for k, v in support.items()},
            {k: v.to(d) for k, v in query.items()})
        if d == dev:
            torch.cuda.synchronize()
            c = dict(native.launch_counts)
        grads.append(rec.grads)
    assert c["stft_logmag"] == 3, c
    assert c["vgg_block1"] == c["vgg_block2"] == c["vgg_stack_bwd"] == 0, c
    assert c["vgg_block1_f32"] == c["vgg_block2_f32"] == 0, c
    scale = max(float(g.abs().max()) for g in grads[1].values())
    for k, g in grads[1].items():
        torch.testing.assert_close(grads[0][k].cpu(), g, rtol=1e-3,
                                   atol=1e-3 * scale)


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_remat_on_the_card_keeps_loss_gradients_and_generator(dev, encoder):
    """bf16, dropout 0.1, ``--remat --remat-conv`` on against off from one
    CUDA generator seed: equal loss and generator state after the
    backward, gradients within 2^-8 of the largest (one bf16 ulp of it:
    cuBLAS may pick another bf16 GEMM algorithm for the recompute's
    buffers, and a bf16 activation one ulp off carries into the
    gradients; a mask drawn anew in the recompute would move them by far
    more)."""
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.train.steps import make_forward_fn

    batch = {k: v[0].to(dev) for k, v in _audio_batches(1).items()}
    runs = []
    for on in (False, True):
        cfg = _small_cfg(encoder, "bfloat16", 0.1)
        cfg.model.remat = cfg.model.remat_conv = on
        model = build_model(cfg, 20, dev)
        init_weights(model, torch.Generator().manual_seed(0))
        gen = torch.Generator(dev).manual_seed(3)
        native.reset_launch_counts()
        loss, _ = make_forward_fn(model, cfg)(None, batch, gen, False)
        g = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        runs.append((loss.detach(), g, gen.get_state(),
                     dict(native.launch_counts)))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    scale = max(float(g.abs().max()) for g in g0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -8 * scale)
    # --remat-conv runs the VGG kernels again in the recompute
    assert c0["vgg_block1"] == 1 and c1["vgg_block1"] == 2, (c0, c1)
    assert c0["vgg_stack_bwd"] == c1["vgg_stack_bwd"] == 1, (c0, c1)


def _mesh_case(kind, shape, support, query, cfg, weights):
    return {"kind": kind, "shape": shape, "cfg": cfg.to_json(),
            "vocab_size": 20, "state_dict": weights,
            "support": {k: v.numpy() for k, v in support.items()},
            "query": {k: v.numpy() for k, v in query.items()}}


def test_two_rank_gloo_meta_step_on_one_card_matches_one_process(dev):
    """A first-order meta step (inner and outer clip) on (task 1, data 2),
    two ranks sharing the card over gloo (tests/torch_mesh_worker.py),
    against the same step in this process on the card, f32: outer loss
    1e-5 relative, outer gradients within 1e-4 of the largest, and every
    rank holding the same weights after it."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.parallel import launch
    from mtl_tpu_torch.train.steps import init_train_state, make_meta_step
    from torch_mesh_worker import RecordingAdam, run_step_cases

    cfg = _small_cfg()
    support = _audio_batches(2)
    query = {k: v[0] for k, v in _audio_batches(1, seed=1).items()}
    model = build_model(cfg, 20, dev)
    init_weights(model, torch.Generator().manual_seed(0))
    weights = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    mesh_cfg = Config()
    mesh_cfg.mesh.data = 2
    got = launch.run(mesh_cfg, dev, run_step_cases, [_mesh_case(
        "meta", (1, 2), support, query, cfg, weights)], "cuda")[0]
    assert launch.backend_for(dev, 2) == (
        "nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert got["same_on_every_rank"]
    opt = RecordingAdam(cfg.train.meta_lr)
    _, m = make_meta_step(model, cfg, opt)(
        init_train_state(model, opt),
        {k: v.to(dev) for k, v in support.items()},
        {k: v.to(dev) for k, v in query.items()})
    np.testing.assert_allclose(got["metrics"]["outer_loss"],
                               float(m["outer_loss"]), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in opt.grads.values())
    for k, g in opt.grads.items():
        np.testing.assert_allclose(got["grads"][k], g.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_sp_on_the_card_matches_the_unsharded_encode(dev, dtype):
    """The sequence-parallel encode over 2 ranks sharing the card (the VGG
    kernels on each rank's haloed slice, K/V all-gathered) against the
    unsharded encode on the card, 1001 frames (no multiple of 8), d 64. f32:
    within 1e-5. bf16: the two encodes' linears run GEMMs of other shapes
    (125 and 250 rows a batch row), whose f32 sums may round to
    neighbouring bf16 values, and the next layers carry that on (1.5 ulps
    of the largest output apart on an H100; at the flagship width,
    chip_smoke.py phase 29, they are equal). So each is held to the f32
    encode of the same weights: the sequence-parallel one no further from
    it than the unsharded bf16 one, by its largest difference (x 1.25) and
    its mean difference (x 1.1)."""
    from mtl_tpu_torch.config import Config
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.parallel import launch
    from torch_mesh_worker import run_encode_cases

    cfg = _small_cfg(dtype=dtype)
    model = build_model(cfg, 20)
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    mesh_cfg = Config()
    mesh_cfg.mesh.data = 2
    got = launch.run(mesh_cfg, dev, run_encode_cases, [{
        "shape": (1, 2), "cfg": cfg.to_json(), "vocab_size": 20,
        "reference_cfg": _small_cfg(dtype="float32").to_json(),
        "state_dict": {k: v.numpy() for k, v in model.state_dict().items()},
        "features": rng.randn(2, 1001, 161).astype(np.float32),
        "lengths": np.array([1001, 700], np.int32)}], "cuda")[0]
    if dtype == "float32":
        assert float(np.abs(got["sp"] - got["plain"]).max()) <= 1e-5
    else:
        sp, plain = (np.abs(got[k] - got["reference"]) for k in ("sp",
                                                                  "plain"))
        assert float(sp.max()) <= 1.25 * float(plain.max())
        assert float(sp.mean()) <= 1.1 * float(plain.mean())
    suffix = "" if dtype == "bfloat16" else "_f32"
    assert all(c[f"vgg_block1{suffix}"] == c[f"vgg_block2{suffix}"] == 1
               for c in got["sp_counts"]), got["sp_counts"]


# -- the graph-replayed meta step ----------------------------------------------

def _graph_run(dev, cfg, per_task_query, graphed, keys):
    """(metrics by step, state, model, generator, launch counts) of meta
    steps over ``keys`` (seed, samples, labels) from seeded weights: the
    eager step on the caller's stream, or ``GraphedMetaStep`` on host
    batches."""
    from mtl_tpu_torch.models.transformer import build_model, init_weights
    from mtl_tpu_torch.train.graphs import GraphedMetaStep
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                           make_meta_step)

    model = build_model(cfg, 20, dev)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(1e-3)
    state = init_train_state(model, opt)
    if graphed:
        step = GraphedMetaStep(model, cfg, opt, dev, per_task_query,
                               space_id=3)
    else:
        step = make_meta_step(model, cfg, opt, per_task_query, space_id=3)
    gen = torch.Generator(dev).manual_seed(3)
    native.reset_launch_counts()
    out = []
    for seed, samples, labels in keys:
        support = _audio_batches(3, samples=samples, seed=seed,
                                 labels=labels)
        query = _audio_batches(3 if per_task_query else 1, samples=samples,
                               seed=seed + 100, labels=labels)
        if not per_task_query:
            query = {k: v[0] for k, v in query.items()}
        if graphed:
            batches = [{k: v.numpy() for k, v in b.items()}
                       for b in (support, query)]
        else:
            batches = [batch_to_device(b, dev) for b in (support, query)]
        state, metrics = step(state, *batches, gen)
        out.append(metrics)
    torch.cuda.synchronize()
    counts = dict(native.launch_counts)
    if graphed:
        assert sorted(step.sightings.values()) == [1, 3, 3], step.sightings
        assert len(step.entries) == 2
        # each replay after its capture's own launches the capture's kernels
        assert [e.replays for e in step.entries.values()] == [2, 2]
        for e in step.entries.values():
            for k, n in e.launches.items():
                counts[k] += n * (e.replays - 1)
        assert (counts.pop("meta_graph_captures"),
                counts.pop("meta_graph_replays")) == (2, 4)
    return out, state, model, gen, counts


@pytest.mark.parametrize("per_task_query,feat_extractor",
                         [(False, "vgg_cnn"), (True, "vgg_cnn"),
                          (False, "emb_cnn")])
def test_graphed_meta_step_on_the_card_matches_the_eager_step(
        dev, monkeypatch, per_task_query, feat_extractor):
    """bf16, dropout 0.1, the inner clip on, ``--device-cer``: the meta step
    replayed as CUDA graphs (keys A, A, B, B, A, C, B: B's graph captured
    after A's into the shared pool, A replayed after B, C seen once and
    run eagerly) against the eager step on the same batches from the same
    weights and generator seed. Every step's metrics, the weights, Adam's
    moments and count, the step counter, emb_cnn's running statistics and
    the generator state after the last step: floats bit-equal or within
    2^-8 of the largest element (one bf16 ulp of it, where a library picks
    another algorithm under capture), integers and the generator equal.
    The kernel launches (those counted at the eager steps and the captures,
    and each capture's again for every later replay of its graph) are the
    eager run's; 2 captures and 4 replays are counted. cuDNN runs its
    deterministic algorithms in both runs: the VGG backward's f32 weight
    gradients otherwise differ from one eager run to the next, and Adam
    turns a gradient near zero that changes sign into a step of 2 lr."""
    _graphed_against_eager(dev, monkeypatch, per_task_query, feat_extractor)


def test_graphed_e_branchformer_meta_step_matches_the_eager_step(
        dev, monkeypatch):
    """The same with a 2-block E-Branchformer encoder (relative-position
    attention, cgMLP, merge; d 64, cgMLP 192, kernels 31 and 7): its
    relative table is computed on the card inside the capture."""
    _graphed_against_eager(dev, monkeypatch, False, "vgg_cnn",
                           "e_branchformer")


def _graphed_against_eager(dev, monkeypatch, per_task_query, feat_extractor,
                           encoder="transformer"):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = _small_cfg(encoder, dtype="bfloat16", dropout=0.1)
    cfg.model.feat_extractor = feat_extractor
    cfg.train.device_cer = True
    cfg.finalize()
    a, b, c = (6400, 6), (9600, 10), (8000, 6)
    keys = [(1, *a), (2, *a), (3, *b), (4, *b), (5, *a), (6, *c), (7, *b)]
    want, s0, m0, g0, c0 = _graph_run(dev, cfg, per_task_query, False, keys)
    for k in ("meta_graph_captures", "meta_graph_replays"):
        assert c0.pop(k) == 0
    got, s1, m1, g1, c1 = _graph_run(dev, cfg, per_task_query, True, keys)

    def close(w, g, what):
        w, g = w.detach(), g.detach()
        if not w.is_floating_point():
            assert torch.equal(w, g), what
            return
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=0, atol=2.0 ** -8 * scale,
                                   msg=what)

    exact = True
    for i, (w, g) in enumerate(zip(want, got)):
        assert set(w) == set(g)
        for k in w:
            close(w[k], g[k], f"step {i + 1} {k}")
            exact &= torch.equal(w[k], g[k])
    assert (s1.step, s1.opt_state.count) == (s0.step, s0.opt_state.count) \
        == (len(keys), len(keys))
    for n in s0.params:
        for group, w, g in (("param", s0.params, s1.params),
                            ("mu", s0.opt_state.mu, s1.opt_state.mu),
                            ("nu", s0.opt_state.nu, s1.opt_state.nu)):
            close(w[n], g[n], f"{group} {n}")
            exact &= torch.equal(w[n], g[n])
    stats = [[t for pair in m.conv.batch_stats() for t in pair]
             for m in (m0, m1)]
    assert len(stats[0]) == (4 if feat_extractor == "emb_cnn" else 0)
    for w, g in zip(*stats):
        close(w, g, "running statistics")
        exact &= torch.equal(w, g)
    assert torch.equal(g0.get_state(), g1.get_state())
    assert c0 == c1, (c0, c1)
    print(f"graphed against eager, {per_task_query=} {feat_extractor} "
          f"{encoder}: bit-equal {exact}")
