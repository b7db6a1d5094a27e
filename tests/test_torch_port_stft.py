"""The Python side of the port's STFT kernel routes, on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_port_
cuda.py). Here: the radix plan and the route that each n_fft takes, the
twiddle table and the launch shape the FFT kernel is given, a numpy mirror
of the FFT kernel's index arithmetic (Stockham stages on the plan and the
table, then the real split step) against the plain version, and the
front-end through the wrapper's signature against the JAX package; and
the parallel build of the kernel sources, with a stand-in compiler.
Tolerances: the mirror runs in float64 on the f32 table and window, the
plain version in f32 (1e-4 on log magnitudes of O(1-100) spectra); the
JAX comparison is the f32 one of tests/test_torch_port_frontend.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.ops import frontend as jfe
from mtl_tpu_torch.data.dataset import collate_audio
from mtl_tpu_torch.ops import frontend as fe
from mtl_tpu_torch.ops import native
from mtl_tpu_torch.ops import stft as st
from tests.torch_threads import one_torch_thread  # noqa: F401

SR = 16000

PLANS = {160: (5, 4, 4), 320: (5, 4, 8), 400: (5, 5, 8), 441: None,
         448: None, 480: (5, 3, 4, 4), 512: (4, 8, 8)}


@pytest.mark.parametrize("n_fft", sorted(PLANS))
def test_fft_plan_and_route(n_fft):
    plan = st.fft_plan(n_fft)
    assert plan == PLANS[n_fft]
    if plan is None:
        assert st.stft_route(n_fft) == "direct"
        return
    assert st.stft_route(n_fft) == "fft"
    assert int(np.prod(plan)) == n_fft // 2
    assert set(plan) <= set(st.FFT_RADICES)
    # odd radices first, where the stride-R writes are conflict-free
    odd = [r for r in plan if r % 2]
    assert list(plan[:len(odd)]) == odd


@pytest.mark.parametrize("n_fft", [4, 6, 14, 2 * 2 * 3 ** 7, 2 * 5 ** 6])
def test_fft_route_refuses(n_fft):
    """Too small, a factor 7, more stages than the packed plan holds
    (2 * 3^7: eight), more shared memory than a block has (5^6)."""
    assert st.fft_plan(n_fft) is None
    assert st.stft_route(n_fft) == "direct"


def test_pack_plan():
    assert st.pack_plan((5, 4, 8)) == 0x845
    for n_fft in (160, 250, 320, 400, 480, 512, 8192):
        plan = st.fft_plan(n_fft)
        packed = st.pack_plan(plan)
        assert packed < 2 ** 31
        got, s = [], 0
        while (packed >> (4 * s)) & 15:
            got.append((packed >> (4 * s)) & 15)
            s += 1
        assert tuple(got) == plan


@pytest.mark.parametrize("n_fft", [160, 320, 400, 512])
def test_fft_twiddles_match_numpy(n_fft):
    """W_N^p in float64, rounded to f32 once."""
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    got = st.fft_twiddles(n_fft)
    assert got.dtype == np.float32 and got.shape == (n_fft, 2)
    np.testing.assert_array_equal(got[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(got[:, 1], want.imag.astype(np.float32))


def test_device_fft_tables_are_built_once():
    dev = torch.device("cpu")
    first = st.device_fft_tables(320, "hamming", dev)
    assert st.device_fft_tables(320, "hamming", dev) is first
    win, tw = first
    np.testing.assert_array_equal(win.numpy(), st.WINDOWS["hamming"](320))
    np.testing.assert_array_equal(tw.numpy(), st.fft_twiddles(320))


@pytest.mark.parametrize("n_fft,frames,smem", [
    (320, 4, 14080),   # flagship: 4 warps, 13.75 KB
    (512, 4, 22528),
    (4096, 4, 180224),
    (8192, 2, 229376),  # 4 frames would take 352 KB
])
def test_fft_launch_shape(n_fft, frames, smem):
    """The most frames (<= 4) that fit in a block's shared memory; the byte
    count follows the layout in csrc/stft_fft.cu's note."""
    assert st.fft_launch_shape(n_fft) == (frames, smem)
    assert smem <= st.FFT_SMEM_MAX
    if frames < st.FFT_MAX_FRAMES:
        assert st.fft_smem_bytes(n_fft, 2 * frames) > st.FFT_SMEM_MAX
    m = n_fft // 2
    assert smem >= 12 * n_fft + 2 * 8 * frames * m


def _fft_kernel_mirror(audio, n_fft, hop, n_frames, window):
    """What csrc/stft_fft.cu computes, index for index, in float64 numpy:
    the packed frame z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1], the Stockham
    stages of the plan with twiddles from the table, the real split."""
    plan = st.fft_plan(n_fft)
    n, m = n_fft, n_fft // 2
    tw = st.fft_twiddles(n).astype(np.float64)
    tw = tw[:, 0] + 1j * tw[:, 1]
    win = st.WINDOWS[window](n).astype(np.float64)
    frames = st.frames_from_prepadded(torch.from_numpy(audio), n, hop,
                                      n_frames).numpy().astype(np.float64)
    x = frames * win
    src = x[..., 0::2] + 1j * x[..., 1::2]
    ns = 1
    for r in plan:
        nb, step = m // r, n // (ns * r)
        j = np.arange(nb)
        k = j % ns
        v = np.stack([src[..., j + q * nb] * tw[k * q * step]
                      for q in range(r)])
        v = np.fft.fft(v, axis=0)
        dst = np.empty_like(src)
        base = (j // ns) * ns * r + k
        for q in range(r):
            dst[..., base + q * ns] = v[q]
        src, ns = dst, ns * r
    z = src
    k = np.arange(m // 2 + 1)
    a, c = z[..., k], np.conj(z[..., (m - k) % m])
    xe, xo = (a + c) / 2, -1j * (a - c) / 2
    p = tw[k] * xo
    out = np.empty(z.shape[:-1] + (m + 1,))
    out[..., m - k] = np.log1p(np.abs(xe - p))
    out[..., k] = np.log1p(np.abs(xe + p))
    return out


@pytest.mark.parametrize("b,t,n_fft,hop,short", [
    (2, 37, 320, 160, 0), (1, 50, 400, 160, 0), (2, 33, 160, 80, 0),
    (1, 9, 480, 160, 0), (1, 7, 512, 160, 0), (1, 1, 320, 160, 0),
    (2, 21, 320, 160, 250),  # waveform 250 samples short: zero tail
    (1, 12, 250, 100, 0),  # odd half (125 = 5^3)
])
def test_fft_kernel_mirror_matches_plain(b, t, n_fft, hop, short):
    rng = np.random.RandomState(t)
    s = (t - 1) * hop + n_fft - short
    audio = rng.uniform(-0.5, 0.5, (b, s)).astype(np.float32)
    got = _fft_kernel_mirror(audio, n_fft, hop, t, "hamming")
    cos_b, nsin_b = (torch.from_numpy(x)
                     for x in st.dft_matrices(n_fft, "hamming"))
    want = st.stft_logmag_plain(torch.from_numpy(audio), cos_b, nsin_b, t,
                                hop).numpy()
    assert got.shape == want.shape == (b, t, n_fft // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft", [320, 448])
def test_stft_logmag_cpu_runs_plain(n_fft):
    """CPU tensors take the plain version whatever the route, and count no
    launch."""
    rng = np.random.RandomState(1)
    audio = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (2, 9 * 160 + n_fft)).astype(np.float32))
    before = dict(native.launch_counts)
    got = st.stft_logmag(audio, n_fft, 160, 10, "hann")
    assert native.launch_counts == before
    cos_b, nsin_b = (torch.from_numpy(x)
                     for x in st.dft_matrices(n_fft, "hann"))
    want = st.stft_logmag_plain(audio, cos_b, nsin_b, 10, 160)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_stft_logmag_rejects_bad_arguments():
    audio = torch.zeros(2, 800)
    for args in ((audio.double(), 320, 160, 4), (audio[0], 320, 160, 4),
                 (audio, 320, 0, 4), (audio, 320, 160, 4, "kaiser")):
        with pytest.raises(ValueError):
            st.stft_logmag(*args)


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (448, 160), (160, 80)])
def test_log_spectrogram_matches_jax_by_route(n_fft, hop):
    """The front-end through stft_logmag's (n_fft, hop, n_frames, window)
    signature on a ragged batch, for n_fft of both routes, against the
    JAX package's XLA path."""
    rng = np.random.RandomState(n_fft)
    lengths = [3000, 1711, 400]
    waves = [(0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / SR)
              + 0.05 * rng.randn(n)).astype(np.float32) for n in lengths]
    frames = 1 + max(lengths) // hop
    batch = collate_audio(waves, [[1]] * 3, hop, (frames,), (4,), 4000,
                          n_fft=n_fft)
    audio, alen = batch["audio"], batch["audio_lengths"]
    feats, flen = fe.log_spectrogram(torch.from_numpy(audio),
                                     torch.from_numpy(alen), n_fft, hop,
                                     prepadded=True)
    jfeats, jflen = jfe.log_spectrogram(jnp.asarray(audio), jnp.asarray(alen),
                                        n_fft, hop, use_pallas=False,
                                        prepadded=True)
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))
    assert feats.shape == jfeats.shape == (3, frames, n_fft // 2 + 1)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-4,
                               atol=1e-4)


def test_fixed_kernel_instances_match_the_plans():
    """csrc/stft_fft.cu instantiates its kernel at compile time for some
    (n_fft, packed plan) pairs; each must be the plan fft_plan gives, or
    that n_fft would silently run the run-time instance instead."""
    with open(os.path.join(native.CSRC_DIR, "stft_fft.cu")) as f:
        fixed = re.findall(r"STFT_FFT_FIXED\((\d+), (0x[0-9a-f]+)\)", f.read())
    assert len(fixed) >= 5
    for n_fft, packed in fixed:
        assert st.pack_plan(st.fft_plan(int(n_fft))) == int(packed, 16)


@pytest.mark.parametrize("fail", [False, True])
def test_build_times_each_source(tmp_path, monkeypatch, fail):
    """native.build runs one compiler process per source at once and
    reports each one's seconds and output; a failed compile raises with
    its output and leaves no library behind. A stand-in for nvcc (this
    host has none) writes its -o target."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ptxas info : Used 48 registers'\n"
                    + ("exit 3\n" if fail else "")
                    + 'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(native, "_nvcc", lambda: str(fake))
    if fail:
        with pytest.raises(RuntimeError, match="Used 48 registers"):
            native.build(["stft_fft"])
        assert not os.listdir(tmp_path / "kernels")
        return
    reports = native.build()
    assert sorted(reports) == sorted(native.SOURCES)
    for name, (seconds, log) in reports.items():
        assert seconds > 0 and "Used 48 registers" in log
        assert os.path.exists(native.so_path(name))
    assert native.build() == {}  # built: nothing to do


def test_stft_ablation_variants_apply(monkeypatch):
    """The ablation tool's text edits still hit csrc/stft_fft.cu, and the
    tool refuses to run without a card."""
    from mtl_tpu_torch.cli import stft_ablation

    with open(os.path.join(native.CSRC_DIR, "stft_fft.cu")) as f:
        src = f.read()
    v = stft_ablation.variants(src)
    assert v["built"] == src
    for e in stft_ablation.EPILOGUE:
        assert e in src and e not in v["no_epilogue"]
    assert v["no_stages"] != src and v["runtime_plan"] != src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stft_ablation.main([]) == 1
