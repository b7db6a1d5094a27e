"""Windowed STFT -> log1p magnitude (kernel 1 of the port).

``stft_logmag`` replaces the Pallas TPU kernel
``mtl_tpu/ops/stft_pallas.py:stft_logmag_pallas``:
``out[b, t, k] = log1p(|sum_n w[n] audio[b, t*hop + n] e^{-2 pi i nk/n_fft}|)``
for k <= n_fft // 2, reading frame t of row b straight from the prepadded
waveform (samples past the end of a row are zeros). On a CUDA tensor it has
two routes, chosen by ``n_fft`` alone (``stft_route``):

* ``"fft"`` -- n_fft even and n_fft / 2 with no prime factor above 5
  (160, 320, 400, 480, 512, ...): ``csrc/stft_fft.cu``, a real FFT in
  shared memory and registers, one warp a frame, on the radices of
  ``fft_plan``; bound by bytes. Counted as ``stft_logmag``.
* ``"direct"`` -- any other n_fft (441 at 22.05 kHz, 882, 220, ...):
  ``csrc/stft_dft_tc.cu``, the DFT as one GEMM against the interleaved
  windowed bases on TF32 tensor cores at f32 accuracy (3xTF32, three
  passes of split operands; ``ops/tf32.py``), bound by the TF32 rate.
  Counted as ``stft_logmag_direct``.

A route that cannot launch raises; it never hands the work to the other
route or to the plain version. On a CPU tensor both run
``stft_logmag_plain``: materialised frames, two f32 matmuls against the
``dft_matrices`` bases, the same epilogue.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import native
from .tf32 import pack_tf32x3


def _cosine_window(n: int, coefs) -> np.ndarray:
    if n == 1:
        return np.ones(1, dtype=np.float32)
    k = np.arange(n, dtype=np.float64)
    w = sum(a * np.cos(2.0 * np.pi * i * k / (n - 1))
            for i, a in enumerate(coefs))
    return w.astype(np.float32)


def bartlett_window(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1, dtype=np.float32)
    k = np.arange(n, dtype=np.float64)
    return (1.0 - np.abs(2.0 * k / (n - 1) - 1.0)).astype(np.float32)


# symmetric windows, scipy.signal.<name>(n, sym=True) parity
WINDOWS = {
    "hamming": lambda n: _cosine_window(n, (0.54, -0.46)),
    "hann": lambda n: _cosine_window(n, (0.5, -0.5)),
    "blackman": lambda n: _cosine_window(n, (0.42, -0.5, 0.08)),
    "bartlett": bartlett_window,
}


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int, window: str = "hamming"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis: (cos [n_fft, F], -sin [n_fft, F]) with the
    window folded in, so spectrogram = frames @ basis."""
    f = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(f, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = WINDOWS[window](n_fft).astype(np.float64)[:, None]
    return (
        (np.cos(ang) * w).astype(np.float32),
        (-np.sin(ang) * w).astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def device_dft_matrices(n_fft: int, window: str, device: torch.device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dft_matrices`` copied to ``device`` once, so a served batch only
    launches the STFT. Read-only: callers must not write to them."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in dft_matrices(n_fft, window))


# -- the direct route -------------------------------------------------------

# csrc/stft_dft_tc.cu's tile: GEMM columns (re, im of 56 bins) a CTA, and
# samples a chunk of its K loop
DFT_TC_TN, DFT_TC_KC = 112, 16


def dft_tc_shape(n_fft: int) -> Tuple[int, int]:
    """(N, K) of the direct route's GEMM as packed: 2F columns (re, im of
    each bin) padded to a multiple of the CTA's 112, n_fft samples padded
    to a multiple of its 16-sample chunk."""
    n = -(-2 * (n_fft // 2 + 1) // DFT_TC_TN) * DFT_TC_TN
    return n, -(-n_fft // DFT_TC_KC) * DFT_TC_KC


def pack_dft_tc(n_fft: int, window: str = "hamming") -> torch.Tensor:
    """The direct kernel's B operand, f32 [N/112 tiles, K/16 chunks, 2 (hi,
    lo), 14, 4, 8, 4]: the windowed bases as an [n][k] matrix, column 2k =
    cos_k and 2k + 1 = -sin_k of ``dft_matrices``, zeros in the padding,
    split and in core matrices (``ops/tf32.py:pack_tf32x3``), in the order
    a CTA's stages take them: one contiguous block a (tile, chunk)."""
    cos_b, nsin_b = dft_matrices(n_fft, window)
    f = n_fft // 2 + 1
    n_pad, k_pad = dft_tc_shape(n_fft)
    m = np.zeros((n_pad, k_pad), dtype=np.float32)
    m[0:2 * f:2, :n_fft] = cos_b.T
    m[1:2 * f:2, :n_fft] = nsin_b.T
    tiles, chunks = n_pad // DFT_TC_TN, k_pad // DFT_TC_KC
    return pack_tf32x3(torch.from_numpy(m)).view(
        2, tiles, DFT_TC_TN // 8, chunks, DFT_TC_KC // 4, 8, 4).permute(
            1, 3, 0, 2, 4, 5, 6).contiguous()


@functools.lru_cache(maxsize=8)
def device_dft_tc_operands(n_fft: int, window: str, device: torch.device
                           ) -> torch.Tensor:
    """``pack_dft_tc`` on ``device``, made once per (n_fft, window,
    device), so a served batch only launches the STFT. Read-only."""
    return pack_dft_tc(n_fft, window).to(device)


# -- the FFT route ---------------------------------------------------------

FFT_RADICES = (2, 3, 4, 5, 8)
FFT_MAX_STAGES = 7  # the kernel takes the radices packed 4 bits each
FFT_MAX_FRAMES = 4  # frames (one warp each) per CTA
FFT_SMEM_MAX = 232448  # the 227 KB a block can opt into on sm_90


@functools.lru_cache(maxsize=None)
def fft_plan(n_fft: int) -> Optional[Tuple[int, ...]]:
    """Radices, in stage order, of the M = n_fft / 2 point complex FFT of the
    packed real frame; None when the FFT route does not take n_fft.

    Odd radices go first (the first stage's stride-R writes are
    bank-conflict-free for odd R), then the power of two as one 4 (or two,
    or a 2) and 8s."""
    if n_fft < 8 or n_fft % 2:
        return None
    m, odd = n_fft // 2, []
    for p in (5, 3):
        while m % p == 0:
            odd.append(p)
            m //= p
    e = 0
    while m % 2 == 0:
        e += 1
        m //= 2
    if m != 1:
        return None
    if e % 3 == 0:
        two = [8] * (e // 3)
    elif e % 3 == 1:
        two = [2] if e == 1 else [4, 4] + [8] * ((e - 4) // 3)
    else:
        two = [4] + [8] * ((e - 2) // 3)
    plan = tuple(odd + two)
    if len(plan) > FFT_MAX_STAGES or fft_smem_bytes(n_fft, 1) > FFT_SMEM_MAX:
        return None
    return plan


def pack_plan(plan: Tuple[int, ...]) -> int:
    """The radices as the kernel takes them: 4 bits each, first stage in the
    lowest bits, 0 after the last."""
    return sum(r << (4 * i) for i, r in enumerate(plan))


def fft_smem_bytes(n_fft: int, frames: int) -> int:
    """Dynamic shared memory of one CTA of ``csrc/stft_fft.cu`` (its header
    note gives the layout): the twiddle table, two [M] complex buffers a
    frame (M rounded up to even), the window."""
    m = n_fft // 2
    return 8 * n_fft + 2 * 8 * frames * (m + (m & 1)) + 4 * n_fft


def fft_launch_shape(n_fft: int) -> Tuple[int, int]:
    """(frames per CTA, shared bytes): the most frames, a power of two up to
    ``FFT_MAX_FRAMES``, whose buffers fit in a block's shared memory."""
    frames = FFT_MAX_FRAMES
    while frames > 1 and fft_smem_bytes(n_fft, frames) > FFT_SMEM_MAX:
        frames //= 2
    return frames, fft_smem_bytes(n_fft, frames)


@functools.lru_cache(maxsize=None)
def _fft_launch_args(n_fft: int) -> Tuple[int, int]:
    """(packed plan, frames per CTA), once per n_fft: the served path pays
    no Python for them."""
    return pack_plan(fft_plan(n_fft)), fft_launch_shape(n_fft)[0]


def stft_route(n_fft: int) -> str:
    """"fft" or "direct": the kernel a CUDA tensor of this n_fft launches."""
    return "fft" if fft_plan(n_fft) is not None else "direct"


def fft_twiddles(n_fft: int) -> np.ndarray:
    """W_N^p = e^{-2 pi i p / N} for p < N, computed in float64, as f32
    [N, 2] (re, im): the stage twiddles W_{Ns R}^{kr} = W_N^{kr N / (Ns R)}
    and the split step's W_N^k are all entries of it."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def device_fft_tables(n_fft: int, window: str, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window [N], twiddles [N, 2]) f32 on ``device``, made once per
    (n_fft, window, device). Read-only."""
    return (torch.from_numpy(WINDOWS[window](n_fft)).to(device),
            torch.from_numpy(fft_twiddles(n_fft)).to(device))


# -- the function and its routes -------------------------------------------

def frames_from_prepadded(audio: torch.Tensor, n_fft: int, hop: int,
                          n_frames: int) -> torch.Tensor:
    """[B, S] prepadded waveforms -> [B, n_frames, n_fft] frames, with zeros
    past the end (frame_signal's right pad when hop does not divide n_fft)."""
    need = (n_frames - 1) * hop + n_fft
    if audio.shape[1] < need:
        audio = F.pad(audio, (0, need - audio.shape[1]))
    return audio.unfold(1, n_fft, hop)[:, :n_frames]


def stft_logmag_plain(audio: torch.Tensor, cos_b: torch.Tensor,
                      nsin_b: torch.Tensor, n_frames: int,
                      hop: int) -> torch.Tensor:
    """Plain version: materialised frames, two f32 matmuls, epilogue."""
    frames = frames_from_prepadded(audio, cos_b.shape[0], hop, n_frames)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, nsin_b)
    return torch.log1p(torch.sqrt(re * re + im * im))


def stft_logmag(audio: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                window: str = "hamming") -> torch.Tensor:
    """log1p(|STFT|) [B, n_frames, n_fft // 2 + 1] of prepadded f32
    waveforms [B, S] under the symmetric ``window``."""
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError(f"stft_logmag takes float32 [B, S] audio, got "
                         f"{audio.dtype} {tuple(audio.shape)}")
    if window not in WINDOWS or n_fft < 1 or hop < 1 or n_frames < 0:
        raise ValueError(f"window {window!r}, n_fft {n_fft}, hop {hop}, "
                         f"n_frames {n_frames}")
    if audio.device.type == "cpu":
        cos_b, nsin_b = device_dft_matrices(n_fft, window, audio.device)
        return stft_logmag_plain(audio, cos_b, nsin_b, n_frames, hop)
    if audio.device.type != "cuda":
        raise ValueError(f"no stft_logmag kernel for {audio.device}")
    if stft_route(n_fft) == "fft":
        win, tw = device_fft_tables(n_fft, window, audio.device)
        return stft_logmag_fft(audio, win, tw, n_frames, hop)
    packed = device_dft_tc_operands(n_fft, window, audio.device)
    return stft_logmag_direct(audio, packed, n_fft, n_frames, hop)


def stft_logmag_fft(audio: torch.Tensor, window: torch.Tensor,
                    twiddles: torch.Tensor, n_frames: int,
                    hop: int) -> torch.Tensor:
    """The FFT route on CUDA tensors (``csrc/stft_fft.cu``): the window [N]
    and twiddle table [N, 2] of ``device_fft_tables``."""
    native.require_cuda(audio, window, twiddles)
    n_fft = window.shape[0]
    if fft_plan(n_fft) is None or twiddles.shape != (n_fft, 2):
        raise ValueError(f"no FFT plan for n_fft {n_fft}")
    packed, frames = _fft_launch_args(n_fft)
    b, s = audio.shape
    out = torch.empty((b, n_frames, n_fft // 2 + 1), dtype=torch.float32,
                      device=audio.device)
    if out.numel():
        native.launch("stft_fft", "stft_fft_f32", "stft_logmag",
                      audio.data_ptr(), window.data_ptr(),
                      twiddles.data_ptr(), out.data_ptr(), b, s, n_frames,
                      n_fft, hop, packed, frames)
    return out


def stft_logmag_direct(audio: torch.Tensor, packed: torch.Tensor,
                       n_fft: int, n_frames: int, hop: int) -> torch.Tensor:
    """The direct route on CUDA tensors (``csrc/stft_dft_tc.cu``), which
    takes any n_fft: ``packed`` is its B operand, ``pack_dft_tc(n_fft)``
    (``device_dft_tc_operands``)."""
    native.require_cuda(audio, packed)
    f = n_fft // 2 + 1
    tiles, chunks = packed.shape[:2] if packed.dim() == 7 else (0, 0)
    if (packed.dtype != torch.float32
            or packed.shape != (tiles, chunks, 2, DFT_TC_TN // 8,
                                DFT_TC_KC // 4, 8, 4)
            or DFT_TC_TN * tiles < 2 * f or DFT_TC_KC * chunks < n_fft):
        raise ValueError(f"packed basis {packed.dtype} "
                         f"{tuple(packed.shape)} for n_fft {n_fft}")
    b, s = audio.shape
    out = torch.empty((b, n_frames, f), dtype=torch.float32,
                      device=audio.device)
    if out.numel():
        native.launch("stft_dft_tc", "stft_dft_tc_f32", "stft_logmag_direct",
                      audio.data_ptr(), packed.data_ptr(), out.data_ptr(), b,
                      s, n_frames, n_fft, hop, f, tiles, chunks)
    return out
