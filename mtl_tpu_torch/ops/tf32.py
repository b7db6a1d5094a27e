"""The 3xTF32 split of the port's f32 tensor-core kernels, on the torch side.

``csrc/tf32x3.cuh`` runs an f32 product on the TF32 tensor cores as three
passes, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, with every f32 operand x split
into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``: the rounding of
``cvt.rna.tf32.f32`` (to nearest, ties away from zero) with the low 13 bits
cleared. The kernels split their A operands in registers. Their B operands
are packed here once in ``wgmma``'s K-major core matrices: the DFT basis
of ``ops/stft.py`` split into hi and lo (``pack_tf32x3``), the VGG weights
of ``ops/vgg.py`` as f32 (``core_matrices_tf32``), which the VGG kernels
split on their way into shared memory to halve the bytes they stream
(PERF.md). ``split_tf32`` is the bit-exact mirror of the device's
``split`` on the int32 view, on any device (the CPU tests emulate the
kernels with it):
hi + lo recovers a finite x to within 2^-22 relative; inf and nan pass
through as hi with lo = 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

_SIGN = -0x80000000   # 0x80000000 as int32
_LOW13 = -0x2000      # 0xffffe000 as int32
_EXP = 0x7F800000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 rounded to TF32 as cvt.rna.tf32.f32 with the low 13 bits
    cleared: the magnitude's bits + 2^12, truncated (a tie carries away
    from zero), sign kept; inf and nan unchanged."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    i = x.contiguous().view(torch.int32)
    mag = i & 0x7FFFFFFF
    r = ((mag + 0x1000) & _LOW13) | (i & _SIGN)
    return torch.where(mag < _EXP, r, i).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 ``x``: hi = tf32(x), lo = tf32(x - hi) (x - hi is
    exact in f32), lo = 0 where hi is not finite."""
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    return hi, torch.where(torch.isfinite(hi), lo, torch.zeros_like(lo))


def core_matrices_tf32(m: torch.Tensor) -> torch.Tensor:
    """[..., N, K] -> [..., N/8, K/4, 8, 4], a contiguous copy: the 8 x 4
    core matrices (128 bytes each) of wgmma's K-major, unswizzled tf32 B
    operand, k fastest within a row."""
    n, k = m.shape[-2:]
    if n % 8 or k % 4:
        raise ValueError(f"core matrices of [{n}, {k}]")
    return m.unflatten(-1, (k // 4, 4)).unflatten(-3, (n // 8, 8)).transpose(
        -3, -2).contiguous()


def pack_tf32x3(m: torch.Tensor) -> torch.Tensor:
    """f32 [..., N, K] -> [..., 2 (hi, lo), N/8, K/4, 8, 4]: a B operand of
    ``csrc/tf32x3.cuh`` split and in core matrices."""
    hi, lo = split_tf32(m)
    return torch.stack([core_matrices_tf32(hi), core_matrices_tf32(lo)],
                       dim=-5)
