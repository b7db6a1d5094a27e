"""Weights made from a seed on the device, in one large draw: every
matrix, embedding and convolution kernel xavier-uniform (the JAX package's
fans: HWIO kernels by their taps and channels, [C, 1, k] depthwise kernels
by k and channels), LayerNorm scales 1 and biases 0, every other bias
uniform in [-0.02, 0.02]. The leaves are laid out in the order of their
sorted names, so both sides get the same tensors by name."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BIAS_BOUND = 0.02


def _bound(name: str, shape: Tuple[int, ...]) -> float:
    if len(shape) == 4:  # HWIO
        rf = shape[0] * shape[1]
        fan_in, fan_out = rf * shape[2], rf * shape[3]
    elif len(shape) == 3:  # [C_out, C_in / groups, k]
        fan_in, fan_out = shape[2] * shape[1], shape[2] * shape[0]
    elif len(shape) == 2:  # [out, in]; an embedding [vocab, dim]
        fan_out, fan_in = shape
    else:
        return BIAS_BOUND
    return math.sqrt(6.0 / (fan_in + fan_out))


def is_norm(name: str) -> bool:
    return "norm" in name.lower()


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``}, views of one buffer."""
    names = sorted(n for n in shapes if not is_norm(n))
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for n in names:
        k = math.prod(shapes[n])
        out[n] = flat[off:off + k].view(shapes[n]).mul_(_bound(n, shapes[n]))
        off += k
    for n in shapes:
        if is_norm(n):
            fill = 1.0 if n.endswith(".weight") else 0.0
            out[n] = torch.full(shapes[n], fill, device=device)
    return out
