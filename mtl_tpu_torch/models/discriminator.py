"""Accent/language discriminator of the adversarial and multitask heads
(port of mtl_tpu/models/discriminator.py; reference
modules/discriminator.py:5-24): one f32 linear layer over the encoder
output summed over time, every frame counted, padded ones included, as in
the JAX package."""

from __future__ import annotations

import math

import torch
from torch import nn


class Discriminator(nn.Module):
    def __init__(self, dim_model: int, num_class: int):
        super().__init__()
        self.linear = nn.Linear(dim_model, num_class)

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        """enc [B, T, d_model] (any dtype) -> logits [B, num_class], f32."""
        return self.linear(enc.float().sum(dim=1))


@torch.no_grad()
def init_discriminator(disc: Discriminator,
                       generator: torch.Generator) -> None:
    """xavier-uniform weight, zero bias, as the JAX package's ``Dense``
    (``KERNEL_INIT``); drawn on the CPU from ``generator``."""
    w = disc.linear.weight
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                          generator=generator))
    disc.linear.bias.zero_()
