"""Transformer encoder (port of mtl_tpu/models/encoder.py; reference
modules/encoder.py:15-106).

Input projection (rank-r factorized only with ``is_factorized``) +
LayerNorm + sinusoidal PE (no input dropout: the reference never applies
it, mtl_tpu/models/encoder.py:4-5), then ``num_layers`` x [self-attention
-> *non_pad_mask -> post-LN FFN -> *non_pad_mask]. The masks come from the
lengths the caller passes: the raw, un-downsampled frame counts against
the downsampled time axis, as the reference does. ``gen`` is the dropout
generator (None: deterministic). With ``remat`` each layer runs under
``remat.checkpoint_module`` (mtl_tpu/models/encoder.py:89-90).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masks import attn_pad_mask_from_lengths, non_pad_mask_from_lengths
from .layers import (FactorizedDense, FeedForward, MultiHeadAttention,
                     PositionalEncoding, _layer_norm)
from .remat import checkpoint_module


class EncoderLayer(nn.Module):
    def __init__(self, num_heads: int, dim_model: int, dim_inner: int,
                 dim_key: int, dim_value: int, dropout: float = 0.1,
                 is_factorized: bool = False, r: int = 100,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.self_attn = MultiHeadAttention(num_heads, dim_model, dim_key,
                                            dim_value, dropout=dropout, r=r,
                                            dtype=dtype)
        self.pos_ffn = FeedForward(dim_model, dim_inner, dropout=dropout,
                                   factorized=is_factorized, r=r, dtype=dtype)

    def forward(self, x, non_pad_mask, self_attn_mask,
                gen: Optional[torch.Generator] = None):
        out = self.self_attn(x, x, x, mask=self_attn_mask, gen=gen)
        out = out * non_pad_mask.to(out.dtype)
        out = self.pos_ffn(out, gen)
        return out * non_pad_mask.to(out.dtype)


class Encoder(nn.Module):
    encoder_type = "transformer"

    def __init__(self, num_layers: int, num_heads: int, dim_model: int,
                 dim_key: int, dim_value: int, dim_input: int, dim_inner: int,
                 dropout: float = 0.1, src_max_length: int = 2500,
                 is_factorized: bool = False,
                 r: int = 100, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.input_linear = FactorizedDense(
            dim_input, dim_model, r=r if is_factorized else None, dtype=dtype)
        self.layer_norm_input = _layer_norm(dim_model)
        self.positional_encoding = PositionalEncoding(dim_model,
                                                      src_max_length)
        self.layers = nn.ModuleList(
            EncoderLayer(num_heads, dim_model, dim_inner, dim_key, dim_value,
                         dropout=dropout, is_factorized=is_factorized, r=r,
                         dtype=dtype)
            for _ in range(num_layers))

    def forward(self, padded_input: torch.Tensor,
                input_lengths: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """padded_input [B, T, D_input]; input_lengths [B] (raw lengths)."""
        t = padded_input.shape[1]
        non_pad_mask = non_pad_mask_from_lengths(input_lengths, t)
        self_attn_mask = attn_pad_mask_from_lengths(input_lengths, t, t)
        h = self.layer_norm_input(self.input_linear(padded_input).float())
        h = (h + self.positional_encoding(t)).to(self.dtype)
        for layer in self.layers:
            if self.remat:
                h = checkpoint_module(layer, h, non_pad_mask, self_attn_mask,
                                      gen=gen)
            else:
                h = layer(h, non_pad_mask, self_attn_mask, gen)
        return h
