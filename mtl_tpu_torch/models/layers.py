"""Transformer building blocks (port of mtl_tpu/models/layers.py).

Parity targets (reference modules/common_layers.py): sinusoidal
``PositionalEncoding`` (:86-108); post-LN residual ``FeedForward``
(:110-158, optionally rank-r factorized); rank-r ``MultiHeadAttention``
(FactorizedMultiHeadAttention, :238-306) in every layer.

Numerics follow the JAX package. Parameters are float32 (flax's
``param_dtype``); every linear casts its input, weight and bias to the
model's compute dtype at the call, as flax's ``nn.Dense(dtype=...)`` does,
so training updates the f32 master weights. A serving copy may hold the
linear weights in the compute dtype already (``transformer.py:
serving_copy``): the casts are then no-ops and compute the same values.
Attention scores, softmax, LayerNorm (eps 1e-5) and the residual add run in
f32, with casts at the same points. Dropout sits where the JAX package puts
it: the FFN output (mtl_tpu/models/layers.py:115), the attention
probabilities (:179) and the attention output (:190); it draws from the
``torch.Generator`` the caller passes and is the identity without one
(deterministic). Decoding keeps an explicit KV cache, updated in place.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoid_table(max_length: int, dim_model: int) -> np.ndarray:
    """Precomputed sinusoidal positional table (1 x max_length x dim)."""
    position = np.arange(max_length, dtype=np.float32)[:, None]
    exp_term = np.exp(
        np.arange(0, dim_model, 2, dtype=np.float32)
        * -(math.log(10000.0) / dim_model)
    )
    pe = np.zeros((max_length, dim_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * exp_term)
    pe[:, 1::2] = np.cos(position * exp_term)
    return pe[None]


class PositionalEncoding(nn.Module):
    def __init__(self, dim_model: int, max_length: int = 2000):
        super().__init__()
        self.max_length = max_length
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_table(max_length, dim_model)),
            persistent=False)

    def forward(self, length: int, offset: int = 0) -> torch.Tensor:
        # lax.dynamic_slice semantics: the start is clamped into range
        start = min(max(offset, 0), self.max_length - length)
        return self.pe[:, start:start + length]


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate), in x's dtype; the identity when ``gen`` is
    None (deterministic) or the rate is 0."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)`` on f32 params: input, weight and bias in
    the compute dtype (no copies when they are in it already)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


class FactorizedDense(nn.Module):
    """Rank-r bottleneck linear: x @ W_a (no bias) @ W_b (+ bias); ``r=None``
    is a single linear (``full``). Parameters f32, computed in ``dtype``
    (mtl_tpu/models/layers.py:64-91)."""

    def __init__(self, in_features: int, features: int,
                 r: Optional[int] = None, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.r = dtype, r
        if r is not None:
            self.a = nn.Linear(in_features, r, bias=False)
            self.b = nn.Linear(r, features, bias=use_bias)
        else:
            self.full = nn.Linear(in_features, features, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.r is None:
            return linear(x, self.full, self.dtype)
        return linear(linear(x, self.a, self.dtype), self.b, self.dtype)


def _layer_norm(dim: int) -> nn.LayerNorm:
    # eps=1e-5: torch nn.LayerNorm default, as the JAX package sets it
    return nn.LayerNorm(dim, eps=1e-5, dtype=torch.float32)


class FeedForward(nn.Module):
    """Post-LN residual FFN; optionally rank-r factorized linears."""

    def __init__(self, dim_model: int, dim_ff: int, dropout: float = 0.1,
                 factorized: bool = False, r: int = 100,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        rank = r if factorized else None
        self.dtype, self.dropout = dtype, dropout
        self.linear_1 = FactorizedDense(dim_model, dim_ff, r=rank, dtype=dtype)
        self.linear_2 = FactorizedDense(dim_ff, dim_model, r=rank, dtype=dtype)
        self.layer_norm = _layer_norm(dim_model)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.linear_2(F.relu(self.linear_1(x.to(self.dtype))))
        h = dropout(h, self.dropout, gen)
        return self.layer_norm(h.float() + x.float()).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Rank-r factorized multi-head attention with post-LN residual."""

    def __init__(self, num_heads: int, dim_model: int, dim_key: int,
                 dim_value: int, dropout: float = 0.1,
                 r: Optional[int] = 100, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dim_key, self.dim_value = num_heads, dim_key, dim_value
        self.dtype, self.dropout = dtype, dropout
        h = num_heads
        self.query_linear = FactorizedDense(dim_model, h * dim_key, r, dtype=dtype)
        self.key_linear = FactorizedDense(dim_model, h * dim_key, r, dtype=dtype)
        self.value_linear = FactorizedDense(dim_model, h * dim_value, r,
                                            dtype=dtype)
        self.output_linear = FactorizedDense(h * dim_value, dim_model, r,
                                             dtype=dtype)
        self.layer_norm = _layer_norm(dim_model)

    def _q_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return self.query_linear(x).view(b, t, self.num_heads, self.dim_key)

    def project_kv(self, key: torch.Tensor, value: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project K/V heads once (e.g. the cross-attention decode cache)."""
        b, t, _ = key.shape
        k = self.key_linear(key).view(b, t, self.num_heads, self.dim_key)
        v = self.value_linear(value).view(b, t, self.num_heads,
                                          self.dim_value)
        return k, v

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor],
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """q [B,Tq,H,Dk], k [B,Tk,H,Dk], v [B,Tk,H,Dv], mask [B,Tq,Tk]
        (True = masked) -> [B, Tq, H*Dv]. Products accumulate in f32, as
        ``preferred_element_type=f32`` does in the JAX package."""
        b, t_q = q.shape[0], q.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(self.dim_key)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None], float("-inf"))
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout, gen)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn.to(self.dtype).float(),
                           v.float()).to(self.dtype)
        return ctx.reshape(b, t_q, self.num_heads * self.dim_value)

    def _finish(self, ctx: torch.Tensor, residual: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        out = dropout(self.output_linear(ctx), self.dropout, gen)
        return self.layer_norm(out.float() + residual.float()).to(
            residual.dtype)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        k, v = self.project_kv(key, value)
        ctx = self._attend(self._q_heads(query), k, v, mask, gen)
        return self._finish(ctx, query, gen)

    def decode_step(self, query_t: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, t: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One autoregressive self-attention step: writes slot ``t`` of the
        caches (in place) and attends to slots <= t. Returns (output
        B x 1 x D, cache_k, cache_v)."""
        b, t_max = cache_k.shape[0], cache_k.shape[1]
        q = self._q_heads(query_t)
        k_t, v_t = self.project_kv(query_t, query_t)
        cache_k[:, t] = k_t[:, 0]
        cache_v[:, t] = v_t[:, 0]
        pos = torch.arange(t_max, device=cache_k.device)
        mask = (pos > t)[None, None, :].expand(b, 1, t_max)
        ctx = self._attend(q, cache_k, cache_v, mask)
        return self._finish(ctx, query_t), cache_k, cache_v

    def cross_step(self, query_t: torch.Tensor, enc_k: torch.Tensor,
                   enc_v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cross-attention step against precomputed encoder K/V."""
        ctx = self._attend(self._q_heads(query_t), enc_k, enc_v, mask)
        return self._finish(ctx, query_t)
