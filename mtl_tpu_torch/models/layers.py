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

Tensor parallel (``parallel/tp.py``): ``shard_module`` sets ``tp`` (the
``model`` axis) on the layers and ``tp_kind`` ("col" / "row") on the split
``nn.Linear``s, whose weights then hold this rank's slice. A column
linear's input is replicated and enters through ``comm.copy_to_model``
(once per distinct input tensor); its output is this rank's slice of the
features. A row linear takes that slice and all-reduces its partial
product before the bias (``row_linear``). A factorized column linear
gathers its rank-r bottleneck over the axis between its two kernels; a
factorized row linear reduce-scatters it (each rank then holds a slice of
the reduced bottleneck, the input of its slice of ``b``). Attention runs
over this rank's heads when the axis size divides the head count; else a
head straddles ranks, and q, k and v are gathered whole (every rank
attends over every head) and the context is sliced again for the output
linear. A dropout on a split activation draws the full-shape mask and
keeps this rank's part, so every rank draws the masks of the unsplit
layer. With ``tp`` None (the default) nothing of this runs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm


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
            gen: Optional[torch.Generator], split_dim: Optional[int] = None,
            axis=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate), in x's dtype; the identity when ``gen`` is
    None (deterministic) or the rate is 0. With ``axis``, ``x`` is this
    rank's part of a tensor split along ``split_dim`` over it: the mask is
    drawn at the full shape and this rank's part kept."""
    if gen is None or rate == 0.0:
        return x
    split = axis is not None and axis.size > 1
    shape = list(x.shape)
    if split:
        shape[split_dim] *= axis.size
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - rate
    if split:
        n = x.shape[split_dim]
        keep = keep.narrow(split_dim, axis.index * n, n)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)`` on f32 params: input, weight and bias in
    the compute dtype (no copies when they are in it already)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def row_linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
               axis) -> torch.Tensor:
    """A row-split linear: this rank's slice of the input features times
    its rows of the weight, all-reduced over ``axis``, then the
    (replicated) bias."""
    y = comm.reduce_from_model(F.linear(x.to(dtype), lin.weight.to(dtype)),
                               axis)
    return y if lin.bias is None else y + lin.bias.to(dtype)


def tp_linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
              axis) -> torch.Tensor:
    """``linear``, or ``row_linear`` for a row-split ``lin`` (a column-split
    one is ``linear`` on its slice; its input is copied to the axis by the
    caller)."""
    if axis is not None and getattr(lin, "tp_kind", None) == "row":
        return row_linear(x, lin, dtype, axis)
    return linear(x, lin, dtype)


class FactorizedDense(nn.Module):
    """Rank-r bottleneck linear: x @ W_a (no bias) @ W_b (+ bias); ``r=None``
    is a single linear (``full``). Parameters f32, computed in ``dtype``
    (mtl_tpu/models/layers.py:64-91). Split over ``tp`` as the module
    docstring says; a column-split one takes its input copied to the axis
    already."""

    tp = None

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
            return tp_linear(x, self.full, self.dtype, self.tp)
        kind = getattr(self.a, "tp_kind", None) if self.tp else None
        if kind == "col":
            h = comm.gather_from_model(linear(x, self.a, self.dtype), self.tp)
            return linear(h, self.b, self.dtype)
        if kind == "row":
            h = F.linear(x.to(self.dtype), self.a.weight.to(self.dtype))
            h = comm.reduce_scatter_to_model(h, self.tp)
            return row_linear(h, self.b, self.dtype, self.tp)
        return linear(linear(x, self.a, self.dtype), self.b, self.dtype)


def _layer_norm(dim: int) -> nn.LayerNorm:
    # eps=1e-5: torch nn.LayerNorm default, as the JAX package sets it
    return nn.LayerNorm(dim, eps=1e-5, dtype=torch.float32)


class FeedForward(nn.Module):
    """Post-LN residual FFN; optionally rank-r factorized linears
    (``linear_1`` column-, ``linear_2`` row-split over ``tp``)."""

    tp = None

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
        x_in = comm.copy_to_model(x.to(self.dtype), self.tp)
        h = self.linear_2(F.relu(self.linear_1(x_in)))
        h = dropout(h, self.dropout, gen)
        return self.layer_norm(h.float() + x.float()).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Rank-r factorized multi-head attention with post-LN residual (q, k,
    v column-, the output row-split over ``tp``)."""

    tp = None

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

    @property
    def _straddles(self) -> bool:
        """A head's columns span ranks of ``tp``."""
        return self.tp is not None and self.num_heads % self.tp.size != 0

    def _heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """[B, T, H_local * dim] -> [B, T, H_local, dim]: this rank's heads,
        or under a straddling split every head (gathered)."""
        if self._straddles:
            x = comm.all_gather_last(x, self.tp)
        return x.view(x.shape[0], x.shape[1], -1, dim)

    def _q_heads(self, x: torch.Tensor) -> torch.Tensor:
        return self._heads(self.query_linear(x), self.dim_key)

    def project_kv(self, key: torch.Tensor, value: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project K/V heads once (e.g. the cross-attention decode cache)."""
        return (self._heads(self.key_linear(key), self.dim_key),
                self._heads(self.value_linear(value), self.dim_value))

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
        local = q.shape[2] < self.num_heads  # this rank's heads
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout, gen,
                       1, self.tp if local else None)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn.to(self.dtype).float(),
                           v.float()).to(self.dtype)
        return ctx.reshape(b, t_q, q.shape[2] * self.dim_value)

    def _finish(self, ctx: torch.Tensor, residual: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self._straddles:
            ctx = comm.scatter_to_model(ctx, self.tp)
        out = dropout(self.output_linear(ctx), self.dropout, gen)
        return self.layer_norm(out.float() + residual.float()).to(
            residual.dtype)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        # one copy per distinct input: one all-reduce of its gradient
        q_in = comm.copy_to_model(query, self.tp)
        k_in = q_in if key is query else comm.copy_to_model(key, self.tp)
        v_in = k_in if value is key else comm.copy_to_model(value, self.tp)
        k, v = self.project_kv(k_in, v_in)
        ctx = self._attend(self._q_heads(q_in), k, v, mask, gen)
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
