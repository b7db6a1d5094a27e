"""Conformer encoder (port of mtl_tpu/models/conformer.py; BASELINE.json
configs[4], the 17-layer d 1024 stretch configuration).

Each block: a macaron feed-forward half (0.5 x residual), self-attention
with rotary position embeddings, a convolution module (pointwise 2d ->
GLU -> depthwise k 31 -> LayerNorm -> swish -> pointwise) and a second
feed-forward half, pre-LN throughout, then the pad mask. The encoder is a
plain input linear (even with ``is_factorized``; no positional encoding),
dropout, the blocks, a final LayerNorm, the pad mask and the cast to the
compute dtype. Same call as ``encoder.Encoder``.

Numerics follow the JAX package:

* every LayerNorm is flax's default, epsilon 1e-6 (the Transformer
  encoder's are 1e-5), f32 on an f32 input;
* linears cast input, f32 weight and bias to the compute dtype per call
  (``layers.linear``), as ``nn.Dense(dtype=...)`` does;
* RoPE multiplies the compute-dtype q and k by f32 cos / sin, which
  promotes them to f32 (conformer.py:42-46, 85-89): the scores are an f32
  product, masked with -inf and softmaxed in f32; only the context
  ``attn.astype(dtype) @ v`` takes compute-dtype operands, summed in f32
  (:94-96);
* swish is SiLU; GLU is the first half times the sigmoid of the second;
* the depthwise conv is k 31, SAME (15 each side), groups = d_model, with
  a bias; its weight is kept in torch's conv1d layout [C, 1, 31] (flax's
  kernel is [31, 1, C]; ``interop.py`` permutes it). It runs as cuDNN's
  grouped conv1d, or with ``second_order`` (the ``--second-order`` route)
  as the sum of the 31 shifted products over an ``unfold`` view: torch
  differentiates a grouped convolution twice one group at a time (d_model
  convolutions a layer), the products and sums in one pass each;
* the pad mask zeroes the GLU output before the depthwise conv (:115-116)
  and each block's output (:151).

Dropout sites, in order: the input linear (:176), the FFN's hidden and
output (:61, :64), the attention probabilities and output (:93, :99), the
conv module's output (:126); drawn from the caller's generator as
``layers.dropout``. Parameter names follow flax's (``blocks.{i}`` for
``block_{i}``), so ``interop.py`` maps them by the generic rules. With
``remat`` each block runs under ``remat.checkpoint_module``, as
``nn.remat(ConformerBlock)`` (:179-183).

Split over ``tp`` (parallel/tp.py, JAX's rules): ``q``/``k``/``v``,
``ff*/Dense_0`` and ``pw1`` are column-split, ``out``, ``ff*/Dense_1`` and
``pw2`` row-split, as ``layers.py`` does it. ``pw1`` holds this rank's
slice of the GLU's values and the matching slice of its gates, so the GLU
gives this rank's channels; they are gathered (``comm.all_gather_last``)
before the depthwise conv and its LayerNorm, which run whole and
replicated on every rank, and sliced again for ``pw2``. RoPE rotates each
head as before; a head that straddles ranks is gathered as in
``layers.py``. The FFN's hidden dropout draws the full-shape mask and
keeps this rank's slice.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import attn_pad_mask_from_lengths, non_pad_mask_from_lengths
from ..parallel import comm
from .layers import dropout, linear, tp_linear
from .remat import checkpoint_module

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _layer_norm(dim: int, eps: float = LN_EPS) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, dtype=torch.float32)


def rope_inverse_frequencies(dim: int) -> np.ndarray:
    """[dim/2] float64 theta_i = 10000^{-2i/dim}."""
    return 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def rope_angles(t: int, dim: int) -> np.ndarray:
    """[T, dim/2] rotation angles: position times theta_i in float64
    numpy, then f32 (mtl_tpu/models/conformer.py:31-35)."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    return (pos * rope_inverse_frequencies(dim)[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_rope_inverse(dim: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_inverse_frequencies(dim)).to(device)


def device_rope_angles(t: int, dim: int, device: torch.device
                       ) -> torch.Tensor:
    """``rope_angles`` computed on ``device`` with the same float64
    products, so the bits match. Only the [dim/2] frequencies are copied
    from the host, once per dim: a forward copies nothing and keeps
    nothing per length, which a CUDA graph's capture and the eager steps
    that share its memory pool (``train/graphs.py``) need."""
    pos = torch.arange(t, dtype=torch.float64, device=device)[:, None]
    return (pos * _device_rope_inverse(dim, device)[None, :]).float()


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; rotates the feature pairs (i, i + D/2) by the
    position's angles (f32 [T, D/2]). A bf16 x comes out f32, as in JAX."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class ConformerFFN(nn.Module):
    tp = None

    def __init__(self, dim_model: int, expansion: int = 4,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 eps: float = LN_EPS):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.LayerNorm_0 = _layer_norm(dim_model, eps)
        self.Dense_0 = nn.Linear(dim_model, dim_model * expansion)
        self.Dense_1 = nn.Linear(dim_model * expansion, dim_model)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = comm.copy_to_model(self.LayerNorm_0(x.float()), self.tp)
        h = linear(h, self.Dense_0, self.dtype)
        h = dropout(F.silu(h), self.dropout, gen, -1, self.tp)
        return dropout(tp_linear(h, self.Dense_1, self.dtype, self.tp),
                       self.dropout, gen)


class ConformerAttention(nn.Module):
    tp = None

    def __init__(self, num_heads: int, dim_model: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dim_model = num_heads, dim_model
        self.dtype, self.dropout = dtype, dropout
        self.LayerNorm_0 = _layer_norm(dim_model)
        self.q = nn.Linear(dim_model, dim_model)
        self.k = nn.Linear(dim_model, dim_model)
        self.v = nn.Linear(dim_model, dim_model)
        self.out = nn.Linear(dim_model, dim_model)

    def project(self, x: torch.Tensor):
        """(q, k, v) heads [B, T, H, D] in the compute dtype, before RoPE."""
        b, t, _ = x.shape
        dh = self.dim_model // self.num_heads
        y = self.LayerNorm_0(x.float()).to(self.dtype)
        y = comm.copy_to_model(y, self.tp)
        straddles = self.tp is not None and self.num_heads % self.tp.size
        out = []
        for lin in (self.q, self.k, self.v):
            h = linear(y, lin, self.dtype)
            if straddles:
                h = comm.all_gather_last(h, self.tp)
            out.append(h.view(b, t, -1, dh))
        return tuple(out)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_angles: torch.Tensor, k_angles: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The attention of ``project``'s heads, the queries' and keys'
        positions given by their RoPE angles (the sequence-parallel encode
        passes a time slice's queries against every key,
        parallel/sp.py)."""
        b, t = q.shape[:2]
        q, k = apply_rope(q, q_angles), apply_rope(k, k_angles)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(q.shape[-1])
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None], float("-inf"))
        local = q.shape[2] < self.num_heads  # this rank's heads
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout, gen, 1,
                       self.tp if local else None)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn.to(self.dtype).float(),
                           v.float())
        ctx = ctx.to(self.dtype).reshape(b, t, -1)
        if self.tp is not None and not local:
            ctx = comm.scatter_to_model(ctx, self.tp)
        return dropout(tp_linear(ctx, self.out, self.dtype, self.tp),
                       self.dropout, gen)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.project(x)
        angles = device_rope_angles(x.shape[1], q.shape[-1], x.device)
        return self.attend(q, k, v, angles, angles, attn_mask, gen)


class DepthwiseConv(nn.Module):
    """flax ``nn.Conv(C, (k,), padding="SAME", feature_group_count=C)``:
    ``weight`` [C, 1, k] (torch's conv1d layout) and ``bias`` [C], f32,
    computed in the compute dtype over [B, T, C]. ``unfolded`` takes the
    route that autograd differentiates twice at the cost of once (the
    module docstring); it sums the products in f32, rounds to the compute
    dtype and adds the bias there, as flax does."""

    def __init__(self, channels: int, kernel_size: int = 31,
                 unfolded: bool = False):
        super().__init__()
        self.unfolded = unfolded
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    @property
    def pad(self) -> int:
        return (self.weight.shape[-1] - 1) // 2  # k odd: SAME, each side

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                padded: bool = False) -> torch.Tensor:
        """``padded``: ``x`` holds ``pad`` frames of context on each side
        already (a time slice with its neighbours' frames, parallel/sp.py),
        and the conv runs VALID over it."""
        k = self.weight.shape[-1]
        pad = 0 if padded else self.pad
        if self.unfolded:
            xp = F.pad(x.to(dtype).float(), (0, 0, pad, pad))
            windows = xp.unfold(1, k, 1)  # [B, T, C, k], a view
            y = (windows * self.weight.to(dtype).float()[:, 0]).sum(-1)
            return y.to(dtype) + self.bias.to(dtype)
        y = F.conv1d(x.to(dtype).transpose(1, 2), self.weight.to(dtype),
                     self.bias.to(dtype), padding=pad,
                     groups=self.weight.shape[0])
        return y.transpose(1, 2)


class ConformerConvModule(nn.Module):
    tp = None
    # pw1 is split as two blocks: the GLU's values and its gates
    TP_GROUPS = {"pw1": 2}

    def __init__(self, dim_model: int, kernel_size: int = 31,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 second_order: bool = False):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.LayerNorm_0 = _layer_norm(dim_model)
        self.pw1 = nn.Linear(dim_model, 2 * dim_model)
        self.dw = DepthwiseConv(dim_model, kernel_size, unfolded=second_order)
        self.norm = _layer_norm(dim_model)
        self.pw2 = nn.Linear(dim_model, dim_model)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None,
                context=None) -> torch.Tensor:
        """``context`` (the sequence-parallel encode's) maps the depthwise
        conv's input [B, T, C] to the same with ``dw.pad`` frames of the
        neighbouring time slices on each side."""
        h = self.LayerNorm_0(x.float()).to(self.dtype)
        h = comm.copy_to_model(h, self.tp)
        h = F.glu(linear(h, self.pw1, self.dtype), dim=-1)
        h = comm.all_gather_last(h, self.tp)  # every channel, on every rank
        if pad_mask is not None:  # padding stays zero into the conv
            h = h * pad_mask.to(h.dtype)
        if context is not None:
            h = self.dw(context(h), self.dtype, padded=True)
        else:
            h = self.dw(h, self.dtype)
        h = F.silu(self.norm(h.float()).to(self.dtype))
        h = comm.scatter_to_model(h, self.tp)
        return dropout(tp_linear(h, self.pw2, self.dtype, self.tp),
                       self.dropout, gen)


class ConformerBlock(nn.Module):
    def __init__(self, num_heads: int, dim_model: int, ff_expansion: int = 4,
                 conv_kernel: int = 31, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 second_order: bool = False):
        super().__init__()
        self.ff1 = ConformerFFN(dim_model, ff_expansion, dropout, dtype)
        self.attn = ConformerAttention(num_heads, dim_model, dropout, dtype)
        self.conv = ConformerConvModule(dim_model, conv_kernel, dropout, dtype,
                                        second_order)
        self.ff2 = ConformerFFN(dim_model, ff_expansion, dropout, dtype)

    def forward(self, x: torch.Tensor, non_pad_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor],
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + 0.5 * self.ff1(x, gen)
        x = x + self.attn(x, attn_mask, gen)
        x = x + self.conv(x, non_pad_mask, gen)
        x = x + 0.5 * self.ff2(x, gen)
        return x * non_pad_mask.to(x.dtype)


class ConformerEncoder(nn.Module):
    """Drop-in alternative to ``encoder.Encoder`` (same call)."""

    encoder_type = "conformer"

    def __init__(self, num_layers: int, num_heads: int, dim_model: int,
                 dim_input: int, ff_expansion: int = 4, conv_kernel: int = 31,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, second_order: bool = False):
        super().__init__()
        self.dtype, self.dropout, self.remat = dtype, dropout, remat
        self.input_linear = nn.Linear(dim_input, dim_model)
        self.blocks = nn.ModuleList(
            ConformerBlock(num_heads, dim_model, ff_expansion, conv_kernel,
                           dropout, dtype, second_order)
            for _ in range(num_layers))
        self.final_norm = _layer_norm(dim_model)

    def forward(self, padded_input: torch.Tensor, input_lengths: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """padded_input [B, T, D_input]; input_lengths [B] (raw lengths)."""
        t = padded_input.shape[1]
        non_pad_mask = non_pad_mask_from_lengths(input_lengths, t)
        attn_mask = attn_pad_mask_from_lengths(input_lengths, t, t)
        h = linear(padded_input, self.input_linear, self.dtype)
        h = dropout(h, self.dropout, gen)
        for block in self.blocks:
            if self.remat:
                h = checkpoint_module(block, h, non_pad_mask, attn_mask,
                                      gen=gen)
            else:
                h = block(h, non_pad_mask, attn_mask, gen)
        h = self.final_norm(h.float())
        return (h * non_pad_mask).to(self.dtype)
