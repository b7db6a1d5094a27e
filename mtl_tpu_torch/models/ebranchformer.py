"""E-Branchformer encoder (Kim et al., "E-Branchformer: Branchformer with
Enhanced merging for speech recognition", SLT 2022, arXiv:2210.00077; the
block of ESPnet's ``espnet2/asr/encoder/e_branchformer_encoder.py`` with
``espnet2/asr/layers/cgmlp.py`` and the "latest" relative-position
attention and encoding of ``espnet/nets/pytorch_backend/transformer``).

The encoder: the input linear (on the VGG output), times sqrt(d), dropout;
the blocks; a final LayerNorm and the pad mask; the cast to the compute
dtype. Same call as ``encoder.Encoder``. Each block:

    x = x + 0.5 * FFN(x)                        (macaron half, swish)
    x1 = drop(RelAttn(LN(x), p))                attention branch
    x2 = drop(cgMLP(LN(x)))                     convolutional gating branch
    c = [x1, x2]
    x = x + drop(W_merge (c + DWConv(c)))       the merge
    x = x + 0.5 * FFN(x)
    x = LN(x) * non_pad_mask

* relative-position attention: with ``PE(r)`` the interleaved sin and cos
  of ``r * w_i``, ``w_i = 10000^(-2i/d)``, for ``r = T-1 ... -(T-1)``, and
  ``p_r = W_pos PE(r)`` (no bias), ``score_ij = ((q_i + u) . k_j + (q_i +
  v) . p_{i-j}) / sqrt(d_k)``, ``u`` and ``v`` learned [H, d_k]. The table
  is computed on the device from the [d/2] frequencies, which are copied
  from the host once per width (``conformer.py``'s cache); ``rel_shift``
  (ESPnet's pad, view and slice) moves the [T, 2T-1] position scores to
  [T, T], all views and one pad, so the backward is a copy;
* cgMLP: ``W_1`` (d -> cgmlp_linear_units), exact GELU, split into the
  value half and the gate half; the gate through LayerNorm and a depthwise
  conv (``cgmlp_conv_kernel``, with bias, no activation after it); the
  product, dropout, ``W_2`` back to d;
* the merge: the two branches concatenated (2d), plus their depthwise conv
  (``merge_conv_kernel``, with bias), projected to d.

Numerics: the residual stream is f32; every linear casts input, f32 weight
and bias to the compute dtype (``layers.linear``); every LayerNorm is f32
with ESPnet's epsilon, 1e-12; the attention scores are f32 products of the
compute-dtype q, k and p (``u`` and ``v`` added in f32), masked with -inf
and softmaxed in f32, and the context takes compute-dtype operands summed
in f32, as the Conformer's. The depthwise convs are ``conformer.
DepthwiseConv`` (cuDNN's grouped conv1d, or the unfolded route under
``--second-order``). The pad mask zeroes the gate before its conv, the
concatenation before the merge's conv, and each block's output.

Dropout sites, in order, each drawn from the caller's generator as
``layers.dropout``: the scaled input, then the relative table ``PE``
([1, 2T-1, d], once for all blocks); per block the first FFN's hidden and
output, the attention probabilities and the attention branch's output, the
gated product and the cgMLP branch's output, the merge's output, the
second FFN's hidden and output.

Spans (``utils/trace.py``): ``model.ebranch.attn``, ``.cgmlp`` and
``.merge``, one each per block. With ``remat`` each block runs under
``remat.checkpoint_module``. Neither the sequence-parallel encode nor
tensor parallel runs this encoder (``parallel/sp.py``, ``parallel/tp.py``
refuse it by name).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import attn_pad_mask_from_lengths, non_pad_mask_from_lengths
from ..utils.trace import span
from .conformer import (ConformerFFN, DepthwiseConv, _device_rope_inverse,
                        _layer_norm)
from .layers import dropout, linear
from .remat import checkpoint_module

LN_EPS = 1e-12  # ESPnet's LayerNorm


def device_rel_positions(t: int, dim: int, device: torch.device
                         ) -> torch.Tensor:
    """[2T-1, dim] f32: row j is ``PE(T-1-j)``, sin and cos of the
    position times ``w_i`` interleaved, computed in float64 on ``device``
    from the cached frequencies (nothing copied from the host per
    length)."""
    r = torch.arange(t - 1, -t, -1, dtype=torch.float64, device=device)
    ang = r[:, None] * _device_rope_inverse(dim, device)[None, :]
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(2 * t - 1, dim).float()


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T-1] scores against ``PE(T-1) ... PE(-(T-1))`` -> [..., T,
    T] with entry (i, j) the score against ``PE(i - j)`` (ESPnet's
    ``rel_shift``)."""
    *lead, t, n = x.shape
    padded = F.pad(x, (1, 0)).view(*lead, n + 1, t)
    return padded[..., 1:, :].view(*lead, t, n)[..., :t]


class RelPositionAttention(nn.Module):
    """ESPnet's ``RelPositionMultiHeadedAttention`` ("latest"), on the
    block's normalized input."""

    def __init__(self, num_heads: int, dim_model: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dtype, self.dropout = num_heads, dtype, dropout
        dk = dim_model // num_heads
        self.linear_q = nn.Linear(dim_model, dim_model)
        self.linear_k = nn.Linear(dim_model, dim_model)
        self.linear_v = nn.Linear(dim_model, dim_model)
        self.linear_out = nn.Linear(dim_model, dim_model)
        self.linear_pos = nn.Linear(dim_model, dim_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dk))

    def forward(self, y: torch.Tensor, pos: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """y [B, T, d] (compute dtype); pos [1, 2T-1, d], the relative
        table."""
        b, t, _ = y.shape
        h = self.num_heads
        q, k, v = (linear(y, lin, self.dtype).view(b, t, h, -1)
                   for lin in (self.linear_q, self.linear_k, self.linear_v))
        p = linear(pos, self.linear_pos, self.dtype).view(2 * t - 1, h, -1)
        q = q.float()
        ac = torch.einsum("bqhd,bkhd->bhqk", q + self.pos_bias_u, k.float())
        bd = torch.einsum("bqhd,phd->bhqp", q + self.pos_bias_v, p.float())
        scores = (ac + rel_shift(bd)) / math.sqrt(q.shape[-1])
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None], float("-inf"))
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout, gen)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn.to(self.dtype).float(),
                           v.float())
        return linear(ctx.to(self.dtype).reshape(b, t, -1), self.linear_out,
                      self.dtype)


class ConvolutionalGatingMLP(nn.Module):
    """ESPnet's cgMLP with an identity gate activation and no linear after
    the conv; ``norm`` and ``conv`` are its spatial gating unit's."""

    def __init__(self, dim_model: int, linear_units: int, kernel_size: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 second_order: bool = False):
        super().__init__()
        if linear_units % 2:
            raise ValueError(f"cgmlp_linear_units {linear_units} is odd: "
                             f"it splits into value and gate halves")
        self.dtype, self.dropout = dtype, dropout
        self.channel_proj1 = nn.Linear(dim_model, linear_units)
        self.norm = _layer_norm(linear_units // 2, LN_EPS)  # the gate's
        self.conv = DepthwiseConv(linear_units // 2, kernel_size,
                                  unfolded=second_order)
        self.channel_proj2 = nn.Linear(linear_units // 2, dim_model)

    def forward(self, y: torch.Tensor, pad_mask: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(linear(y, self.channel_proj1, self.dtype))
        value, gate = h.chunk(2, dim=-1)
        gate = self.conv(self.norm(gate.float()) * pad_mask, self.dtype)
        h = dropout(value * gate, self.dropout, gen)
        return linear(h, self.channel_proj2, self.dtype)


class EBranchformerBlock(nn.Module):
    def __init__(self, num_heads: int, dim_model: int, linear_units: int,
                 cgmlp_linear_units: int, cgmlp_conv_kernel: int,
                 merge_conv_kernel: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 second_order: bool = False):
        super().__init__()
        if linear_units % dim_model:
            raise ValueError(f"linear_units {linear_units} is not a multiple "
                             f"of dim_model {dim_model}")
        self.dtype, self.dropout = dtype, dropout
        ffn = (dim_model, linear_units // dim_model, dropout, dtype, LN_EPS)
        self.ff1 = ConformerFFN(*ffn)
        self.norm_mha = _layer_norm(dim_model, LN_EPS)
        self.attn = RelPositionAttention(num_heads, dim_model, dropout, dtype)
        self.norm_mlp = _layer_norm(dim_model, LN_EPS)
        self.cgmlp = ConvolutionalGatingMLP(
            dim_model, cgmlp_linear_units, cgmlp_conv_kernel, dropout, dtype,
            second_order)
        self.depthwise_conv_fusion = DepthwiseConv(
            2 * dim_model, merge_conv_kernel, unfolded=second_order)
        self.merge_proj = nn.Linear(2 * dim_model, dim_model)
        self.ff2 = ConformerFFN(*ffn)
        self.norm_final = _layer_norm(dim_model, LN_EPS)

    def forward(self, x: torch.Tensor, non_pad_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor], pos: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + 0.5 * self.ff1(x, gen)
        with span("model.ebranch.attn"):
            y = self.norm_mha(x).to(self.dtype)
            x1 = dropout(self.attn(y, pos, attn_mask, gen), self.dropout, gen)
        with span("model.ebranch.cgmlp"):
            y = self.norm_mlp(x).to(self.dtype)
            x2 = dropout(self.cgmlp(y, non_pad_mask, gen), self.dropout, gen)
        with span("model.ebranch.merge"):
            c = torch.cat([x1, x2], dim=-1) * non_pad_mask.to(x1.dtype)
            c = c + self.depthwise_conv_fusion(c, self.dtype)
            x = x + dropout(linear(c, self.merge_proj, self.dtype),
                            self.dropout, gen)
        x = x + 0.5 * self.ff2(x, gen)
        return self.norm_final(x) * non_pad_mask


class EBranchformerEncoder(nn.Module):
    """Drop-in alternative to ``encoder.Encoder`` (same call)."""

    encoder_type = "e_branchformer"

    def __init__(self, num_layers: int, num_heads: int, dim_model: int,
                 dim_input: int, linear_units: int = 2048,
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 merge_conv_kernel: int = 3, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                 second_order: bool = False):
        super().__init__()
        self.dtype, self.dropout, self.remat = dtype, dropout, remat
        self.input_linear = nn.Linear(dim_input, dim_model)
        self.blocks = nn.ModuleList(
            EBranchformerBlock(num_heads, dim_model, linear_units,
                               cgmlp_linear_units, cgmlp_conv_kernel,
                               merge_conv_kernel, dropout, dtype,
                               second_order)
            for _ in range(num_layers))
        self.after_norm = _layer_norm(dim_model, LN_EPS)

    def forward(self, padded_input: torch.Tensor, input_lengths: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """padded_input [B, T, D_input]; input_lengths [B] (raw lengths)."""
        t = padded_input.shape[1]
        d = self.input_linear.out_features
        non_pad_mask = non_pad_mask_from_lengths(input_lengths, t)
        attn_mask = attn_pad_mask_from_lengths(input_lengths, t, t)
        h = linear(padded_input, self.input_linear, self.dtype)
        h = dropout(h.float() * math.sqrt(d), self.dropout, gen)
        pos = device_rel_positions(t, d, h.device)[None]
        pos = dropout(pos, self.dropout, gen)
        for block in self.blocks:
            if self.remat:
                h = checkpoint_module(block, h, non_pad_mask, attn_mask, pos,
                                      gen=gen)
            else:
                h = block(h, non_pad_mask, attn_mask, pos, gen)
        return (self.after_norm(h) * non_pad_mask).to(self.dtype)
