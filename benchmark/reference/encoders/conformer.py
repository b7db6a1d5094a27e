"""The Conformer encoder (Gulati et al. 2020, as the port builds it):
input linear, dropout, blocks of macaron FFN halves, RoPE attention, the
convolution module (pw1, GLU, pad mask, depthwise conv, LayerNorm, swish,
pw2), pre-LN with eps 1e-6, a final LayerNorm."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import roofline
from reference import params


def param_shapes(c: dict, out: dict) -> None:
    d, e = c["dim_model"], c["ff_expansion"]
    params.linear(out, "encoder.input_linear", params.dim_input(c), d)
    for i in range(c["num_enc_layers"]):
        b = f"encoder.blocks.{i}"
        for ff in ("ff1", "ff2"):
            params.norm(out, f"{b}.{ff}.LayerNorm_0", d)
            params.linear(out, f"{b}.{ff}.Dense_0", d, e * d)
            params.linear(out, f"{b}.{ff}.Dense_1", e * d, d)
        params.norm(out, f"{b}.attn.LayerNorm_0", d)
        for n in "qkv":
            params.linear(out, f"{b}.attn.{n}", d, d)
        params.linear(out, f"{b}.attn.out", d, d)
        params.norm(out, f"{b}.conv.LayerNorm_0", d)
        params.linear(out, f"{b}.conv.pw1", d, 2 * d)
        out[f"{b}.conv.dw.weight"] = (d, 1, c["conv_kernel"])
        out[f"{b}.conv.dw.bias"] = (d,)
        params.norm(out, f"{b}.conv.norm", d)
        params.linear(out, f"{b}.conv.pw2", d, d)
    params.norm(out, "encoder.final_norm", d)


def _ffn(ref, W, name, x, gen):
    h = ref.lin(W, name + ".Dense_0",
                ref.ln(W, name + ".LayerNorm_0", x, 1e-6))
    h = ref.drop(F.silu(h), gen)
    return ref.drop(ref.lin(W, name + ".Dense_1", h), gen)


def _attn(ref, W, name, x, mask, gen):
    b, t, d = x.shape
    h = ref.c["num_heads"]
    y = ref.ln(W, name + ".LayerNorm_0", x, 1e-6)
    q, k, v = (ref.lin(W, f"{name}.{n}", y).view(b, t, h, d // h)
               for n in "qkv")
    dh = d // h
    inv = 1.0 / (10000.0 ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    ang = torch.from_numpy((np.arange(t, dtype=np.float64)[:, None]
                            * inv[None, :]).astype(np.float32)).to(x.device)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]

    def rope(z):
        z1, z2 = z[..., :dh // 2], z[..., dh // 2:]
        return torch.cat([z1 * cos - z2 * sin, z1 * sin + z2 * cos], -1)

    ctx = ref.attention(rope(q), rope(k), v, mask, gen)
    return ref.drop(ref.lin(W, name + ".out", ctx), gen)


def _conv(ref, W, name, x, npm, gen):
    h = ref.lin(W, name + ".pw1", ref.ln(W, name + ".LayerNorm_0", x, 1e-6))
    a, g = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(g)) * npm
    w = W[name + ".dw.weight"]
    h = F.conv1d(ref.q(h).transpose(1, 2), ref.q(w), W[name + ".dw.bias"],
                 padding=(w.shape[-1] - 1) // 2, groups=w.shape[0])
    h = F.silu(ref.ln(W, name + ".norm", h.transpose(1, 2), 1e-6))
    return ref.drop(ref.lin(W, name + ".pw2", h), gen)


def forward(ref, W, x, lengths, gen):
    t = x.shape[1]
    npm, pad = ref.pad_masks(lengths, t)
    mask = pad[:, None, :].expand(x.shape[0], t, t)
    h = ref.drop(ref.lin(W, "encoder.input_linear", x), gen)
    for i in range(ref.c["num_enc_layers"]):
        name = f"encoder.blocks.{i}"
        h = h + 0.5 * _ffn(ref, W, name + ".ff1", h, gen)
        h = h + _attn(ref, W, name + ".attn", h, mask, gen)
        h = h + _conv(ref, W, name + ".conv", h, npm, gen)
        h = h + 0.5 * _ffn(ref, W, name + ".ff2", h, gen)
        h = h * npm
    return ref.ln(W, "encoder.final_norm", h, 1e-6) * npm


def flops(c: dict, b: int, t: int) -> float:
    """Per block: both FFN halves, q, k, v and out, the scores and the
    context, pw1, the depthwise conv and pw2."""
    tt, d_in = roofline.vgg_out(c, t)
    d, e, lin = c["dim_model"], c["ff_expansion"], roofline.lin
    block = (2 * (lin(b * tt, d, e * d) + lin(b * tt, e * d, d))
             + 4 * lin(b * tt, d, d) + 2.0 * b * tt * tt * 2 * d
             + lin(b * tt, d, 2 * d) + 2.0 * b * tt * d * c["conv_kernel"]
             + lin(b * tt, d, d))
    return lin(b * tt, d_in, d) + c["num_enc_layers"] * block
