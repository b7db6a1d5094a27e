"""The E-Branchformer encoder (Kim et al. 2022, arXiv:2210.00077; ESPnet's
``e_branchformer_encoder.py``, as the port builds it): the input linear
times sqrt(d), dropout on it and on the relative table; blocks of a
macaron FFN half, relative-position attention beside the cgMLP (LayerNorm
-> W_1 -> GELU -> value x depthwise conv of the normalized, masked gate ->
W_2), the merge (the concatenation plus its depthwise conv -> W_merge), a
second FFN half and a LayerNorm; a final LayerNorm. Every LayerNorm's
epsilon is ESPnet's, 1e-12. The pad mask zeroes the gate and the
concatenation before their convs and each block's output."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import roofline
from reference import params

EPS = 1e-12


def param_shapes(c: dict, out: dict) -> None:
    d, h = c["dim_model"], c["num_heads"]
    lu, cu = c["linear_units"], c["cgmlp_linear_units"]
    params.linear(out, "encoder.input_linear", params.dim_input(c), d)
    for i in range(c["num_enc_layers"]):
        b = f"encoder.blocks.{i}"
        for ff in ("ff1", "ff2"):
            params.norm(out, f"{b}.{ff}.LayerNorm_0", d)
            params.linear(out, f"{b}.{ff}.Dense_0", d, lu)
            params.linear(out, f"{b}.{ff}.Dense_1", lu, d)
        params.norm(out, f"{b}.norm_mha", d)
        for n in ("q", "k", "v", "out"):
            params.linear(out, f"{b}.attn.linear_{n}", d, d)
        params.linear(out, f"{b}.attn.linear_pos", d, d, bias=False)
        out[f"{b}.attn.pos_bias_u"] = (h, d // h)
        out[f"{b}.attn.pos_bias_v"] = (h, d // h)
        params.norm(out, f"{b}.norm_mlp", d)
        params.linear(out, f"{b}.cgmlp.channel_proj1", d, cu)
        params.norm(out, f"{b}.cgmlp.norm", cu // 2)
        out[f"{b}.cgmlp.conv.weight"] = (cu // 2, 1, c["cgmlp_conv_kernel"])
        out[f"{b}.cgmlp.conv.bias"] = (cu // 2,)
        params.linear(out, f"{b}.cgmlp.channel_proj2", cu // 2, d)
        out[f"{b}.depthwise_conv_fusion.weight"] = (2 * d, 1,
                                                   c["merge_conv_kernel"])
        out[f"{b}.depthwise_conv_fusion.bias"] = (2 * d,)
        params.linear(out, f"{b}.merge_proj", 2 * d, d)
        params.norm(out, f"{b}.norm_final", d)
    params.norm(out, "encoder.after_norm", d)


def _table(t, d, device):
    """[1, 2T-1, d]: the sin and cos of r * 10000^(-2i/d) interleaved, for
    r = T-1 down to -(T-1), in float64, then f32."""
    r = torch.arange(t - 1, -t, -1, dtype=torch.float64, device=device)
    w = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=device) / d)
    ang = r[:, None] * w[None, :]
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(1, 2 * t - 1, d).float()


def _dwconv(ref, W, name, x):
    w = W[name + ".weight"]
    y = F.conv1d(ref.q(x).transpose(1, 2), ref.q(w), W[name + ".bias"],
                 padding=(w.shape[-1] - 1) // 2, groups=w.shape[0])
    return y.transpose(1, 2)


def _ffn(ref, W, name, x, gen):
    h = ref.lin(W, name + ".Dense_0", ref.ln(W, name + ".LayerNorm_0", x, EPS))
    h = ref.drop(F.silu(h), gen)
    return ref.drop(ref.lin(W, name + ".Dense_1", h), gen)


def _attn(ref, W, name, y, pe, mask, gen):
    """Scores (q_i + u) . k_j + (q_i + v) . p_{i-j} over sqrt(d_k); the
    position term is computed against all 2T-1 rows of the table, then
    each row i moved so that column j holds r = i - j (a zero column
    prepended, the [T, 2T] block read as [2T, T], its first row dropped)."""
    b, t, d = y.shape
    h = ref.c["num_heads"]
    q, k, v = (ref.lin(W, f"{name}.linear_{n}", y).view(b, t, h, d // h)
               for n in "qkv")
    p = ref.lin(W, name + ".linear_pos", pe, bias=False)[0].view(-1, h, d // h)
    ac = torch.einsum("bqhd,bkhd->bhqk", ref.q(q + W[name + ".pos_bias_u"]),
                      ref.q(k))
    bd = torch.einsum("bqhd,phd->bhqp", ref.q(q + W[name + ".pos_bias_v"]),
                      ref.q(p))
    n = 2 * t - 1
    bd = torch.cat([bd.new_zeros(b, h, t, 1), bd], dim=-1)
    bd = bd.view(b, h, n + 1, t)[:, :, 1:].reshape(b, h, t, n)[..., :t]
    scores = (ac + bd) / math.sqrt(d // h)
    scores = scores.masked_fill(mask[:, None], float("-inf"))
    attn = ref.drop(torch.softmax(scores, dim=-1), gen)
    ctx = torch.einsum("bhqk,bkhd->bqhd", ref.q(attn), ref.q(v))
    return ref.lin(W, name + ".linear_out", ctx.reshape(b, t, d))


def _cgmlp(ref, W, name, y, npm, gen):
    hid = F.gelu(ref.lin(W, name + ".channel_proj1", y))
    value, gate = hid.chunk(2, dim=-1)
    gate = ref.ln(W, name + ".norm", gate, EPS) * npm
    gate = _dwconv(ref, W, name + ".conv", gate)
    return ref.lin(W, name + ".channel_proj2", ref.drop(value * gate, gen))


def forward(ref, W, x, lengths, gen):
    t = x.shape[1]
    npm, pad = ref.pad_masks(lengths, t)
    mask = pad[:, None, :].expand(x.shape[0], t, t)
    h = ref.lin(W, "encoder.input_linear", x)
    d = h.shape[-1]
    h = ref.drop(h * math.sqrt(d), gen)
    pe = ref.drop(_table(t, d, x.device), gen)
    for i in range(ref.c["num_enc_layers"]):
        name = f"encoder.blocks.{i}"
        h = h + 0.5 * _ffn(ref, W, name + ".ff1", h, gen)
        x1 = ref.drop(_attn(ref, W, name + ".attn",
                            ref.ln(W, name + ".norm_mha", h, EPS), pe, mask,
                            gen), gen)
        x2 = ref.drop(_cgmlp(ref, W, name + ".cgmlp",
                             ref.ln(W, name + ".norm_mlp", h, EPS), npm, gen),
                      gen)
        cat = torch.cat([x1, x2], dim=-1) * npm
        cat = cat + _dwconv(ref, W, name + ".depthwise_conv_fusion", cat)
        h = h + ref.drop(ref.lin(W, name + ".merge_proj", cat), gen)
        h = h + 0.5 * _ffn(ref, W, name + ".ff2", h, gen)
        h = ref.ln(W, name + ".norm_final", h, EPS) * npm
    return ref.ln(W, "encoder.after_norm", h, EPS) * npm


def flops(c: dict, b: int, t: int) -> float:
    """The input linear; per block both FFN halves, q, k, v and out, the
    position projection of the 2T'-1 table rows (once a batch), the
    content and position scores and the context (T' x T' each), the
    cgMLP's two linears and gate conv, the merge's conv and linear."""
    tt, d_in = roofline.vgg_out(c, t)
    d, lu, cu = c["dim_model"], c["linear_units"], c["cgmlp_linear_units"]
    rows, lin = b * tt, roofline.lin
    block = (2 * (lin(rows, d, lu) + lin(rows, lu, d))
             + 4 * lin(rows, d, d) + lin(2 * tt - 1, d, d)
             + 3 * 2.0 * b * tt * tt * d
             + lin(rows, d, cu) + 2.0 * rows * (cu // 2) * c["cgmlp_conv_kernel"]
             + lin(rows, cu // 2, d)
             + 2.0 * rows * 2 * d * c["merge_conv_kernel"]
             + lin(rows, 2 * d, d))
    return lin(rows, d_in, d) + c["num_enc_layers"] * block
