"""The paper's Transformer encoder: input linear, LayerNorm (eps 1e-5),
sinusoidal PE, then layers of post-LN rank-r factorized attention and FFN,
each output times the pad mask built from the *raw* frame counts against
the subsampled time axis."""

from __future__ import annotations

import roofline
from reference import params


def param_shapes(c: dict, out: dict) -> None:
    params.dense(out, "encoder.input_linear", params.dim_input(c),
                 c["dim_model"], c["r"] if c["is_factorized"] else None)
    params.norm(out, "encoder.layer_norm_input", c["dim_model"])
    for i in range(c["num_enc_layers"]):
        params.mha(out, f"encoder.layers.{i}.self_attn", c)
        params.ffn(out, f"encoder.layers.{i}.pos_ffn", c)


def forward(ref, W, x, lengths, gen):
    t = x.shape[1]
    npm, pad = ref.pad_masks(lengths, t)
    mask = pad[:, None, :].expand(x.shape[0], t, t)
    h = ref.ln(W, "encoder.layer_norm_input",
               ref.dense(W, "encoder.input_linear", x), 1e-5)
    h = h + ref.sinusoid(t, h.shape[-1], h.device)
    for i in range(ref.c["num_enc_layers"]):
        name = f"encoder.layers.{i}"
        h = ref.mha(W, name + ".self_attn", h, h, mask, gen) * npm
        h = ref.ffn(W, name + ".pos_ffn", h, gen) * npm
    return h


def flops(c: dict, b: int, t: int) -> float:
    tt, d_in = roofline.vgg_out(c, t)
    block = roofline.mha(c, b, tt, tt) + roofline.ffn(c, b * tt)
    return (roofline.dense(c, b * tt, d_in, c["dim_model"],
                           c["is_factorized"])
            + c["num_enc_layers"] * block)
