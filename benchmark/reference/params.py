"""The parameter names and shapes of a configuration, worked out from the
configuration alone: the checkpoint layout that the program and the
reference share (flax's names, torch's [out, in] linears, HWIO VGG
kernels, torch's [C, 1, k] depthwise kernel)."""

from __future__ import annotations

from typing import Dict, Tuple

VGG_CHANNELS = (64, 128)


def _linear(out: Dict, name: str, n_in: int, n_out: int, bias=True):
    out[name + ".weight"] = (n_out, n_in)
    if bias:
        out[name + ".bias"] = (n_out,)


def _norm(out: Dict, name: str, d: int):
    out[name + ".weight"] = (d,)
    out[name + ".bias"] = (d,)


def _dense(out, name, n_in, n_out, r):
    """The factorized linear of rank ``r`` (``a`` without bias, then
    ``b``), or with ``r`` None the full one."""
    if r is None:
        _linear(out, name + ".full", n_in, n_out)
    else:
        _linear(out, name + ".a", n_in, r, bias=False)
        _linear(out, name + ".b", r, n_out)


def _mha(out, name, c):
    d, h, r = c["dim_model"], c["num_heads"], c["r"]
    for lin, n in (("query_linear", c["dim_key"]), ("key_linear", c["dim_key"]),
                   ("value_linear", c["dim_value"])):
        _dense(out, f"{name}.{lin}", d, h * n, r)
    _dense(out, name + ".output_linear", h * c["dim_value"], d, r)
    _norm(out, name + ".layer_norm", d)


def _ffn(out, name, c):
    d, di = c["dim_model"], c["dim_inner"]
    r = c["r"] if c["is_factorized"] else None
    _dense(out, name + ".linear_1", d, di, r)
    _dense(out, name + ".linear_2", di, d, r)
    _norm(out, name + ".layer_norm", d)


def dim_input(c: dict) -> int:
    num_freq = int(c["sample_rate"] * c["window_size"]) // 2 + 1
    return (num_freq // 2 // 2) * VGG_CHANNELS[-1]


def param_shapes(c: dict, vocab_size: int) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    c_in = 1
    for i, ch in enumerate(VGG_CHANNELS):
        out[f"conv.convs.{2 * i}.kernel"] = (3, 3, c_in, ch)
        out[f"conv.convs.{2 * i}.bias"] = (ch,)
        out[f"conv.convs.{2 * i + 1}.kernel"] = (3, 3, ch, ch)
        out[f"conv.convs.{2 * i + 1}.bias"] = (ch,)
        c_in = ch
    d = c["dim_model"]
    if c["encoder_type"] == "conformer":
        e = c["ff_expansion"]
        _linear(out, "encoder.input_linear", dim_input(c), d)
        for i in range(c["num_enc_layers"]):
            b = f"encoder.blocks.{i}"
            for ff in ("ff1", "ff2"):
                _norm(out, f"{b}.{ff}.LayerNorm_0", d)
                _linear(out, f"{b}.{ff}.Dense_0", d, e * d)
                _linear(out, f"{b}.{ff}.Dense_1", e * d, d)
            _norm(out, f"{b}.attn.LayerNorm_0", d)
            for n in "qkv":
                _linear(out, f"{b}.attn.{n}", d, d)
            _linear(out, f"{b}.attn.out", d, d)
            _norm(out, f"{b}.conv.LayerNorm_0", d)
            _linear(out, f"{b}.conv.pw1", d, 2 * d)
            out[f"{b}.conv.dw.weight"] = (d, 1, c["conv_kernel"])
            out[f"{b}.conv.dw.bias"] = (d,)
            _norm(out, f"{b}.conv.norm", d)
            _linear(out, f"{b}.conv.pw2", d, d)
        _norm(out, "encoder.final_norm", d)
    else:
        _dense(out, "encoder.input_linear", dim_input(c), d,
               c["r"] if c["is_factorized"] else None)
        _norm(out, "encoder.layer_norm_input", d)
        for i in range(c["num_enc_layers"]):
            _mha(out, f"encoder.layers.{i}.self_attn", c)
            _ffn(out, f"encoder.layers.{i}.pos_ffn", c)
    out["decoder.trg_embedding.weight"] = (vocab_size, c["dim_emb"])
    for i in range(c["num_dec_layers"]):
        _mha(out, f"decoder.layers.{i}.self_attn", c)
        _mha(out, f"decoder.layers.{i}.encoder_attn", c)
        _ffn(out, f"decoder.layers.{i}.pos_ffn", c)
    out["decoder.output_linear.weight"] = (vocab_size, d)
    return out
