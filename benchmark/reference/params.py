"""The parameter names and shapes of a configuration, worked out from the
configuration alone: the checkpoint layout that the program and the
reference share (flax's names, torch's [out, in] linears, HWIO VGG
kernels, torch's [C, 1, k] depthwise kernel). The VGG stack and the
decoder are laid out here, the encoder by ``encoders/<encoder_type>.py``,
which builds its leaves from ``linear``, ``norm``, ``dense``, ``mha`` and
``ffn``."""

from __future__ import annotations

from typing import Dict, Tuple

from .encoders import load

VGG_CHANNELS = (64, 128)


def linear(out: Dict, name: str, n_in: int, n_out: int, bias=True):
    out[name + ".weight"] = (n_out, n_in)
    if bias:
        out[name + ".bias"] = (n_out,)


def norm(out: Dict, name: str, d: int):
    out[name + ".weight"] = (d,)
    out[name + ".bias"] = (d,)


def dense(out, name, n_in, n_out, r):
    """The factorized linear of rank ``r`` (``a`` without bias, then
    ``b``), or with ``r`` None the full one."""
    if r is None:
        linear(out, name + ".full", n_in, n_out)
    else:
        linear(out, name + ".a", n_in, r, bias=False)
        linear(out, name + ".b", r, n_out)


def mha(out, name, c):
    d, h, r = c["dim_model"], c["num_heads"], c["r"]
    for lin, n in (("query_linear", c["dim_key"]), ("key_linear", c["dim_key"]),
                   ("value_linear", c["dim_value"])):
        dense(out, f"{name}.{lin}", d, h * n, r)
    dense(out, name + ".output_linear", h * c["dim_value"], d, r)
    norm(out, name + ".layer_norm", d)


def ffn(out, name, c):
    d, di = c["dim_model"], c["dim_inner"]
    r = c["r"] if c["is_factorized"] else None
    dense(out, name + ".linear_1", d, di, r)
    dense(out, name + ".linear_2", di, d, r)
    norm(out, name + ".layer_norm", d)


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
    load(c["encoder_type"]).param_shapes(c, out)
    out["decoder.trg_embedding.weight"] = (vocab_size, c["dim_emb"])
    for i in range(c["num_dec_layers"]):
        mha(out, f"decoder.layers.{i}.self_attn", c)
        mha(out, f"decoder.layers.{i}.encoder_attn", c)
        ffn(out, f"decoder.layers.{i}.pos_ffn", c)
    out["decoder.output_linear.weight"] = (vocab_size, c["dim_model"])
    return out
