"""The yardstick's arithmetic: the card's published peaks, the least time
a kernel's work could take, and the model FLOPs of a training step or a
served batch, all counted from shapes and never from the kernel that ran.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at a 700 W
power limit (frozen from ``chip_smoke.py``): 989 TFLOP/s bf16, 495 TF32,
67 f32 outside the tensor cores, 3.35 TB/s of HBM. The bound of a kernel
is the larger of its bytes at the memory rate (each input byte read once,
each output byte written once) and its operations at the rate of its
precision (``bound_s``, after ``chip_smoke.py:_bound_ms``; f32 work in
GEMM form takes the faster of f32 FMAs and three TF32 passes,
``bound_f32_gemm_s`` after ``_bound_f32_gemm``).

Model FLOPs count the multiply-adds (two operations each) of the VGG
convolutions, every linear, the attention products and the output
projection at the padded shapes a step runs; a training step's backward
counts twice its forward (one product for the input's gradient, one for
the weight's), except the first convolution, whose input needs none, and
nothing recomputed counts again. The encoder's forward is counted by
``reference/encoders/<encoder_type>.py`` (``encoder_flops``), from
``lin``, ``dense``, ``mha``, ``ffn`` and ``vgg_out``.
"""

from __future__ import annotations

import math
from typing import Dict

from reference.encoders import load

PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
VGG_CHANNELS = (64, 128)
F32, BF16 = 4, 2


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / peak)


def bound_f32_gemm_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES,
               min(flops / PEAK_F32, 3 * flops / PEAK_TF32))


# -- kernels ---------------------------------------------------------------

def vgg_block_work(b: int, t: int, f: int, c_in: int, c: int,
                   x_bytes: int, out_bytes: int) -> Dict[str, float]:
    """One fused VGG block on x [B, T, F, C_in]: both 3x3 convolutions'
    operations; x, the f32 weights and biases read once, the pooled output
    [B, T // 2, F // 2, C] written once."""
    flops = 2 * b * t * f * 9 * (c_in * c + c * c)
    weights = (9 * c_in * c + c + 9 * c * c + c) * F32
    nbytes = (b * t * f * c_in * x_bytes + weights
              + b * (t // 2) * (f // 2) * c * out_bytes)
    return {"flops": flops, "bytes": nbytes}


def vgg_stack_bound_s(b: int, t: int, f: int) -> float:
    """The two bf16 blocks of one VGG stack on features [B, T, F] f32:
    block 1 reads f32 and writes bf16, block 2 reads and writes bf16."""
    c1, c2 = VGG_CHANNELS
    w1 = vgg_block_work(b, t, f, 1, c1, F32, BF16)
    w2 = vgg_block_work(b, t // 2, f // 2, c1, c2, BF16, BF16)
    return (bound_s(w1["bytes"], w1["flops"], PEAK_BF16)
            + bound_s(w2["bytes"], w2["flops"], PEAK_BF16))


def stft_fft_work(b: int, t: int, n_fft: int, hop: int) -> Dict[str, float]:
    """The FFT STFT of [B, (T - 1) * hop + n_fft] prepadded f32 rows into
    [B, T, n_fft // 2 + 1] f32: the packed M-point complex FFT (5 M log2 M)
    and the split and magnitude (~10 a bin) per frame; the rows, the window
    and the [n_fft, 2] twiddles read once, the output written once."""
    m, nf = n_fft // 2, n_fft // 2 + 1
    flops = b * t * (5 * m * math.log2(m) + 10 * nf)
    samples = (t - 1) * hop + n_fft
    nbytes = (b * samples + n_fft + 2 * n_fft + b * t * nf) * F32
    return {"flops": flops, "bytes": nbytes}


def stft_bound_s(b: int, t: int, n_fft: int, hop: int) -> float:
    w = stft_fft_work(b, t, n_fft, hop)
    return bound_s(w["bytes"], w["flops"], PEAK_F32)


# -- model FLOPs -------------------------------------------------------------

def lin(rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def dense(c: dict, rows: int, n_in: int, n_out: int,
          factorized: bool) -> float:
    if factorized:
        return lin(rows, n_in, c["r"]) + lin(rows, c["r"], n_out)
    return lin(rows, n_in, n_out)


def vgg_flops(c: dict, b: int, t: int) -> Dict[str, float]:
    """{"first": the first convolution, "rest": the other three} of the
    VGG stack on [B, T, F]."""
    f = int(c["sample_rate"] * c["window_size"]) // 2 + 1
    c1, c2 = VGG_CHANNELS
    first = 2.0 * b * t * f * 9 * c1
    rest = (2.0 * b * t * f * 9 * c1 * c1
            + 2.0 * b * (t // 2) * (f // 2) * 9 * (c1 * c2 + c2 * c2))
    return {"first": first, "rest": rest}


def mha(c: dict, b: int, tq: int, tk: int, kv_rows: int = -1) -> float:
    """Projections of the queries and of ``kv_rows`` keys and values a row
    (default all ``tk``), the scores, the context and the output
    projection."""
    d, h = c["dim_model"], c["num_heads"]
    dk, dv = c["dim_key"], c["dim_value"]
    kv = tk if kv_rows < 0 else kv_rows
    fl = dense(c, b * tq, d, h * dk, True)
    if kv:
        fl += (dense(c, b * kv, d, h * dk, True)
               + dense(c, b * kv, d, h * dv, True))
    fl += 2.0 * b * h * tq * tk * (dk + dv)
    return fl + dense(c, b * tq, h * dv, d, True)


def ffn(c: dict, rows: int) -> float:
    f = c["is_factorized"]
    return (dense(c, rows, c["dim_model"], c["dim_inner"], f)
            + dense(c, rows, c["dim_inner"], c["dim_model"], f))


def vgg_out(c: dict, t: int):
    """(frames, width) of the VGG output of T feature frames."""
    f = int(c["sample_rate"] * c["window_size"]) // 2 + 1
    return t // 4, (f // 4) * VGG_CHANNELS[-1]


def encoder_flops(c: dict, b: int, t: int) -> float:
    """The encoder on the VGG output [B, T // 4, (F // 4) * 128], as
    ``reference/encoders/<encoder_type>.py`` counts it."""
    return load(c["encoder_type"]).flops(c, b, t)


def decoder_flops(c: dict, vocab: int, b: int, t: int, l: int) -> float:
    """The teacher-forced decoder over L positions against T // 4 frames,
    with the output projection."""
    tt = t // 4
    layer = mha(c, b, l, l) + mha(c, b, l, tt) + ffn(c, b * l)
    return c["num_dec_layers"] * layer + lin(b * l, c["dim_model"], vocab)


def forward_flops(c: dict, vocab: int, b: int, t: int, l: int) -> float:
    v = vgg_flops(c, b, t)
    return (v["first"] + v["rest"] + encoder_flops(c, b, t)
            + decoder_flops(c, vocab, b, t, l))


def train_flops(c: dict, vocab: int, b: int, t: int, l: int) -> float:
    """Forward and backward of one batch [B, T frames, L positions]: the
    backward twice the forward, less the first convolution's input
    gradient."""
    fwd = forward_flops(c, vocab, b, t, l)
    return 3.0 * fwd - vgg_flops(c, b, t)["first"]


def meta_step_flops(c: dict, vocab: int, k: int, b_support: int,
                    b_query: int, t: int, l: int) -> float:
    """A first-order meta step: per task the support batch's forward and
    backward at the shared weights and the query batch's at the adapted
    ones (L = the target bucket + 1 teacher-forced positions)."""
    return k * (train_flops(c, vocab, b_support, t, l)
                + train_flops(c, vocab, b_query, t, l))


def decode_flops(c: dict, vocab: int, b: int, t: int, steps: int) -> float:
    """A served batch: the VGG stack and the encoder on [B, T], the cross
    K/V of every decoder layer, then ``steps`` greedy steps, step s
    attending over s + 1 cached positions and T // 4 frames."""
    tt = t // 4
    d, h = c["dim_model"], c["num_heads"]
    dk, dv = c["dim_key"], c["dim_value"]
    v = vgg_flops(c, b, t)
    fl = v["first"] + v["rest"] + encoder_flops(c, b, t)
    fl += c["num_dec_layers"] * (dense(c, b * tt, d, h * dk, True)
                                 + dense(c, b * tt, d, h * dv, True))
    for s in range(steps):
        self_attn = mha(c, b, 1, s + 1, kv_rows=1)
        cross = mha(c, b, 1, tt, kv_rows=0)
        fl += c["num_dec_layers"] * (self_attn + cross + ffn(c, b))
        fl += lin(b, d, vocab)
    return fl
