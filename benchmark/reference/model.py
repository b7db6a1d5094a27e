"""The plain reference of the benchmark's ASR models, in plain PyTorch.

It imports nothing of the program. Weights come in as a dict keyed by the
program's parameter names (the checkpoint format both sides share); the
reference computes everything in float32 with TF32 off (``f32_context``),
or, as the control of the correctness check, with every product in float8
(``quant="fp8"``): its operands rounded to e4m3 and the gradients reaching
them to e5m2, each with a per-tensor scale.

The model (reference README.md:47-61, the repository's PARITY.md quirks):

* features: reflect-padded waveforms, frames of n_fft every hop, the
  symmetric Hamming window, log1p |rfft|, a per-utterance mean and unbiased
  std over the valid frames (rsqrt(var + 1e-12)), padded frames zero;
* VGG: two blocks of conv3x3 -> ReLU -> conv3x3 -> ReLU -> 2x2 max-pool in
  the (freq, time) geometry, flattened freq-major;
* encoder: ``encoders/<encoder_type>.py``'s ``forward`` on the VGG output,
  built from the blocks below;
* decoder: embedding (PAD row zero) + PE + dropout, layers of masked
  self-attention, cross-attention and FFN with the EOS pad mask, output
  projection without bias; greedy serving attends causally over its own
  tokens and over every encoder frame, with no pad masks.

Dropout draws ``torch.rand(shape) < 1 - p`` from the generator it is
given, at the sites and in the order the paper's model applies it, so that
the same seed gives the same masks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .encoders import load

PAD, SOS, EOS = 0, 1, 2
FP8_MAX, FP8_E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def f32_context():
    """True float32 products on the card (TF32 off) for the body."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = top / x.abs().amax().clamp_min(1e-12)
    return (x * s).to(dtype).float() / s


class _FP8(torch.autograd.Function):
    """A product operand in float8, as fp8 training computes it: the
    forward value rounded to e4m3, the gradient that reaches it rounded
    to e5m2, each with a per-tensor scale that maps its largest magnitude
    to the format's largest."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, FP8_E5M2_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


class Reference:
    """The reference model of one configuration (the benchmark's config
    file as a dict) on ``device``."""

    def __init__(self, config: dict, device, quant: Optional[str] = None):
        self.c = config
        self.device = torch.device(device)
        self.q = fp8_round if quant == "fp8" else (lambda t: t)
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.p = config["dropout"]
        self.n_fft = int(config["sample_rate"] * config["window_size"])
        self.hop = int(config["sample_rate"] * config["window_stride"])
        self.encoder = load(config["encoder_type"])

    # -- building blocks -------------------------------------------------
    def drop(self, x, gen):
        if gen is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def lin(self, W, name, x, bias=True):
        y = self.q(x) @ self.q(W[name + ".weight"]).t()
        return y + W[name + ".bias"] if bias else y

    def dense(self, W, name, x):
        """The factorized linear (``a`` then ``b``) or the full one."""
        if name + ".a.weight" in W:
            return self.lin(W, name + ".b", self.lin(W, name + ".a", x, False))
        return self.lin(W, name + ".full", x)

    @staticmethod
    def ln(W, name, x, eps):
        return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                            W[name + ".bias"], eps)

    def attention(self, q, k, v, mask, gen):
        """q [B, Tq, H, D], k / v [B, Tk, H, D], mask [B, Tq, Tk] (True:
        masked) -> context [B, Tq, H * D]."""
        scores = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k))
        scores = scores / math.sqrt(q.shape[-1])
        if mask is not None:
            scores = scores.masked_fill(mask[:, None], float("-inf"))
        attn = self.drop(torch.softmax(scores, dim=-1), gen)
        ctx = torch.einsum("bhqk,bkhd->bqhd", self.q(attn), self.q(v))
        return ctx.reshape(q.shape[0], q.shape[1], -1)

    @staticmethod
    def sinusoid(t, d, device):
        pos = np.arange(t, dtype=np.float32)[:, None]
        div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                     * -(math.log(10000.0) / d))
        pe = np.zeros((t, d), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)
        return torch.from_numpy(pe).to(device)

    # -- front end -------------------------------------------------------
    def features(self, audio, lengths):
        """audio [B, S + n_fft] reflect-padded rows, lengths [B] samples ->
        (features [B, T, F], frame counts [B])."""
        n_fft, hop = self.n_fft, self.hop
        t = 1 + (audio.shape[1] - 2 * (n_fft // 2)) // hop
        need = (t - 1) * hop + n_fft
        if audio.shape[1] < need:
            audio = F.pad(audio, (0, need - audio.shape[1]))
        frames = audio.unfold(1, n_fft, hop)[:, :t]
        window = torch.hamming_window(n_fft, periodic=False,
                                      dtype=torch.float64).float()
        spec = torch.log1p(torch.fft.rfft(frames * window.to(audio.device),
                                          dim=-1).abs())
        n_frames = torch.clamp(1 + lengths // hop, max=t)
        valid = (torch.arange(t, device=audio.device)[None, :]
                 < n_frames[:, None])[..., None]
        n = (n_frames * spec.shape[-1]).float()[:, None, None]
        mean = torch.where(valid, spec, 0.0).sum((1, 2), keepdim=True) / n
        var = (torch.where(valid, (spec - mean) ** 2, 0.0).sum(
            (1, 2), keepdim=True) / torch.clamp(n - 1, min=1.0))
        spec = (spec - mean) * torch.rsqrt(var + 1e-12)
        return torch.where(valid, spec, 0.0), n_frames

    def vgg(self, W, x):
        """[B, T, F] -> [B, T // 4, (F // 4) * C]."""
        y = x.transpose(1, 2)[:, None]  # [B, 1, F, T]: H = freq, W = time
        for i in range(4):
            w = W[f"conv.convs.{i}.kernel"].permute(3, 2, 0, 1)
            y = F.relu(F.conv2d(self.q(y), self.q(w),
                                W[f"conv.convs.{i}.bias"], padding=1))
            if i % 2 == 1:
                y = F.max_pool2d(y, 2)
        b, c, f, t = y.shape
        return y.permute(0, 3, 2, 1).reshape(b, t, f * c)

    # -- attention and FFN, shared by the encoders and the decoder -----
    def mha(self, W, name, x_q, x_kv, mask, gen):
        h, dk = self.c["num_heads"], self.c["dim_key"]
        dv = self.c["dim_value"]
        b, tq, tk = x_q.shape[0], x_q.shape[1], x_kv.shape[1]
        q = self.dense(W, name + ".query_linear", x_q).view(b, tq, h, dk)
        k = self.dense(W, name + ".key_linear", x_kv).view(b, tk, h, dk)
        v = self.dense(W, name + ".value_linear", x_kv).view(b, tk, h, dv)
        ctx = self.attention(q, k, v, mask, gen)
        out = self.drop(self.dense(W, name + ".output_linear", ctx), gen)
        return self.ln(W, name + ".layer_norm", out + x_q, 1e-5)

    def ffn(self, W, name, x, gen):
        h = self.dense(W, name + ".linear_2",
                       F.relu(self.dense(W, name + ".linear_1", x)))
        return self.ln(W, name + ".layer_norm", self.drop(h, gen) + x, 1e-5)

    @staticmethod
    def pad_masks(lengths, t):
        pos = torch.arange(t, device=lengths.device)[None, :]
        pad = pos >= lengths[:, None]
        return (~pad).float()[..., None], pad

    # -- encoder ---------------------------------------------------------
    def encode(self, W, audio, lengths, gen=None):
        feats, n_frames = self.features(audio, lengths)
        x = self.vgg(W, feats)
        return self.encoder.forward(self, W, x, n_frames, gen), n_frames

    # -- decoder ---------------------------------------------------------
    def embed(self, W, seq):
        emb = W["decoder.trg_embedding.weight"][seq] * (seq != PAD)[..., None]
        return emb + self.sinusoid(seq.shape[1], emb.shape[-1], emb.device)

    def decoder(self, W, seq_in, enc, self_mask, enc_mask, npm, gen):
        h = self.drop(self.embed(W, seq_in), gen)
        for i in range(self.c["num_dec_layers"]):
            name = f"decoder.layers.{i}"
            h = self.mha(W, name + ".self_attn", h, h, self_mask, gen) * npm
            h = self.mha(W, name + ".encoder_attn", h, enc, enc_mask, gen) * npm
            h = self.ffn(W, name + ".pos_ffn", h, gen) * npm
        return self.q(h) @ self.q(W["decoder.output_linear.weight"]).t()

    def loss(self, W, batch, gen):
        """Teacher-forced token-mean CE of a batch {audio, audio_lengths,
        targets} (targets PAD-padded)."""
        targets = batch["targets"].long()
        b, l = targets.shape
        n_tok = (targets != PAD).sum(-1)
        seq_in = torch.cat([torch.full((b, 1), SOS, device=targets.device),
                            torch.where(targets == PAD, EOS, targets)], 1)
        pos = torch.arange(l + 1, device=targets.device)[None, :]
        seq_out = torch.cat([targets, torch.zeros_like(targets[:, :1])], 1)
        seq_out = torch.where(pos == n_tok[:, None], EOS, seq_out)
        enc, n_frames = self.encode(W, batch["audio"], batch["audio_lengths"],
                                    gen)
        key_pad = (seq_in == EOS)[:, None, :].expand(b, l + 1, l + 1)
        future = torch.ones(l + 1, l + 1, dtype=torch.bool,
                            device=targets.device).triu(1)
        enc_pad = (torch.arange(enc.shape[1], device=enc.device)[None, :]
                   >= n_frames[:, None])
        enc_mask = enc_pad[:, None, :].expand(b, l + 1, enc.shape[1])
        npm = (seq_in != EOS).float()[..., None]
        logits = self.decoder(W, seq_in, enc, key_pad | future[None],
                              enc_mask, npm, gen)
        logp = torch.log_softmax(logits, -1)
        mask = seq_out != PAD
        tok = -logp.gather(-1, seq_out[..., None])[..., 0]
        return torch.where(mask, tok, 0.0).sum() / mask.sum().clamp_min(1)

    def served_logits(self, W, audio, lengths, tokens):
        """Logits [B, L, V] at each served position: the decoder fed SOS
        and the served tokens, attending causally over them and over every
        encoder frame, with no pad masks (greedy decoding's view)."""
        return self.next_logits(W, self.encode(W, audio, lengths)[0], tokens)

    def next_logits(self, W, enc, tokens):
        """The logits that predicted each of ``tokens`` [B, L] (greedy
        decoding's view, as ``served_logits``) from the encoder output."""
        b, l = tokens.shape
        seq_in = torch.cat([torch.full((b, 1), SOS, device=tokens.device),
                            tokens[:, :-1]], 1)
        future = torch.ones(l, l, dtype=torch.bool,
                            device=tokens.device).triu(1)
        ones = torch.ones(b, l, 1, device=tokens.device)
        return self.decoder(W, seq_in, enc, future[None].expand(b, l, l),
                            None, ones, None)
