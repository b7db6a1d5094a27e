"""A plain float32 E-Branchformer ASR model in plain torch, the yardstick of
``tests/test_torch_port_ebranchformer.py``. It imports nothing of
``mtl_tpu_torch`` or of JAX and is written from the model's equations
(Kim et al., arXiv:2210.00077; ESPnet's E-Branchformer block with its
relative-position attention), not from the port's modules.

Weights come in as a dict keyed by the port's parameter names. The model:

* VGG, where ``W`` holds its kernels: two blocks of conv3x3 -> ReLU ->
  conv3x3 -> ReLU -> 2x2 max-pool over the (freq, time) plane of
  log-spectrogram frames [B, T, F], the result flattened freq-major to
  [B, T // 4, (F // 4) * 128]; else the frames go to the encoder as they
  are;
* encoder: the input linear times sqrt(d), then blocks of

      x += 0.5 FFN(x); x1 = RelAttn(LN(x)); x2 = cgMLP(LN(x));
      c = [x1, x2] * m; x += W_merge (c + DWConv(c)); x += 0.5 FFN(x);
      x = LN(x) * m

  with ``m`` the pad mask of the raw frame counts against the subsampled
  axis, a final LayerNorm and the mask. Every LayerNorm's epsilon is
  1e-12. ``score_ij = ((q_i + u) . k_j + (q_i + v) . p_{i-j}) / sqrt(d_k)``
  with ``p_r = W_pos PE(r)`` and ``PE(r)`` the interleaved sin and cos of
  ``r * 10000^(-2i/d)``; ``p_{i-j}`` is gathered by index from the table of
  ``r = T-1 ... -(T-1)``. The cgMLP: W_1, exact GELU, value and gate halves,
  the gate through LayerNorm, the pad mask and a depthwise conv, their
  product, W_2;
* decoder: the port's transformer decoder (embedding with the PAD row zero,
  sinusoids, post-LN rank-r attention and FFN, the EOS pad mask) and a
  token-mean cross entropy.

Dropout, with a generator, draws ``torch.rand(shape) < 1 - p`` at each
site in the model's order: the scaled input and the relative table; per
block the FFN's hidden and output, the attention probabilities and output,
the gated product and the cgMLP's output, the merge's output, the second
FFN's; then the decoder's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PAD, SOS, EOS = 0, 1, 2
EPS = 1e-12


class Plain:
    def __init__(self, W, num_heads, num_enc_layers, num_dec_layers,
                 dropout=0.0, gen=None):
        self.W, self.h = W, num_heads
        self.n_enc, self.n_dec = num_enc_layers, num_dec_layers
        self.p, self.gen = dropout, gen
        self.front_end = "conv.convs.0.kernel" in W  # else no VGG

    def drop(self, x):
        if self.gen is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def lin(self, name, x):
        y = x @ self.W[name + ".weight"].t()
        b = self.W.get(name + ".bias")
        return y if b is None else y + b

    def ln(self, name, x, eps=EPS):
        return F.layer_norm(x, x.shape[-1:], self.W[name + ".weight"],
                            self.W[name + ".bias"], eps)

    def dwconv(self, name, x):
        """Depthwise conv over time of x [B, T, C], SAME, with bias."""
        w = self.W[name + ".weight"]
        y = F.conv1d(x.transpose(1, 2), w, self.W[name + ".bias"],
                     padding=(w.shape[-1] - 1) // 2, groups=w.shape[0])
        return y.transpose(1, 2)

    # -- front end ---------------------------------------------------------
    def vgg(self, feats):
        y = feats.transpose(1, 2)[:, None]  # [B, 1, F, T]
        for i in range(4):
            w = self.W[f"conv.convs.{i}.kernel"].permute(3, 2, 0, 1)
            y = F.relu(F.conv2d(y, w, self.W[f"conv.convs.{i}.bias"],
                                padding=1))
            if i % 2:
                y = F.max_pool2d(y, 2)
        b, c, f, t = y.shape
        return y.permute(0, 3, 2, 1).reshape(b, t, f * c)

    # -- encoder -------------------------------------------------------------
    @staticmethod
    def rel_table(t, d):
        """[2T-1, d]: row j is PE(T-1-j)."""
        r = torch.arange(t - 1, -t, -1, dtype=torch.float64)
        w = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
        pe = torch.empty(2 * t - 1, d, dtype=torch.float64)
        pe[:, 0::2] = torch.sin(r[:, None] * w)
        pe[:, 1::2] = torch.cos(r[:, None] * w)
        return pe.float()

    def ffn(self, name, x):
        h = self.lin(name + ".Dense_0", self.ln(name + ".LayerNorm_0", x))
        h = self.drop(h * torch.sigmoid(h))
        return self.drop(self.lin(name + ".Dense_1", h))

    def rel_attention(self, name, y, pe, key_pad):
        b, t, d = y.shape
        dk = d // self.h
        q, k, v = (self.lin(f"{name}.linear_{n}", y).view(b, t, self.h, dk)
                   for n in "qkv")
        p = (pe @ self.W[name + ".linear_pos.weight"].t()).view(-1, self.h, dk)
        i = torch.arange(t)
        p_rel = p[(t - 1) - (i[:, None] - i[None, :])]  # [T, T, H, dk]
        ac = torch.einsum("bihd,bjhd->bhij", q + self.W[name + ".pos_bias_u"],
                          k)
        bd = torch.einsum("bihd,ijhd->bhij", q + self.W[name + ".pos_bias_v"],
                          p_rel)
        scores = (ac + bd) / math.sqrt(dk)
        scores = scores.masked_fill(key_pad[:, None, None, :], float("-inf"))
        attn = self.drop(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, t, d)
        return self.lin(name + ".linear_out", ctx)

    def cgmlp(self, name, y, m):
        h = F.gelu(self.lin(name + ".channel_proj1", y))
        value, gate = h.chunk(2, dim=-1)
        gate = self.ln(name + ".norm", gate) * m
        gate = self.dwconv(name + ".conv", gate)
        return self.lin(name + ".channel_proj2", self.drop(value * gate))

    def encode(self, feats, lengths):
        return self.encoder(self.vgg(feats) if self.front_end else feats,
                            lengths)

    def encoder(self, x, lengths):
        """The encoder on the VGG output x [B, T', d_in]."""
        b, t, _ = x.shape
        key_pad = torch.arange(t)[None, :] >= lengths[:, None]
        m = (~key_pad).float()[..., None]
        h = self.lin("encoder.input_linear", x)
        d = h.shape[-1]
        h = self.drop(h * math.sqrt(d))
        pe = self.drop(self.rel_table(t, d)[None])[0]
        for i in range(self.n_enc):
            n = f"encoder.blocks.{i}"
            h = h + 0.5 * self.ffn(n + ".ff1", h)
            x1 = self.drop(self.rel_attention(
                n + ".attn", self.ln(n + ".norm_mha", h), pe, key_pad))
            x2 = self.drop(self.cgmlp(n + ".cgmlp",
                                      self.ln(n + ".norm_mlp", h), m))
            c = torch.cat([x1, x2], dim=-1) * m
            c = c + self.dwconv(n + ".depthwise_conv_fusion", c)
            h = h + self.drop(self.lin(n + ".merge_proj", c))
            h = h + 0.5 * self.ffn(n + ".ff2", h)
            h = self.ln(n + ".norm_final", h) * m
        return self.ln("encoder.after_norm", h) * m

    # -- decoder -------------------------------------------------------------
    def dense(self, name, x):
        if name + ".a.weight" in self.W:
            return self.lin(name + ".b", x @ self.W[name + ".a.weight"].t())
        return self.lin(name + ".full", x)

    @staticmethod
    def sinusoid(t, d):
        pos = torch.arange(t, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                        * -(math.log(10000.0) / d))
        pe = torch.zeros(t, d)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return pe

    def mha(self, name, xq, xkv, mask):
        b, tq, tk = xq.shape[0], xq.shape[1], xkv.shape[1]
        q = self.dense(name + ".query_linear", xq).view(b, tq, self.h, -1)
        k = self.dense(name + ".key_linear", xkv).view(b, tk, self.h, -1)
        v = self.dense(name + ".value_linear", xkv).view(b, tk, self.h, -1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        scores = scores.masked_fill(mask[:, None], float("-inf"))
        attn = self.drop(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, tq, -1)
        out = self.drop(self.dense(name + ".output_linear", ctx))
        return self.ln(name + ".layer_norm", out + xq, 1e-5)

    def pos_ffn(self, name, x):
        h = self.dense(name + ".linear_2",
                       F.relu(self.dense(name + ".linear_1", x)))
        return self.ln(name + ".layer_norm", self.drop(h) + x, 1e-5)

    def logits(self, enc, lengths, seq_in):
        b, l = seq_in.shape
        emb = self.W["decoder.trg_embedding.weight"][seq_in]
        emb = emb * (seq_in != PAD)[..., None]
        h = self.drop(emb + self.sinusoid(l, emb.shape[-1]))
        future = torch.ones(l, l, dtype=torch.bool).triu(1)
        self_mask = (seq_in == EOS)[:, None, :] | future[None]
        enc_pad = torch.arange(enc.shape[1])[None, :] >= lengths[:, None]
        enc_mask = enc_pad[:, None, :].expand(b, l, enc.shape[1])
        npm = (seq_in != EOS).float()[..., None]
        for i in range(self.n_dec):
            n = f"decoder.layers.{i}"
            h = self.mha(n + ".self_attn", h, h, self_mask) * npm
            h = self.mha(n + ".encoder_attn", h, enc, enc_mask) * npm
            h = self.pos_ffn(n + ".pos_ffn", h) * npm
        return h @ self.W["decoder.output_linear.weight"].t()

    def forward(self, feats, lengths, seq_in):
        """(encoder output, teacher-forced logits)."""
        enc = self.encode(feats, lengths)
        return enc, self.logits(enc, lengths, seq_in)

    @staticmethod
    def loss(logits, seq_out):
        """Token-mean cross entropy over the non-PAD targets."""
        logp = torch.log_softmax(logits, dim=-1)
        tok = -logp.gather(-1, seq_out[..., None])[..., 0]
        mask = seq_out != PAD
        return torch.where(mask, tok, 0.0).sum() / mask.sum()
