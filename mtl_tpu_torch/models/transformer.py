"""Top-level ASR Transformer (port of mtl_tpu/models/transformer.py;
reference models/asr/transformer.py:14-240).

conv subsampler -> encoder (the Transformer's, or with ``encoder_type=
"conformer"`` the Conformer's of ``conformer.py``, with ``"e_branchformer"``
the E-Branchformer's of ``ebranchformer.py``) -> decoder. ``forward``
is the teacher-forced pass of training (mtl_tpu/models/transformer.py:
101-111), with the encoder output beside the logits for the discriminator
heads (``forward_with_encoder``, :113); decoding runs ``prepare_decode``
(encoder output + cross-attention K/V per decoder layer), ``init_cache``
and ``decode_step``. ``serving_copy`` casts the linear
weights to the compute dtype once, for decoding. Construction from a
Config mirrors init_transformer_model (utils/functions.py:307-351),
including the derived ``dim_input``. Parameters are named so that
``interop.py`` maps them one to one onto the JAX package's param tree.

``remat`` recomputes each encoder layer (block) in the backward,
``remat_conv`` the whole conv front-end (``remat.checkpoint_module``); as
in the JAX package (:91-96) the front-end then runs with ``train=False``,
so emb_cnn's BatchNorm normalizes by its running averages and reports no
statistics. ``second_order`` picks the routes that autograd
differentiates twice: the VGG stack's plain version (``subsampler.py``)
and the unfolded depthwise conv (``conformer.py``) of the Conformer and
the E-Branchformer.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..utils.trace import span
from .conformer import ConformerEncoder, DepthwiseConv
from .decoder import Decoder, LayerKV
from .ebranchformer import EBranchformerEncoder
from .encoder import Encoder
from .remat import checkpoint_module
from .subsampler import FeatureExtractor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ASRTransformer(nn.Module):
    def __init__(self, vocab_size: int, feat_extractor: str = "vgg_cnn",
                 num_enc_layers: int = 2, num_dec_layers: int = 4,
                 num_heads: int = 8, dim_model: int = 512, dim_key: int = 64,
                 dim_value: int = 64, dim_input: int = 5120,
                 dim_inner: int = 512, dim_emb: int = 512,
                 dropout: float = 0.1, src_max_length: int = 2500,
                 trg_max_length: int = 1000, is_factorized: bool = False,
                 r: int = 100, dtype: torch.dtype = torch.bfloat16,
                 encoder_type: str = "transformer", remat: bool = False,
                 remat_conv: bool = False, second_order: bool = False,
                 linear_units: int = 2048, cgmlp_linear_units: int = 2048,
                 cgmlp_conv_kernel: int = 31, merge_conv_kernel: int = 3):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.remat_conv = remat_conv
        self.conv = FeatureExtractor(feat_extractor, dtype=dtype,
                                     plain=second_order)
        if encoder_type == "conformer":
            self.encoder = ConformerEncoder(
                num_enc_layers, num_heads, dim_model, dim_input,
                dropout=dropout, dtype=dtype, remat=remat,
                second_order=second_order)
        elif encoder_type == "e_branchformer":
            self.encoder = EBranchformerEncoder(
                num_enc_layers, num_heads, dim_model, dim_input,
                linear_units=linear_units,
                cgmlp_linear_units=cgmlp_linear_units,
                cgmlp_conv_kernel=cgmlp_conv_kernel,
                merge_conv_kernel=merge_conv_kernel, dropout=dropout,
                dtype=dtype, remat=remat, second_order=second_order)
        elif encoder_type == "transformer":
            self.encoder = Encoder(
                num_enc_layers, num_heads, dim_model, dim_key, dim_value,
                dim_input, dim_inner, dropout=dropout,
                src_max_length=src_max_length, is_factorized=is_factorized,
                r=r, dtype=dtype, remat=remat)
        else:
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        self.decoder = Decoder(vocab_size, num_dec_layers, num_heads, dim_emb,
                               dim_model, dim_inner, dim_key, dim_value,
                               dropout=dropout, trg_max_length=trg_max_length,
                               is_factorized=is_factorized, r=r, dtype=dtype)

    def encode(self, features: torch.Tensor, input_lengths: torch.Tensor,
               gen: Optional[torch.Generator] = None,
               train_conv: bool = False,
               stats_out: Optional[list] = None) -> torch.Tensor:
        """features [B, T, F] log-spectrogram frames, input_lengths [B] raw
        frame counts (the encoder masks use them against downsampled time,
        the reference's quirk). ``train_conv`` runs emb_cnn's BatchNorm on
        the batch's statistics and reports the new running statistics to
        ``stats_out`` (mtl_tpu/models/transformer.py:84-99); under
        ``remat_conv`` it never does."""
        with span("model.vgg"):
            if self.remat_conv:
                frames = checkpoint_module(self.conv, features)
            else:
                frames = self.conv(features, train_conv, stats_out)
        with span("model.encoder"):
            return self.encoder(frames, input_lengths, gen)

    def forward(self, features: torch.Tensor, input_lengths: torch.Tensor,
                seq_in: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_encoder: bool = False,
                stats_out: Optional[list] = None):
        """Teacher-forced logits B x L x V (f32). ``deterministic=False``
        applies dropout, drawn from ``generator``, and trains emb_cnn's
        BatchNorm (its new running statistics go to ``stats_out`` when
        given). ``return_encoder`` returns (logits, encoder output [B, T',
        d_model]), the discriminator heads' input
        (``forward_with_encoder``)."""
        gen = None if deterministic else generator
        if gen is None and not deterministic and self.dropout > 0:
            raise ValueError("dropout needs a generator when not "
                             "deterministic")
        enc = self.encode(features, input_lengths, gen,
                          train_conv=not deterministic, stats_out=stats_out)
        with span("model.decoder"):
            logits = self.decoder(seq_in, enc, input_lengths, gen)
        return (logits, enc) if return_encoder else logits

    def forward_with_encoder(self, features, input_lengths, seq_in,
                             deterministic: bool = True, generator=None):
        """(logits, encoder output) (mtl_tpu/models/transformer.py:113)."""
        return self(features, input_lengths, seq_in, deterministic, generator,
                    return_encoder=True)

    def prepare_decode(self, features: torch.Tensor,
                       input_lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[LayerKV]]:
        enc = self.encode(features, input_lengths)
        with span("model.cross_kv"):
            return enc, self.decoder.precompute_enc_kv(enc)

    def decode_step(self, y_t, t, enc_kvs, caches):
        return self.decoder.decode_step(y_t, t, enc_kvs, caches)

    def init_cache(self, batch: int, max_steps: int, device: torch.device):
        return self.decoder.init_cache(batch, max_steps, device)


def build_model(cfg: Config, vocab_size: int,
                device: Optional[torch.device] = None) -> ASRTransformer:
    """Construct the model from config (init_transformer_model parity).
    Load a state_dict or call ``init_weights`` before use."""
    cfg.finalize()
    m = cfg.model
    return ASRTransformer(
        vocab_size=vocab_size, feat_extractor=m.feat_extractor,
        num_enc_layers=m.num_enc_layers, num_dec_layers=m.num_dec_layers,
        num_heads=m.num_heads, dim_model=m.dim_model, dim_key=m.dim_key,
        dim_value=m.dim_value, dim_input=m.dim_input, dim_inner=m.dim_inner,
        dim_emb=m.dim_emb, dropout=m.dropout, src_max_length=m.src_max_len,
        trg_max_length=m.tgt_max_len, is_factorized=m.is_factorized, r=m.r,
        dtype=DTYPES[m.dtype], encoder_type=m.encoder_type, remat=m.remat,
        remat_conv=m.remat_conv, second_order=cfg.train.second_order,
        linear_units=m.linear_units, cgmlp_linear_units=m.cgmlp_linear_units,
        cgmlp_conv_kernel=m.cgmlp_conv_kernel,
        merge_conv_kernel=m.merge_conv_kernel,
    ).to(device)


def serving_copy(model: ASRTransformer) -> ASRTransformer:
    """Casts every linear's weight and bias to the compute dtype, once, in
    place: the values flax's per-call cast gives, without a cast launch per
    call on the decode loop. A model built for ``--second-order`` serves on
    the VGG kernels and cuDNN's depthwise conv all the same (decoding takes
    no second derivative). For decoding only; checkpoints hold f32."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.to(model.dtype)
        elif isinstance(module, DepthwiseConv):
            module.unfolded = False
    model.conv.plain = False
    return model


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init like the JAX package's: xavier-uniform for every matrix,
    embedding and conv kernel; zero biases; LayerNorm and BatchNorm scale
    1, bias 0; BatchNorm running mean 0, var 1. Draws on the CPU from
    ``generator`` so the weights do not depend on the device."""
    for name, b in model.named_buffers():
        if name.endswith((".mean", ".var")):
            b.fill_(1.0 if name.endswith(".var") else 0.0)
    ones = {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, nn.LayerNorm)}
    for name, p in model.named_parameters():
        if p.dim() < 2:
            p.copy_(torch.ones_like(p) if name in ones or name.endswith(
                ".scale") else torch.zeros_like(p))
            continue
        if p.dim() == 4:  # HWIO conv kernel
            rf = p.shape[0] * p.shape[1]
            fan_in, fan_out = rf * p.shape[2], rf * p.shape[3]
        elif p.dim() == 3:  # conv1d [C_out, C_in / groups, k]
            fan_in, fan_out = p.shape[2] * p.shape[1], p.shape[2] * p.shape[0]
        else:  # torch [out, in]; flax embeddings are [vocab, dim]
            fan_out, fan_in = p.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        w = torch.empty(p.shape, dtype=torch.float32)
        w.uniform_(-bound, bound, generator=generator)
        p.copy_(w)
