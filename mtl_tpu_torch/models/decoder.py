"""Transformer character decoder (port of mtl_tpu/models/decoder.py;
reference modules/decoder.py:14-323).

Char embedding (PAD row zeroed at lookup, torch ``padding_idx`` semantics)
+ sinusoidal PE + dropout; ``num_layers`` x [masked self-attention ->
*non_pad_mask -> cross-attention -> *non_pad_mask -> post-LN FFN ->
*non_pad_mask]; output projection without bias, its weight f32 and cast to
the compute dtype at the call like every linear.

``forward`` is the teacher-forced pass (mtl_tpu/models/decoder.py:151-170)
with the reference's masks: EOS is the pad id of ``seq_in``; the
self-attention mask is key-pad | subsequent; the decoder-encoder mask comes
from the *raw* encoder input lengths. ``decode_step`` decodes one token over
a KV cache; as the reference's search does, it passes no decoder-encoder
mask, so padded encoder frames are attended.

Split over ``tp`` (parallel/tp.py), the layers split as ``layers.py``
says and the output projection is row-split (JAX's rule for
``output_linear``): each rank multiplies its slice of d_model and the
partial logits are all-reduced before the loss; ``trg_embedding`` stays
replicated. Decoding runs unsplit models only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..data.vocab import EOS_ID, PAD_ID
from ..ops.masks import (attn_key_pad_mask, attn_pad_mask_from_lengths,
                         non_pad_mask_from_ids, subsequent_mask)
from ..parallel import comm
from .layers import (FeedForward, MultiHeadAttention, PositionalEncoding,
                     dropout, linear, row_linear)

# (k, v) pair per layer
LayerKV = Tuple[torch.Tensor, torch.Tensor]


def reorder_caches(caches: List[LayerKV], index: torch.Tensor
                   ) -> List[LayerKV]:
    """Rows ``index`` of every layer's self-attention K/V cache
    ([B*W, T, H, D], gathered along dim 0), as new tensors: ``decode_step``
    writes its caches in place, so a reordered cache must not alias the
    one it came from (the beam's gather by source beam,
    mtl_tpu/decode/beam.py:180-184)."""
    return [(k.index_select(0, index), v.index_select(0, index))
            for k, v in caches]


class DecoderLayer(nn.Module):
    def __init__(self, num_heads: int, dim_model: int, dim_inner: int,
                 dim_key: int, dim_value: int, dropout: float = 0.1,
                 is_factorized: bool = False, r: int = 100,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(dropout=dropout, r=r, dtype=dtype)
        self.self_attn = MultiHeadAttention(num_heads, dim_model, dim_key,
                                            dim_value, **kw)
        self.encoder_attn = MultiHeadAttention(num_heads, dim_model, dim_key,
                                               dim_value, **kw)
        self.pos_ffn = FeedForward(dim_model, dim_inner, dropout=dropout,
                                   factorized=is_factorized, r=r, dtype=dtype)

    def forward(self, dec_input: torch.Tensor, enc_output: torch.Tensor,
                non_pad_mask: torch.Tensor, self_attn_mask: torch.Tensor,
                dec_enc_attn_mask: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """mtl_tpu/models/decoder.py:68-86."""
        h = self.self_attn(dec_input, dec_input, dec_input,
                           mask=self_attn_mask, gen=gen)
        h = h * non_pad_mask.to(h.dtype)
        h = self.encoder_attn(h, enc_output, enc_output,
                              mask=dec_enc_attn_mask, gen=gen)
        h = h * non_pad_mask.to(h.dtype)
        h = self.pos_ffn(h, gen)
        return h * non_pad_mask.to(h.dtype)

    def step(self, h_t: torch.Tensor, self_cache: LayerKV, enc_kv: LayerKV,
             t: int) -> Tuple[torch.Tensor, LayerKV]:
        h, ck, cv = self.self_attn.decode_step(h_t, self_cache[0],
                                               self_cache[1], t)
        h = self.encoder_attn.cross_step(h, enc_kv[0], enc_kv[1], mask=None)
        return self.pos_ffn(h), (ck, cv)

    def enc_kv(self, enc_output: torch.Tensor) -> LayerKV:
        return self.encoder_attn.project_kv(enc_output, enc_output)


class Decoder(nn.Module):
    # the model axis when ``output_linear`` is row-split (parallel/tp.py)
    tp = None

    def __init__(self, vocab_size: int, num_layers: int, num_heads: int,
                 dim_emb: int, dim_model: int, dim_inner: int, dim_key: int,
                 dim_value: int, dropout: float = 0.1,
                 trg_max_length: int = 1000, is_factorized: bool = False,
                 r: int = 100, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dim_key, self.dim_value = num_heads, dim_key, dim_value
        self.dtype, self.dropout = dtype, dropout
        self.trg_embedding = nn.Embedding(vocab_size, dim_emb)
        self.positional_encoding = PositionalEncoding(dim_model,
                                                      trg_max_length)
        self.layers = nn.ModuleList(
            DecoderLayer(num_heads, dim_model, dim_inner, dim_key, dim_value,
                         dropout=dropout, is_factorized=is_factorized, r=r,
                         dtype=dtype)
            for _ in range(num_layers))
        self.output_linear = nn.Linear(dim_model, vocab_size, bias=False)

    def _embed(self, seq: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """Token embedding with torch padding_idx semantics + PE (f32)."""
        emb = self.trg_embedding(seq) * (seq != PAD_ID)[..., None]
        return emb + self.positional_encoding(seq.shape[1], offset)

    def forward(self, seq_in: torch.Tensor, enc_output: torch.Tensor,
                enc_input_lengths: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits B x L x V in f32 from the EOS-padded input
        ``seq_in`` B x L and the raw encoder input lengths."""
        _, l = seq_in.shape
        non_pad_mask = non_pad_mask_from_ids(seq_in, EOS_ID)
        self_attn_mask = (attn_key_pad_mask(seq_in, l, EOS_ID)
                          | subsequent_mask(l, seq_in.device)[None])
        dec_enc_attn_mask = attn_pad_mask_from_lengths(
            enc_input_lengths, enc_output.shape[1], l)
        h = dropout(self._embed(seq_in), self.dropout, gen).to(self.dtype)
        for layer in self.layers:
            h = layer(h, enc_output, non_pad_mask, self_attn_mask,
                      dec_enc_attn_mask, gen)
        if self.tp is not None:  # partial logits of this rank's d_model rows
            h = comm.scatter_to_model(h, self.tp)
            return row_linear(h, self.output_linear, self.dtype,
                              self.tp).float()
        return linear(h, self.output_linear, self.dtype).float()

    def precompute_enc_kv(self, enc_output: torch.Tensor) -> List[LayerKV]:
        return [layer.enc_kv(enc_output) for layer in self.layers]

    def init_cache(self, batch: int, max_steps: int,
                   device: torch.device) -> List[LayerKV]:
        shape_k = (batch, max_steps, self.num_heads, self.dim_key)
        shape_v = (batch, max_steps, self.num_heads, self.dim_value)
        return [(torch.zeros(shape_k, dtype=self.dtype, device=device),
                 torch.zeros(shape_v, dtype=self.dtype, device=device))
                for _ in self.layers]

    def decode_step(self, y_t: torch.Tensor, t: int, enc_kvs: List[LayerKV],
                    caches: List[LayerKV]
                    ) -> Tuple[torch.Tensor, List[LayerKV]]:
        """One step for current ids y_t [B] at position t; returns (logits
        B x V f32, caches updated in place)."""
        h = self._embed(y_t[:, None], offset=t).to(self.dtype)
        new_caches = []
        for layer, enc_kv, cache in zip(self.layers, enc_kvs, caches):
            h, cache = layer.step(h, cache, enc_kv, t)
            new_caches.append(cache)
        return linear(h[:, 0], self.output_linear, self.dtype).float(), \
            new_caches
