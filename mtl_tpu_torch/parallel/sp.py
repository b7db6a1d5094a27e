"""Sequence-parallel long-form encoding over the mesh's ``model`` axis (the
counterpart of mtl_tpu/parallel/sp.py), the path of ``test_main
--mesh-model M``.

The mesh is ``task 1 x data D x model M``: the batch is split over
``data`` and the time axis over ``model``. Each rank of a ``model`` group
encodes one time slice of its batch shard; the collectives that XLA's SPMD
partitioner inserts in the JAX package are written out here
(``parallel/comm.py``):

* front-end: every rank holds the batch's whole feature tensor (the
  features are computed before the encode, as in the JAX package), so the
  convolutional front-end needs no exchange. A rank cuts its slice plus a
  halo from it, runs the front-end (on a card: the VGG kernels) on the
  haloed slice and crops the frames that the halo makes exact. The halo is
  derived from the front-end's time kernels, strides and paddings
  (``front_end_geometry``) and rounded up to a multiple of the total
  stride, so that the slices' pools line up with the unsharded pools;
* encoder layer norms, FFNs and residuals are per frame and stay local;
  the sinusoidal PE and the Conformer's RoPE take each slice's *global*
  positions, and the pad masks compare global positions with the raw input
  lengths (the reference's quirk, ``models/encoder.py``);
* self-attention all-gathers K and V over ``model``: each rank's scores are
  ``[B, H, T'/M, T']``, the memory the path exists to divide;
* the Conformer's depthwise conv (kernel 31) takes 15 frames from each
  neighbouring slice (``neighbour_context``).

The E-Branchformer (``models/ebranchformer.py``) has no route here: its
relative-position scores and its merge conv would need their own
exchanges, and ``check_encoder`` refuses it by name.

Output slices are ``ceil(T'/M)`` encoder frames (the last rank's shorter
when M does not divide T'), so every slice starts at a multiple of the total
stride in input frames; T is never padded (under the raw-length mask quirk
extra frames would be attended). The gathers run over ``[M, longest
slice]`` buffers cropped to the true lengths. ``greedy_search_sp`` gathers
the encoder output to rank 0, which runs the decoder unsharded
(``precompute_enc_kv`` and the greedy loop of ``decode/greedy.py``), as
mtl_tpu/parallel/sp.py:107-115 does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..models.conformer import ConformerEncoder, rope_angles
from ..models.layers import linear
from ..models.subsampler import CHANNELS, EMB_CNN, subsampled_length
from . import comm


SP_ENCODERS = ("transformer", "conformer")


def check_encoder(encoder_type: str) -> None:
    """A ``ValueError`` for an encoder the sequence-parallel encode does
    not run, before any rank starts."""
    if encoder_type not in SP_ENCODERS:
        raise ValueError(
            f"the sequence-parallel encode (--mesh-model) runs encoder_type "
            f"{' or '.join(SP_ENCODERS)}, not {encoder_type!r}")


def time_layers(feat_extractor: str) -> List[Tuple[int, int, int]]:
    """The front-end's layers along time, in order, as (kernel, stride,
    padding): ``models/subsampler.py``'s VGG blocks (3x3 SAME convs, 2x2
    pools) and emb_cnn's convs."""
    if feat_extractor in CHANNELS:
        block = [(3, 1, 1), (3, 1, 1), (2, 2, 0)]
        return block * len(CHANNELS[feat_extractor])
    if feat_extractor == "emb_cnn":
        return [(size[1], stride[1], padding[1])
                for size, stride, padding in EMB_CNN]
    return []


def front_end_geometry(feat_extractor: str) -> Tuple[int, int, int]:
    """(total stride S, left halo, right halo) in input frames: output
    frame j depends on input frames [S j + lo, S j + hi]; a slice of output
    frames [a, b) is exact when cut from input frames [S a - left, S b +
    right), each halo the least multiple of S that covers the receptive
    field (vgg_cnn: S 4, halos 8 and 8; emb_cnn: S 2, halos 10 and 20)."""
    stride, lo, hi = 1, 0, 0
    for kernel, s, pad in time_layers(feat_extractor):
        lo, hi = lo - stride * pad, hi + stride * (kernel - 1 - pad)
        stride *= s
    left = math.ceil(max(-lo, 0) / stride) * stride
    right = math.ceil(max(hi - (stride - 1), 0) / stride) * stride
    return stride, left, right


def time_slices(num_frames: int, m: int) -> List[Tuple[int, int]]:
    """The ``m`` ranks' [start, end) encoder frames of ``num_frames``:
    ceil(num_frames / m) each, the last shorter. Raises when a slice would
    be empty."""
    chunk = -(-num_frames // m)
    slices = [(min(i * chunk, num_frames), min((i + 1) * chunk, num_frames))
              for i in range(m)]
    if any(a >= b for a, b in slices):
        raise ValueError(
            f"{num_frames} encoder frames cannot be split over --mesh-model "
            f"{m} without an empty slice")
    return slices


def front_end_sp(conv, features: torch.Tensor, feat_extractor: str,
                 start: int, end: int) -> torch.Tensor:
    """Encoder frames [start, end) of ``conv(features)``, computed from the
    haloed input slice alone."""
    stride, left, right = front_end_geometry(feat_extractor)
    x0 = max(0, stride * start - left)
    x1 = min(features.shape[1], stride * end + right)
    frames = conv(features[:, x0:x1])
    return frames[:, start - x0 // stride:end - x0 // stride]


def neighbour_context(h: torch.Tensor, pad: int, lengths: Sequence[int],
                      axis) -> torch.Tensor:
    """``h`` [B, n, C], this rank's time slice, with the ``pad`` frames
    before and after it taken from the other slices (zeros past the ends
    of time, the SAME padding): every rank's first and last ``pad`` frames
    are gathered in one collective, and a slice shorter than ``pad`` lets
    the frames of the one beyond it through."""
    b, n, c = h.shape
    m, me = axis.size, axis.index
    edges = h.new_zeros((b, 2 * pad, c))
    k = min(pad, n)
    edges[:, :k] = h[:, :k]  # head, left-aligned
    edges[:, 2 * pad - k:] = h[:, n - k:]  # tail, right-aligned
    edges = comm.all_gather(edges, axis)  # [M, B, 2 pad, C]
    kept = [min(pad, lengths[i]) for i in range(m)]
    before = [edges[i, :, 2 * pad - kept[i]:] for i in range(me)]
    after = [edges[i, :, :kept[i]] for i in range(me + 1, m)]
    left = torch.cat([h[:, :0]] + before, dim=1)[:, max(0, sum(
        kept[:me]) - pad):]
    right = torch.cat(after + [h[:, :0]], dim=1)[:, :pad]
    return torch.cat([h.new_zeros((b, pad - left.shape[1], c)), left, h,
                      right, h.new_zeros((b, pad - right.shape[1], c))],
                     dim=1)


def _masks(lengths: torch.Tensor, start: int, end: int, total: int):
    """(non-pad mask [B, n, 1] at the slice's global positions, key pad
    mask [B, n, T'] against every key) from the raw input lengths."""
    pos = torch.arange(start, end, device=lengths.device)
    non_pad = (pos[None, :] < lengths[:, None]).float()[:, :, None]
    keys = torch.arange(total, device=lengths.device)[None, :]
    key_pad = (keys >= lengths[:, None])[:, None, :]
    return non_pad, key_pad.expand(lengths.shape[0], end - start, total)


def _transformer_sp(enc, frames, lengths, slices, axis):
    start, end = slices[axis.index]
    total, sizes = slices[-1][1], [b - a for a, b in slices]
    non_pad, key_pad = _masks(lengths, start, end, total)
    h = enc.layer_norm_input(enc.input_linear(frames).float())
    h = (h + enc.positional_encoding(end - start, start)).to(enc.dtype)
    for layer in enc.layers:
        attn = layer.self_attn
        k, v = attn.project_kv(h, h)
        k, v = (comm.all_gather_varlen(t, sizes, axis) for t in (k, v))
        out = attn._finish(attn._attend(attn._q_heads(h), k, v, key_pad), h)
        out = out * non_pad.to(out.dtype)
        h = layer.pos_ffn(out) * non_pad.to(out.dtype)
    return h


def _conformer_sp(enc: ConformerEncoder, frames, lengths, slices, axis):
    start, end = slices[axis.index]
    total, sizes = slices[-1][1], [b - a for a, b in slices]
    non_pad, key_pad = _masks(lengths, start, end, total)
    h = linear(frames, enc.input_linear, enc.dtype)
    angles = None
    for block in enc.blocks:
        h = h + 0.5 * block.ff1(h)
        q, k, v = block.attn.project(h)
        if angles is None:
            angles = torch.from_numpy(
                rope_angles(total, q.shape[-1])).to(h.device)
        k, v = (comm.all_gather_varlen(t, sizes, axis) for t in (k, v))
        h = h + block.attn.attend(q, k, v, angles[start:end], angles,
                                  key_pad)
        pad = block.conv.dw.pad
        h = h + block.conv(h, non_pad, context=lambda x: neighbour_context(
            x, pad, sizes, axis))
        h = h + 0.5 * block.ff2(h)
        h = h * non_pad.to(h.dtype)
    h = enc.final_norm(h.float())
    return (h * non_pad).to(enc.dtype)


@torch.no_grad()
def encode_sp(model, features: torch.Tensor, lengths: torch.Tensor,
              axis, slices: Optional[Sequence[Tuple[int, int]]] = None
              ) -> torch.Tensor:
    """This rank's time slice [B, T'_r, d_model] of ``model.encode(features,
    lengths)`` (eval mode), the time axis split over ``axis`` (the mesh's
    ``model``): ``features`` [B, T, F] whole in time on every rank of the
    axis, ``lengths`` [B] raw frame counts. ``slices`` defaults to
    ``time_slices`` of the encoder length."""
    check_encoder(model.encoder.encoder_type)
    feat_extractor = model.conv.feat_extractor
    if slices is None:
        slices = time_slices(
            subsampled_length(feat_extractor, features.shape[1]), axis.size)
    start, end = slices[axis.index]
    frames = front_end_sp(model.conv, features, feat_extractor, start, end)
    if isinstance(model.encoder, ConformerEncoder):
        return _conformer_sp(model.encoder, frames, lengths, slices, axis)
    return _transformer_sp(model.encoder, frames, lengths, slices, axis)


@torch.no_grad()
def gather_encoder_output(enc: torch.Tensor,
                          slices: Sequence[Tuple[int, int]], mesh
                          ) -> torch.Tensor:
    """The whole batch's encoder output [B, T', d] from every rank's
    [B / data, T'_r, d] slice, on every rank."""
    enc = comm.all_gather_varlen(enc, [b - a for a, b in slices],
                                 mesh.model)
    return comm.all_gather(enc, mesh.data).flatten(0, 1)


@torch.no_grad()
def greedy_search_sp(model, features: torch.Tensor, lengths: torch.Tensor,
                     vocab, max_steps: int, start_token: int, mesh
                     ) -> Optional[List[str]]:
    """Long-form greedy decode with a sequence-parallel encode, the path
    of ``test_main --mesh-model M``: ``features`` [B, T, F] and ``lengths``
    [B] the whole batch on every rank. Returns the hypotheses on rank 0
    (which decodes the gathered encoder output unsharded) and None on the
    other ranks."""
    from ..decode.greedy import greedy_loop, ids_to_strings

    b = features.shape[0]
    if b % mesh.data.size:
        raise ValueError(f"--mesh-data {mesh.data.size} must divide the "
                         f"test batch ({b})")
    n = b // mesh.data.size
    rows = slice(mesh.data.index * n, (mesh.data.index + 1) * n)
    slices = time_slices(
        subsampled_length(model.conv.feat_extractor, features.shape[1]),
        mesh.model.size)
    enc = encode_sp(model, features[rows], lengths[rows], mesh.model, slices)
    enc = gather_encoder_output(enc, slices, mesh)
    if not mesh.is_root:
        return None
    enc_kvs = model.decoder.precompute_enc_kv(enc)
    ids = greedy_loop(model, enc_kvs, b, features.device, max_steps,
                      start_token)
    return ids_to_strings(ids.cpu(), vocab)
