"""Convolutional spectrogram subsampler (port of
mtl_tpu/models/subsampler.py; reference models/asr/transformer.py:38-72).

``vgg_cnn``: 2 x [Conv3x3(SAME) -> ReLU -> Conv3x3(SAME) -> ReLU ->
MaxPool2(VALID)] with 64 then 128 channels; time and freq both /4.
``large_cnn``: the same with 32 then 64 channels. Both blocks run as the
fused VGG kernels of ``ops/vgg.py``, through ``vgg_stack``, whose backward
recomputes the plain version (the ``fused_vgg_stack`` custom VJP of the JAX
package). Input [B, T, F] f32; output
[B, T//4, (F//4) * C] in the compute dtype, flattened (f, c) f-major like
the JAX package. With ``plain`` (the ``--second-order`` route, which the
configuration picks, as mtl_tpu/models/transformer.py:172-177 forces the
XLA convs there) the blocks run ``vgg_stack_plain`` instead, the same
function by autograd (f32 cuDNN convolutions on the card, TF32 off), which
can be differentiated twice; the stack's Function cannot
(``ops/vgg.py:_VGGStack``).

``emb_cnn`` (:104-117): Conv 41x11 (freq x time), stride (2, 2), padding
(0, 10) -> BatchNorm -> clip to [0, 20] -> Conv 21x11, stride (2, 1),
VALID -> BatchNorm -> clip, 32 channels. Its convs are XLA convs in the
JAX package and cuDNN convs here. The BatchNorm is flax's ``nn.BatchNorm``
as a function on tensors (``batch_norm``): f32, epsilon 1e-5; in training
mode it normalizes by the batch's mean and biased variance over (batch,
freq, time), padded frames included, and reports the running statistics
that flax's update rule gives (momentum 0.99, the biased variance) to the
caller's ``stats_out`` list instead of writing them into its buffers; in
evaluation mode it normalizes by the buffers ``mean`` and ``var``. The
training steps merge the reported statistics into the buffers
(``train/steps.py``), so no forward mutates them. On a data mesh the
training steps set ``sync_axis`` to the ``data`` axis, and the statistics
are then the global batch's: the shards' sums of x and x^2, summed over the
axis by the autograd-aware all-reduce (a synchronized BatchNorm, what the
JAX package's BatchNorm computes over the global array under SPMD).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vgg import vgg_stack, vgg_stack_plain
from ..parallel import comm
from ..utils.precision import strict_f32

CHANNELS = {"vgg_cnn": (64, 128), "large_cnn": (32, 64)}
# emb_cnn: (kernel (freq, time), stride, padding) of its two convs
EMB_CNN = (((41, 11), (2, 2), (0, 10)), ((21, 11), (2, 1), (0, 0)))
EMB_CHANNELS = 32
BN_MOMENTUM, BN_EPSILON = 0.99, 1e-5


def subsampled_length(feat_extractor: str, length: int) -> int:
    """Time-axis length after the conv front-end (floor semantics of torch
    MaxPool2d / strided conv; mtl_tpu/models/subsampler.py:27): the
    encoder length that bounds the beam's horizon."""
    if feat_extractor in ("vgg_cnn", "large_cnn"):
        return length // 2 // 2
    if feat_extractor == "emb_cnn":
        # W axis: conv1 stride 2 pad 10 k=11; conv2 stride 1 k=11 no pad
        l1 = (length + 20 - 11) // 2 + 1
        return l1 - 11 + 1
    return length


def subsampled_freq(feat_extractor: str, num_freq: int) -> int:
    """Frequency bins after the conv front-end
    (mtl_tpu/models/subsampler.py:39-45)."""
    if feat_extractor in ("vgg_cnn", "large_cnn"):
        return num_freq // 2 // 2
    if feat_extractor == "emb_cnn":
        h = (num_freq - 41) // 2 + 1
        return (h - 21) // 2 + 1
    return num_freq


class ConvParams(nn.Module):
    """One conv's ``kernel`` (flax HWIO [kf, kt, C_in, C], f32; 3 x 3 for
    the VGG blocks, the layout their kernels take) and ``bias``."""

    def __init__(self, in_features: int, features: int,
                 size: Tuple[int, int] = (3, 3)):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))


class BatchNormParams(nn.Module):
    """flax ``BatchNorm``'s ``scale`` and ``bias`` (parameters) and its
    running ``mean`` and ``var`` (buffers, the ``batch_stats``
    collection), f32, flax's initial values."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))


def batch_norm(x: torch.Tensor, bn: BatchNormParams, train: bool,
               stats_out: Optional[list] = None,
               sync_axis=None) -> torch.Tensor:
    """flax ``nn.BatchNorm(use_running_average=not train,
    dtype=float32)`` over channel axis 1 of ``x`` [B, C, H, W]: f32
    statistics over (B, H, W), flax's fast variance E[x^2] - E[x]^2
    floored at 0, over the global batch of the mesh axis ``sync_axis``
    (equal shards) when given. In training mode the new running (mean,
    var) are appended, detached, to ``stats_out`` when it is given."""
    x = x.float()
    if not train:
        mean, var = bn.mean, bn.var
    elif sync_axis is not None and sync_axis.size > 1:
        n = x.numel() // x.shape[1] * sync_axis.size
        sums = comm.all_reduce_grad(
            torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]),
            sync_axis)
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    if train and stats_out is not None:
        with torch.no_grad():
            stats_out.append(
                (BN_MOMENTUM * bn.mean + (1.0 - BN_MOMENTUM) * mean,
                 BN_MOMENTUM * bn.var + (1.0 - BN_MOMENTUM) * var))
    mul = torch.rsqrt(var + BN_EPSILON) * bn.scale
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None])


class FeatureExtractor(nn.Module):
    """Dispatches on feat_extractor name; returns [B, T', D'] frames."""

    def __init__(self, feat_extractor: str = "vgg_cnn",
                 dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        super().__init__()
        self.dtype, self.plain = dtype, plain
        self.feat_extractor = feat_extractor
        self.sync_axis = None  # emb_cnn's BatchNorm: see batch_norm
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        if feat_extractor in CHANNELS:
            c_in = 1
            for ch in CHANNELS[feat_extractor]:
                self.convs.extend([ConvParams(c_in, ch), ConvParams(ch, ch)])
                c_in = ch
        elif feat_extractor == "emb_cnn":
            c_in = 1
            for size, _, _ in EMB_CNN:
                self.convs.append(ConvParams(c_in, EMB_CHANNELS, size))
                self.bns.append(BatchNormParams(EMB_CHANNELS))
                c_in = EMB_CHANNELS
        elif feat_extractor not in ("none", None, ""):
            raise ValueError(f"unknown feat_extractor {feat_extractor!r}")

    def forward(self, features: torch.Tensor, train: bool = False,
                stats_out: Optional[List] = None) -> torch.Tensor:
        """features: [B, T, F] -> [B, T', F' * C]. ``train`` and
        ``stats_out`` reach emb_cnn's BatchNorm (``batch_norm``)."""
        if not len(self.convs):
            return features
        if self.feat_extractor == "emb_cnn":
            return self._emb_cnn(features, train, stats_out)
        weights = [t for conv in self.convs for t in (conv.kernel, conv.bias)]
        if self.plain:
            with strict_f32():
                return vgg_stack_plain(features.float(), weights,
                                       out_dtype=self.dtype)
        return vgg_stack(features.float().contiguous(), weights,
                         out_dtype=self.dtype)

    def _emb_cnn(self, features: torch.Tensor, train: bool,
                 stats_out: Optional[List]) -> torch.Tensor:
        # NCHW with C = 1, H = freq, W = time (flax's NHWC geometry)
        x = features.transpose(1, 2)[:, None].to(self.dtype)
        for conv, bn, (_, stride, padding) in zip(self.convs, self.bns,
                                                  EMB_CNN):
            w = conv.kernel.permute(3, 2, 0, 1).to(self.dtype)
            x = F.conv2d(x, w, conv.bias.to(self.dtype), stride=stride,
                         padding=padding)
            x = batch_norm(x, bn, train, stats_out, self.sync_axis)
            x = torch.clamp(x, 0.0, 20.0).to(self.dtype)
        b, c, f, t = x.shape  # -> [B, T', F' * C], (f, c) f-major
        return x.permute(0, 3, 2, 1).reshape(b, t, f * c)

    def batch_stats(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The running (mean, var) buffers of each BatchNorm, in the order
        ``stats_out`` reports them."""
        return [(bn.mean, bn.var) for bn in self.bns]
