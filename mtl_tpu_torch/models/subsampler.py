"""Convolutional spectrogram subsampler (port of the vgg_cnn / large_cnn
paths of mtl_tpu/models/subsampler.py; reference models/asr/transformer.py:
38-72).

``vgg_cnn``: 2 x [Conv3x3(SAME) -> ReLU -> Conv3x3(SAME) -> ReLU ->
MaxPool2(VALID)] with 64 then 128 channels; time and freq both /4.
``large_cnn``: the same with 32 then 64 channels. Both blocks run as the
fused VGG kernels of ``ops/vgg.py``, through ``vgg_stack``, whose backward
recomputes the plain version (the ``fused_vgg_stack`` custom VJP of the JAX
package). Input [B, T, F] f32; output
[B, T//4, (F//4) * C] in the compute dtype, flattened (f, c) f-major like
the JAX package. ``emb_cnn`` is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.vgg import vgg_stack

CHANNELS = {"vgg_cnn": (64, 128), "large_cnn": (32, 64)}


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


class ConvParams(nn.Module):
    """One conv's ``kernel`` (flax HWIO [3(f), 3(t), C_in, C], f32) and
    ``bias`` — the layout the VGG kernels take."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))


class FeatureExtractor(nn.Module):
    """Dispatches on feat_extractor name; returns [B, T', D'] frames."""

    def __init__(self, feat_extractor: str = "vgg_cnn",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList()
        if feat_extractor in CHANNELS:
            c_in = 1
            for ch in CHANNELS[feat_extractor]:
                self.convs.extend([ConvParams(c_in, ch), ConvParams(ch, ch)])
                c_in = ch
        elif feat_extractor not in ("none", None, ""):
            raise ValueError(
                f"feat_extractor {feat_extractor!r} is not ported yet")

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """features: [B, T, F] -> [B, T', F' * C]."""
        if not len(self.convs):
            return features
        weights = [t for conv in self.convs for t in (conv.kernel, conv.bias)]
        return vgg_stack(features.float().contiguous(), weights,
                         out_dtype=self.dtype)
