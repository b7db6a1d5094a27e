"""True-f32 math on the card whatever the global TF32 flags."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_f32():
    """cuDNN (convolutions, recurrences) and cuBLAS matmuls in f32, TF32
    off, for the body; the global flags are restored after. For values that
    enter a comparison (the VGG backward held to the plain version's VJP)
    or a ranking (the LM scores of beam hypotheses)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
