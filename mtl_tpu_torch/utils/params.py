"""Parameter count (port of mtl_tpu/utils/params.py:compute_num_params;
reference utils/functions.py:36-41)."""

from __future__ import annotations

from typing import Tuple

from torch import nn


def compute_num_params(model: nn.Module) -> Tuple[int, int]:
    """(trainable, non-trainable) parameter counts; every parameter of the
    model is trained, so the second is 0, as in the JAX package."""
    return sum(p.numel() for p in model.parameters()), 0
