"""Parameter count (port of mtl_tpu/utils/params.py:compute_num_params;
reference utils/functions.py:36-41)."""

from __future__ import annotations

from typing import Tuple

from torch import nn


def compute_num_params(model: nn.Module) -> Tuple[int, int]:
    """(trainable, non-trainable) counts as the JAX package prints them:
    every leaf of its variables, emb_cnn's BatchNorm statistics included
    (the state_dict's entries here), in the first; the second is 0."""
    return sum(t.numel() for t in model.state_dict().values()), 0
