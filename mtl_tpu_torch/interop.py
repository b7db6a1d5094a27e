"""Weights between the JAX package and the port.

``flax_params_to_torch`` maps an mtl_tpu ``ASRTransformer`` param tree
(nested dicts of numpy arrays, with or without the top ``"params"`` key)
onto the port's state_dict; ``torch_to_flax_params`` maps it back. The rules
(modelled on mtl_tpu/parity/torch_ref.py:flax_to_torch_state, without its
conv-flatten permutation: the port flattens (f, c) f-major like the JAX
package):

* ``layers_{i}`` -> ``layers.{i}``; ``conv/conv/Conv_{i}`` -> ``conv.convs.{i}``;
* Dense ``kernel`` [in, out] -> ``weight`` [out, in]; ``bias`` -> ``bias``;
* LayerNorm ``scale`` -> ``weight``;
* ``trg_embedding/embedding`` -> ``trg_embedding.weight`` as is (the PAD
  row is zeroed at lookup, not in the weights);
* conv ``kernel`` keeps the flax HWIO layout [3(f), 3(t), C_in, C_out],
  which the port's VGG kernels take.

The training state moves the same way: optax Adam's ``mu`` and ``nu`` are
trees shaped like the params, so they map by the same rules onto the port's
``AdamState`` (keyed by parameter name), and ``count`` is the step count.
A JAX ``TrainState`` (step, params, ``opt_state[0]`` of ``optax.adam``)
can so continue in the port and back.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .train.optim import AdamState


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path) -> str:
    *mods, leaf = path
    if mods[0] == "conv":  # conv/conv/Conv_{i}/{kernel,bias}
        return f"conv.convs.{mods[2][len('Conv_'):]}.{leaf}"
    mods = [re.sub(r"^layers_(\d+)$", r"layers.\1", m) for m in mods]
    leaf = {"kernel": "weight", "scale": "weight",
            "embedding": "weight"}.get(leaf, leaf)
    return ".".join(mods + [leaf])


def flax_params_to_torch(params) -> Dict[str, torch.Tensor]:
    """Flax ASRTransformer params -> port state_dict (float32 tensors)."""
    tree = params.get("params", params)
    sd = {}
    for path, v in _flatten(tree):
        a = np.asarray(v, np.float32)
        if path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        # a copy: the tree's arrays may be read-only views of device buffers
        sd[_torch_key(path)] = torch.from_numpy(np.array(a, order="C"))
    return sd


def torch_to_flax_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port state_dict -> Flax ``{"params": ...}`` tree of float32 numpy."""
    tree: dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        a = t.detach().float().cpu().numpy()
        if parts[:2] == ["conv", "convs"]:
            path = ["conv", "conv", f"Conv_{parts[2]}"] + parts[3:]
        else:
            path = []
            for p in parts:
                if p.isdigit() and path and path[-1] == "layers":
                    path[-1] = f"layers_{p}"
                else:
                    path.append(p)
            if path[-1] == "weight":
                if a.ndim == 2 and path[-2] != "trg_embedding":
                    path[-1], a = "kernel", a.T
                elif a.ndim == 2:
                    path[-1] = "embedding"
                else:
                    path[-1] = "scale"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": tree}


def adam_state_from_optax(mu, nu, count) -> AdamState:
    """optax ``ScaleByAdamState`` fields (param-shaped ``mu``/``nu`` trees,
    ``count``) -> the port's ``AdamState``."""
    return AdamState(int(np.asarray(count)), flax_params_to_torch(mu),
                     flax_params_to_torch(nu))


def adam_state_to_optax(state: AdamState):
    """The port's ``AdamState`` -> (mu tree, nu tree, count as int32), the
    fields of optax's ``ScaleByAdamState`` in the Flax param layout."""
    return (torch_to_flax_params(state.mu), torch_to_flax_params(state.nu),
            np.asarray(state.count, np.int32))
