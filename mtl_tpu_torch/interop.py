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

The word-level LM (mtl_tpu/lm/model.py ``RNNLM``) maps by its own rules
(``lm_params_to_torch`` / ``torch_to_flax_lm_params``): the flax cells keep
one Dense per gate, kernels [in, out]; the port stacks them in torch's gate
order into ``rnns.{i}.weight_ih`` [G*H, in] / ``weight_hh`` [G*H, H] and
keeps the cells' single bias per gate in ``rnns.{i}.bias``:

* LSTM (``OptimizedLSTMCell``): gates i, f, g, o from ``i*`` (input side,
  no bias) and ``h*`` (hidden side, biased); ``bias`` = the ``h*`` biases;
* GRU (``GRUCell``): gates r, z, n from ``ir``/``iz``/``in`` (biased) and
  ``hr``/``hz``/``hn`` (only ``hn`` biased); ``bias`` = [ir, iz, in, hn];
* RNN_TANH / RNN_RELU (``SimpleCell``): ``i`` (biased) and ``h``;
  ``bias`` = the ``i`` bias;
* ``embed/embedding`` -> ``embed.weight``; ``decoder`` Dense ->
  ``decoder.weight`` [V, H] / ``decoder.bias``, or ``decoder_bias`` when
  tied.
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


# flax cell -> (input-side Dense names, hidden-side Dense names, the Dense
# names whose biases make the port's ``bias``, in order)
_LM_CELLS = {
    "LSTM": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"),
             ("hi", "hf", "hg", "ho")),
    "GRU": (("ir", "iz", "in"), ("hr", "hz", "hn"), ("ir", "iz", "in", "hn")),
    "RNN_TANH": (("i",), ("h",), ("i",)),
    "RNN_RELU": (("i",), ("h",), ("i",)),
}


def lm_params_to_torch(params, arch: dict) -> Dict[str, torch.Tensor]:
    """Flax ``RNNLM`` params (``arch`` as in the LM checkpoints: rnn_type,
    nlayers, tie_weights) -> the port's ``RNNLM`` state_dict (f32)."""
    tree = params.get("params", params)
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32, order="C"))
    ins, hids, biased = _LM_CELLS[arch["rnn_type"]]
    sd = {"embed.weight": f32(tree["embed"]["embedding"])}
    for i in range(arch["nlayers"]):
        cell = tree[f"rnn_l{i}"]
        sd[f"rnns.{i}.weight_ih"] = f32(np.concatenate(
            [np.asarray(cell[g]["kernel"]).T for g in ins]))
        sd[f"rnns.{i}.weight_hh"] = f32(np.concatenate(
            [np.asarray(cell[g]["kernel"]).T for g in hids]))
        sd[f"rnns.{i}.bias"] = f32(np.concatenate(
            [np.asarray(cell[g]["bias"]) for g in biased]))
    if arch["tie_weights"]:
        sd["decoder_bias"] = f32(tree["decoder_bias"])
    else:
        sd["decoder.weight"] = f32(np.asarray(tree["decoder"]["kernel"]).T)
        sd["decoder.bias"] = f32(tree["decoder"]["bias"])
    return sd


def torch_to_flax_lm_params(state_dict: Dict[str, torch.Tensor],
                            arch: dict) -> dict:
    """The port's ``RNNLM`` state_dict -> Flax ``{"params": ...}`` tree of
    float32 numpy (the inverse of ``lm_params_to_torch``)."""
    a = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    ins, hids, biased = _LM_CELLS[arch["rnn_type"]]
    tree = {"embed": {"embedding": a["embed.weight"]}}
    for i in range(arch["nlayers"]):
        cell = {}
        for names, w in ((ins, a[f"rnns.{i}.weight_ih"]),
                         (hids, a[f"rnns.{i}.weight_hh"])):
            for g, rows in zip(names, np.split(w, len(names))):
                cell[g] = {"kernel": np.ascontiguousarray(rows.T)}
        for g, b in zip(biased, np.split(a[f"rnns.{i}.bias"], len(biased))):
            cell[g]["bias"] = np.ascontiguousarray(b)
        tree[f"rnn_l{i}"] = cell
    if arch["tie_weights"]:
        tree["decoder_bias"] = a["decoder_bias"]
    else:
        tree["decoder"] = {"kernel": np.ascontiguousarray(
            a["decoder.weight"].T), "bias": a["decoder.bias"]}
    return {"params": tree}
