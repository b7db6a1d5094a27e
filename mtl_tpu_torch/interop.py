"""Weights between the JAX package and the port.

``flax_params_to_torch`` maps an mtl_tpu ``ASRTransformer`` param tree
(nested dicts of numpy arrays, with or without the top ``"params"`` key)
onto the port's state_dict; ``torch_to_flax_params`` maps it back. The rules
(modelled on mtl_tpu/parity/torch_ref.py:flax_to_torch_state, without its
conv-flatten permutation: the port flattens (f, c) f-major like the JAX
package):

* ``layers_{i}`` -> ``layers.{i}``; the Conformer's ``block_{i}`` ->
  ``blocks.{i}``; ``conv/conv/Conv_{i}`` -> ``conv.convs.{i}``;
* emb_cnn's ``conv/conv/BatchNorm_{i}``: ``scale`` and ``bias`` (params)
  and ``mean`` and ``var`` (the ``batch_stats`` collection) ->
  ``conv.bns.{i}.{scale,bias,mean,var}`` (the last two buffers);
* Dense ``kernel`` [in, out] -> ``weight`` [out, in]; ``bias`` -> ``bias``;
* LayerNorm ``scale`` -> ``weight``;
* ``trg_embedding/embedding`` -> ``trg_embedding.weight`` as is (the PAD
  row is zeroed at lookup, not in the weights);
* conv ``kernel`` keeps the flax HWIO layout [kf, kt, C_in, C_out], which
  the port's VGG kernels take;
* the Conformer's depthwise conv ``dw``: flax's 1-D kernel [k, 1, C] ->
  ``weight`` [C, 1, k], torch's conv1d layout. The rest of the Conformer
  (``encoder/input_linear``, ``final_norm``, each block's ``ff1``/``ff2``
  ``LayerNorm_0``/``Dense_0``/``Dense_1``, ``attn`` ``LayerNorm_0``/``q``/
  ``k``/``v``/``out``, ``conv`` ``LayerNorm_0``/``pw1``/``norm``/``pw2``)
  keeps flax's names and maps by the Dense and LayerNorm rules.

The training state moves the same way: optax Adam's ``mu`` and ``nu`` are
trees shaped like the params, so they map by the same rules onto the port's
``AdamState`` (keyed by parameter name), and ``count`` is the step count.
A JAX ``TrainState`` (step, params, ``opt_state[0]`` of ``optax.adam``)
can so continue in the port and back. The ``trace`` of optax's
``TraceState`` (``optax.sgd`` with momentum) maps the same way onto the
port's ``SGDState``.

The epoch trainer's Noam Adam is optax's chain (``ScaleByAdamState``,
``ScaleByScheduleState``, ``EmptyState``): its ``mu``/``nu`` map as Adam's,
the Adam count and the schedule's count onto ``NoamState.count`` and
``schedule_count`` (``noam_state_from_optax`` / ``noam_state_to_optax``).

The discriminator (mtl_tpu/models/discriminator.py, one ``Dense_0``) maps
its kernel [d_model, C] transposed onto ``linear.weight`` [C, d_model]
and its bias onto ``linear.bias`` (``disc_params_to_torch`` /
``torch_to_flax_disc_params``); its optimizer state maps the same way.

Under tensor parallel (``parallel/tp.py``) a rank holds slices of the
split leaves: ``flax_params_to_torch_shard`` cuts a Flax tree to one
rank's state_dict and ``torch_shards_to_flax_params`` joins every rank's
back (``flax_path`` names a port key's flax path, which the rule table
matches).

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
from typing import Dict, List

import numpy as np
import torch

from .train.optim import AdamState, NoamState, SGDState


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path) -> str:
    *mods, leaf = path
    if mods[0] == "conv":  # conv/conv/{Conv,BatchNorm}_{i}/{leaf}
        kind, i = mods[2].rsplit("_", 1)
        return f"conv.{'convs' if kind == 'Conv' else 'bns'}.{i}.{leaf}"
    mods = [re.sub(r"^layers_(\d+)$", r"layers.\1",
                   re.sub(r"^block_(\d+)$", r"blocks.\1", m)) for m in mods]
    leaf = {"kernel": "weight", "scale": "weight",
            "embedding": "weight"}.get(leaf, leaf)
    return ".".join(mods + [leaf])


def _tree_to_torch(tree) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, v in _flatten(tree):
        a = np.asarray(v, np.float32)
        if path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        elif path[-1] == "kernel" and a.ndim == 3:  # [k, 1, C] -> [C, 1, k]
            a = a.transpose(2, 1, 0)
        # a copy: the tree's arrays may be read-only views of device buffers
        sd[_torch_key(path)] = torch.from_numpy(np.array(a, order="C"))
    return sd


def flax_params_to_torch(params) -> Dict[str, torch.Tensor]:
    """Flax ASRTransformer variables (``params`` and, for emb_cnn,
    ``batch_stats``; or a bare params tree) -> port state_dict (float32
    tensors)."""
    sd = _tree_to_torch(params.get("params", params))
    sd.update(_tree_to_torch(params.get("batch_stats", {})))
    return sd


def flax_path(key: str, ndim: int) -> List[str]:
    """The flax path (below the collection) of the port's state_dict entry
    ``key``, a tensor of ``ndim`` dims."""
    parts = key.split(".")
    if parts[:2] == ["conv", "convs"]:
        return ["conv", "conv", f"Conv_{parts[2]}"] + parts[3:]
    if parts[:2] == ["conv", "bns"]:
        return ["conv", "conv", f"BatchNorm_{parts[2]}"] + parts[3:]
    path: List[str] = []
    for p in parts:
        if p.isdigit() and path and path[-1] in ("layers", "blocks"):
            kind = "block" if path[-1] == "blocks" else "layers"
            path[-1] = f"{kind}_{p}"
        else:
            path.append(p)
    if path[-1] == "weight":
        if ndim in (2, 3) and path[-2] != "trg_embedding":
            path[-1] = "kernel"
        elif ndim == 2:
            path[-1] = "embedding"
        else:
            path[-1] = "scale"
    return path


def torch_to_flax_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Port state_dict -> Flax ``{"params": ...}`` tree of float32 numpy,
    with a ``batch_stats`` collection when the state_dict holds emb_cnn's
    running statistics."""
    tree: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        a = t.detach().float().cpu().numpy()
        path = flax_path(key, a.ndim)
        node = stats if (path[:2] == ["conv", "conv"]
                         and path[-1] in ("mean", "var")) else tree
        if path[-1] == "kernel" and a.ndim == 3:  # the depthwise conv
            a = a.transpose(2, 1, 0)  # [C, 1, k] -> [k, 1, C]
        elif path[-1] == "kernel" and a.ndim == 2 and path[0] != "conv":
            a = a.T
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": tree, **({"batch_stats": stats} if stats else {})}


def flax_params_to_torch_shard(params, layout, size: int, index: int
                               ) -> Dict[str, torch.Tensor]:
    """Flax variables -> the port's state_dict as rank ``index`` of a
    ``model`` axis of ``size`` holds it under tensor parallel: each leaf of
    ``layout`` (``parallel/tp.py:param_layout``) cut to the rank's
    slice."""
    from .parallel import tp

    return {k: tp.part(v, layout[k], size, index) if k in layout else v
            for k, v in flax_params_to_torch(params).items()}


def torch_shards_to_flax_params(shards, layout) -> dict:
    """The inverse: every rank's state_dict, in rank order -> Flax
    ``{"params": ...}`` (and ``batch_stats``) of the full tensors."""
    from .parallel import tp

    full = {k: tp.whole([sd[k] for sd in shards], layout[k])
            if k in layout else v for k, v in shards[0].items()}
    return torch_to_flax_params(full)


def _opt_tree_to_torch(tree) -> Dict[str, torch.Tensor]:
    """A param-shaped optimizer tree -> by parameter name. Over emb_cnn's
    variables optax also keeps (zero) moments of the ``batch_stats``; the
    port's optimizers hold parameters only, so those are left out."""
    return _tree_to_torch(tree.get("params", tree))


def adam_state_from_optax(mu, nu, count) -> AdamState:
    """optax ``ScaleByAdamState`` fields (param-shaped ``mu``/``nu`` trees,
    ``count``) -> the port's ``AdamState``."""
    return AdamState(int(np.asarray(count)), _opt_tree_to_torch(mu),
                     _opt_tree_to_torch(nu))


def adam_state_to_optax(state: AdamState):
    """The port's ``AdamState`` -> (mu tree, nu tree, count as int32), the
    fields of optax's ``ScaleByAdamState`` in the Flax param layout."""
    return (torch_to_flax_params(state.mu), torch_to_flax_params(state.nu),
            np.asarray(state.count, np.int32))


def sgd_state_from_optax(trace) -> SGDState:
    """optax ``TraceState.trace`` (a param-shaped tree) -> the port's
    ``SGDState``."""
    return SGDState(_opt_tree_to_torch(trace))


def sgd_state_to_optax(state: SGDState):
    """The port's ``SGDState`` -> the ``trace`` tree of optax's
    ``TraceState`` in the Flax param layout."""
    return torch_to_flax_params(state.trace)


def noam_state_from_optax(opt_state) -> NoamState:
    """optax ``noam_adam``'s state (``ScaleByAdamState``,
    ``ScaleByScheduleState``, ``EmptyState``) -> the port's
    ``NoamState``."""
    adam, schedule = opt_state[0], opt_state[1]
    return NoamState(int(np.asarray(adam.count)),
                     _opt_tree_to_torch(adam.mu),
                     _opt_tree_to_torch(adam.nu),
                     int(np.asarray(schedule.count)))


def noam_state_to_optax(state: NoamState):
    """The port's ``NoamState`` -> (mu tree, nu tree, Adam count, schedule
    count), the fields of optax's ``noam_adam`` state in the Flax param
    layout, counts as int32."""
    return (*adam_state_to_optax(state),
            np.asarray(state.schedule_count, np.int32))


def disc_params_to_torch(params) -> Dict[str, torch.Tensor]:
    """Flax ``Discriminator`` params (or a param-shaped optimizer tree) ->
    the port's ``Discriminator`` state_dict (f32)."""
    dense = params.get("params", params)["Dense_0"]
    return {"linear.weight": torch.from_numpy(np.array(
                np.asarray(dense["kernel"], np.float32).T, order="C")),
            "linear.bias": torch.from_numpy(np.array(
                np.asarray(dense["bias"], np.float32)))}


def torch_to_flax_disc_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's ``Discriminator`` state_dict -> Flax ``{"params": ...}``
    tree of float32 numpy."""
    a = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    return {"params": {"Dense_0": {
        "kernel": np.ascontiguousarray(a["linear.weight"].T),
        "bias": a["linear.bias"]}}}


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
