"""Checkpoint save / load for the port: ``torch.save`` of the f32
state_dict plus the ``meta.json`` sidecar of mtl_tpu/utils/checkpoint.py
(config, vocab, step, metrics), so the model is rebuilt from the stored
config (reference load_meta_model, utils/functions.py:158-188). A training
checkpoint also holds what a resume needs beside the weights, as the JAX
package's ``TrainState`` does (mtl_tpu/utils/checkpoint.py:47-74): the step
and the outer Adam state.

Layout: ``<save_folder>/<name>/{step_N,best_model}/`` holding
``model.pt`` (the state_dict, which ``test_main`` loads), ``meta.json`` and,
from training, ``train_state.pt``: the step and the optimizer's fields
(Adam: count, mu, nu; Noam Adam: those and schedule_count; SGD with
momentum: trace; SGD without: none) and, from a run with a discriminator
head, ``disc``: its parameters (``params``, by name) and its optimizer's
fields. The discriminator stays out of ``model.pt``. Every tensor is
whole: a tensor-parallel run (``parallel/tp.py``) gathers its slices
before it saves and cuts them again after it loads.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..config import Config
from ..data.vocab import Vocab

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _fields(opt_state) -> dict:
    return {k: _cpu(v) if isinstance(v, dict) else int(v)
            for k, v in opt_state.tensors().items()}


def save_checkpoint(cfg: Config, vocab: Vocab,
                    state_dict: Dict[str, torch.Tensor], step: int,
                    metrics: Optional[dict] = None,
                    best_model: bool = False, opt_state=None,
                    disc=None, train_step: Optional[int] = None) -> str:
    """Writes the step directory (or ``best_model``); ``opt_state`` (an
    ``AdamState``, ``NoamState`` or ``SGDState``) makes it a training
    checkpoint that a resume continues from, at the trainer's step count
    ``train_step`` (default ``step``; the epoch trainer's differ); ``disc``
    (the discriminator's params by name, its optimizer state) goes beside
    it."""
    tag = "best_model" if best_model else f"step_{step}"
    path = os.path.abspath(os.path.join(cfg.save_folder, cfg.name, tag))
    os.makedirs(path, exist_ok=True)
    torch.save(_cpu(state_dict), os.path.join(path, MODEL_FILE))
    if opt_state is not None:
        train_state = {"step": int(step if train_step is None
                                   else train_step), **_fields(opt_state)}
        if disc is not None:
            train_state["disc"] = {"params": _cpu(disc[0]),
                                   **_fields(disc[1])}
        torch.save(train_state, os.path.join(path, TRAIN_STATE_FILE))
    meta = {
        "config": json.loads(cfg.to_json()),
        "vocab": vocab.to_dict(),
        "step": int(step),
        "metrics": metrics or {},
    }
    with open(os.path.join(path, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    return path


def load_checkpoint_meta(path: str) -> Tuple[Config, Vocab, int, dict]:
    """(config, vocab, step, metrics) from the JSON sidecar only."""
    with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    return (Config.from_dict(meta["config"]), Vocab.from_dict(meta["vocab"]),
            meta["step"], meta.get("metrics", {}))


def load_checkpoint(path: str) -> Tuple[Config, Vocab, dict, int, dict]:
    """Returns (config, vocab, state_dict on the CPU, step, metrics)."""
    cfg, vocab, step, metrics = load_checkpoint_meta(path)
    state_dict = torch.load(os.path.join(path, MODEL_FILE),
                            map_location="cpu", weights_only=True)
    return cfg, vocab, state_dict, step, metrics


def load_train_state(path: str) -> Optional[dict]:
    """{step, and the optimizer's fields} of a training checkpoint, on the
    CPU; None for a weights-only checkpoint."""
    file = os.path.join(path, TRAIN_STATE_FILE)
    if not os.path.exists(file):
        return None
    return torch.load(file, map_location="cpu", weights_only=True)
