"""Shared CLI assembly for the port: logging banner, device, vocab,
datasets, resume, model (mtl_tpu/cli/common.py)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..config import Config
from ..data.dataset import SpectrogramDataset
from ..data.vocab import Vocab
from ..models.transformer import ASRTransformer, build_model, serving_copy
from ..utils.logger import log_print, setup_logging


def setup(cfg: Config):
    """Logging + banner (meta_transfer_train.py:120-139 parity)."""
    setup_logging(cfg.name, resume=bool(cfg.continue_from))
    log_print("=" * 50)
    log_print("THE EXPERIMENT LOG IS SAVED IN: log/" + cfg.name)
    log_print(f"TRAINING MANIFEST: {cfg.data.train_manifest_list}")
    log_print(f"VALID MANIFEST: {cfg.data.valid_manifest_list}")
    log_print(f"TEST MANIFEST: {cfg.data.test_manifest_list}")
    log_print("=" * 50)
    if cfg.continue_from:
        log_print("RESUME TRAINING")
    else:
        log_print("TRAINING FROM SCRATCH")


def build_vocab(cfg: Config) -> Vocab:
    return Vocab.from_json(cfg.data.labels_path)


def build_datasets(cfg: Config, vocab: Vocab
                   ) -> Tuple[SpectrogramDataset, List[SpectrogramDataset]]:
    """The train dataset sees ALL train manifests (the task is chosen at
    sample time, meta_transfer_train.py:159-165); one eval dataset per
    valid manifest (mtl_tpu/cli/common.py:34-50)."""
    train_ds = SpectrogramDataset(
        vocab, cfg, cfg.data.train_manifest_list, normalize=True,
        augment=cfg.audio.augment, is_train=True,
        partitions=cfg.data.train_partition_list, seed=cfg.train.seed,
    )
    valid_sets = [
        SpectrogramDataset(vocab, cfg, [m], normalize=True, augment=False,
                           seed=cfg.train.seed + 1 + i)
        for i, m in enumerate(cfg.data.valid_manifest_list)
    ]
    return train_ds, valid_sets


def maybe_resume(cfg: Config
                 ) -> Tuple[Config, Optional[Vocab], int, Optional[dict]]:
    """(cfg, vocab, start_it, metrics): with ``--continue-from`` the config
    and vocab stored in the checkpoint, with this invocation's manifests,
    iteration count, checkpoint path, name and device
    (mtl_tpu/cli/common.py:58-74, load_meta_model parity). Only the JSON
    sidecar is read here; the trainer restores the tensors."""
    if not cfg.continue_from:
        return cfg, None, 0, None
    from ..utils.checkpoint import load_checkpoint_meta

    saved_cfg, vocab, step, metrics = load_checkpoint_meta(cfg.continue_from)
    saved_cfg.data = cfg.data
    saved_cfg.train.epochs = cfg.train.epochs
    saved_cfg.continue_from = cfg.continue_from
    saved_cfg.name = cfg.name
    saved_cfg.device = cfg.device
    return saved_cfg, vocab, step, metrics


def resolve_device(name: str) -> torch.device:
    """The torch device an entry point runs on; ``cuda`` without a card
    raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch finds no CUDA "
                           "device (pass --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported --device {name!r} (cuda | cpu)")
    return device


def load_asr_model(cfg: Config, vocab: Vocab, state_dict,
                   device: torch.device) -> ASRTransformer:
    """Rebuild the model from ``cfg`` and load the f32 ``state_dict`` for
    decoding, with the linear weights cast once to the compute dtype."""
    model = build_model(cfg, len(vocab))
    model.load_state_dict(state_dict)
    return serving_copy(model.to(device).eval())
