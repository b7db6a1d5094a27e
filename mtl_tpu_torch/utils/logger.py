"""Logging setup: file + stdout, reference log-file semantics.

Parity: every entry point configures ``logging.basicConfig(filename=
"log/<name>.log", filemode="w+" fresh / "a+" resume)`` and mirrors prints
(e.g. meta_transfer_train.py:129-139). A copy of mtl_tpu/utils/logger.py
for the PyTorch port."""

from __future__ import annotations

import logging
import os


# False in the ranks of a mesh other than rank 0 (parallel/launch.py): a
# spawned rank is a process of its own, so the flag is that process's
_print = True


def setup_logging(name: str, resume: bool = False, log_dir: str = "log"):
    if not _print:
        return logging.getLogger(name)
    os.makedirs(log_dir, exist_ok=True)
    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)
    logging.basicConfig(
        filename=os.path.join(log_dir, f"{name}.log"),
        filemode="a+" if resume else "w+",
        format="%(asctime)s - %(message)s",
        level=logging.INFO,
    )
    return logging.getLogger(name)


def silence() -> None:
    """Makes ``log_print`` print and log nothing in this process (the
    ranks of a mesh other than rank 0)."""
    global _print
    _print = False


def log_print(msg: str) -> None:
    if not _print:
        return
    print(msg, flush=True)
    logging.info(msg)
