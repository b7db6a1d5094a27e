"""Structural rules of the PyTorch port.

* ``mtl_tpu_torch/`` and ``chip_smoke.py`` import none of jax, flax, optax,
  orbax or the JAX package (only the tests import both), and nothing imports
  ``triton`` at module scope.
* Entry points run on ``cuda`` unless asked for the CPU, and raise rather
  than fall back when there is no card.
* A kernel wrapper takes its plain version only for a tensor on the CPU; a
  tensor on any other device is launched on or refused, never computed by
  the plain version.
"""

import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mtl_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "mtl_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree):
    """(module name, at module scope) for every import in ``tree``."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for name, top in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
        assert not (root == "triton" and top), f"{path}: triton at top level"


def test_test_main_raises_without_cuda(monkeypatch):
    """No --device: the entry point asks for cuda and, finding none,
    raises instead of running on the CPU."""
    from mtl_tpu_torch.cli import asr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asr.test_main(["--continue-from", "unused"])


def test_meta_transfer_train_main_raises_without_cuda(monkeypatch):
    """The training entry point asks for cuda too, and raises without it."""
    from mtl_tpu_torch.cli import asr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asr.meta_transfer_train_main(["--train-manifest-list", "unused"])


@pytest.mark.parametrize("entry,argv", [
    ("asr.test_main", ["--continue-from", "unused", "--beam-search",
                       "--lm-rescoring", "--lm-path", "unused"]),
    ("lm.test_main", ["--load", "unused"]),
    ("lm.convert_main", ["--load", "unused", "--save", "unused"]),
], ids=["beam_test_main", "lm_test_main", "lm_convert_main"])
def test_beam_and_lm_entry_points_raise_without_cuda(monkeypatch, entry,
                                                     argv):
    """The beam decode (with LM fusion) and the LM's test and convert
    entry points ask for cuda too, and raise without it."""
    import importlib

    module, fn = entry.split(".")
    cli = importlib.import_module(f"mtl_tpu_torch.cli.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(cli, fn)(argv)


@pytest.mark.parametrize("entry,argv", [
    ("asr.joint_train_main", []),
    ("asr.finetune_main", ["--continue-from", "unused"]),
    ("lm.main_main", []),
    ("lm.main_joint_main", []),
    ("lm.main_meta_transfer_main", ["--second-order"]),
    ("lm.finetune_main", ["--load", "unused"]),
    ("asr.train_main", []),
    ("asr.meta_train_main", ["--adversarial", "--num-meta-test", "1"]),
])
def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path,
                                                  entry, argv):
    """The joint/finetune, epoch and MAML trainers and the LM's training
    mains ask for cuda too, and raise without it before they touch a
    file."""
    import importlib

    monkeypatch.chdir(tmp_path)
    module, fn = entry.split(".")
    cli = importlib.import_module(f"mtl_tpu_torch.cli.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(cli, fn)(argv)
    assert os.listdir(tmp_path) == []


def test_vgg_stack_refuses_other_devices():
    """The stack's autograd Function launches or refuses like the blocks;
    it never runs the plain version on a non-CPU tensor."""
    from mtl_tpu_torch.ops.vgg import vgg_stack

    meta = torch.device("meta")
    w = [torch.empty(s, device=meta) for s in (
        (3, 3, 1, 64), (64,), (3, 3, 64, 64), (64,), (3, 3, 64, 128), (128,),
        (3, 3, 128, 128), (128,))]
    with pytest.raises(ValueError):
        vgg_stack(torch.empty(1, 16, 9, device=meta), w)


def test_wrappers_refuse_other_devices():
    from mtl_tpu_torch.ops.stft import stft_logmag
    from mtl_tpu_torch.ops.vgg import vgg_block1, vgg_block2

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        stft_logmag(torch.empty(2, 800, device=meta), 320, 160, 4)
    with pytest.raises(ValueError):
        stft_logmag(torch.empty(2, 800, device=meta), 448, 160, 4)
    w = [torch.empty(s, device=meta) for s in ((3, 3, 1, 8), (8,),
                                               (3, 3, 8, 8), (8,))]
    with pytest.raises(ValueError):
        vgg_block1(torch.empty(1, 8, 9, device=meta), *w)
    w2 = [torch.empty(s, device=meta) for s in ((3, 3, 8, 16), (16,),
                                                (3, 3, 16, 16), (16,))]
    with pytest.raises(ValueError):
        vgg_block2(torch.empty(1, 8, 9, 8, device=meta), *w2)
