"""The port's training entry point against the JAX package's, end to end.

One synthetic 3-task corpus (the last task the code-switched query and
valid set). One JAX ``TrainState`` at step 0 (params + optax Adam state)
is saved with ``mtl_tpu.utils.checkpoint.save_checkpoint`` and copied into
a port checkpoint through ``mtl_tpu_torch.interop``; both
``meta_transfer_train_main``s continue from their copy for 4 iterations on
the CPU at tiny width, f32, dropout 0 (JAX: XLA STFT and convs; port: the
plain versions of its kernels). Both draw the same meta batches from one
seed, so their ``TRAIN LOSS`` / ``VALID`` lines must agree to the printed
digits (the wall-clock ``TOTAL TIME`` field is not compared). The port's
checkpoints then serve through the port's ``test_main`` and resume its
trainer at the right iteration.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.cli.asr import meta_transfer_train_main as jax_train_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.train.steps import init_train_state
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import meta_transfer_train_main
from mtl_tpu_torch.cli.asr import test_main as port_test_main
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import adam_state_from_optax, flax_params_to_torch
from mtl_tpu_torch.utils.checkpoint import (load_checkpoint, load_train_state,
                                            save_checkpoint)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _lines(out):
    keep = [ln for ln in out.splitlines()
            if ln.startswith(("(Iteration", "count_stop", "EARLY STOP"))]
    return [re.sub(r" TOTAL TIME:.*$", "", ln) for ln in keep]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both CLIs on one corpus from one step-0 state; returns (JAX output,
    port output, corpus manifests, labels path, models folder)."""
    tmp = tmp_path_factory.mktemp("train_cli")
    old = os.getcwd()
    os.chdir(tmp)  # both CLIs write log/<name>.log
    try:
        manifests, labels = make_synthetic_corpus(
            str(tmp / "corpus"), num_tasks=3, utts_per_task=6, max_sec=0.5,
            max_chars=6, seed=7)
        cfg = JaxConfig()
        m = cfg.model
        m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
        m.dim_model = m.dim_emb = m.dim_inner = 16
        m.dim_key = m.dim_value = 8
        m.r, m.dtype, m.dropout = 4, "float32", 0.0
        m.src_max_len, m.tgt_max_len = 64, 32
        t = cfg.train
        t.k_train = t.k_valid = 2
        t.lr, t.meta_lr = 1e-2, 1e-3
        t.evaluate_every = t.save_every = 2
        t.early_stop = "loss,5"
        cfg.data.train_manifest_list, cfg.data.labels_path = manifests, labels
        cfg.data.src_bucket_frames, cfg.data.tgt_bucket_len = (64,), (16,)
        cfg.name, cfg.save_folder = "init", str(tmp / "models")
        cfg.finalize()
        vocab = JaxVocab.from_json(labels)
        example, _ = JaxDataset(vocab, cfg, manifests, is_train=True,
                                seed=0).sample_meta_batch(2, 2)
        tx = optax.adam(t.meta_lr)
        state = init_train_state(
            jax_build_model(cfg, len(vocab)), cfg, tx, jax.random.PRNGKey(3),
            jax.tree.map(lambda x: jnp.asarray(x[0]), example))
        jax_path = jax_save_checkpoint(cfg, vocab, state, 0)

        port_cfg = Config.from_dict(json.loads(cfg.to_json()))
        port_cfg.name = "init_port"
        adam = jax.tree.map(np.asarray, state.opt_state[0])
        port_path = save_checkpoint(
            port_cfg, Vocab.from_dict(vocab.to_dict()),
            flax_params_to_torch(jax.tree.map(np.asarray, state.params)), 0,
            opt_state=adam_state_from_optax(adam.mu, adam.nu, adam.count))

        common = ["--train-manifest-list", *manifests,
                  "--valid-manifest-list", manifests[-1],
                  "--labels-path", labels, "--src-buckets", "64",
                  "--tgt-buckets", "16", "--epochs", "4"]
        from contextlib import redirect_stdout
        from io import StringIO

        outs = []
        for main, extra in (
                (jax_train_main, ["--name", "jax_run", "--continue-from",
                                  jax_path]),
                (meta_transfer_train_main, ["--name", "port_run",
                                            "--continue-from", port_path,
                                            "--device", "cpu"])):
            buf = StringIO()
            with redirect_stdout(buf):
                main(common + extra)
            outs.append(buf.getvalue())
        yield outs[0], outs[1], manifests, labels, str(tmp / "models")
    finally:
        os.chdir(old)


def test_train_lines_match_jax(run):
    want, got = _lines(run[0]), _lines(run[1])
    assert sum(ln.count("TRAIN LOSS") for ln in want) == 4
    assert sum("AVG VALID" in ln for ln in want) == 2
    assert got == want
    assert "RESTORED STATE" in run[1]


def test_port_checkpoints_hold_the_train_state(run):
    models = run[4]
    for tag in ("step_2", "step_4", "best_model"):
        path = os.path.join(models, "port_run", tag)
        cfg, _, sd, step, metrics = load_checkpoint(path)
        assert step in (2, 4) and "avg_valid_loss" in metrics
        assert all(v.dtype == torch.float32 for v in sd.values())
        saved = load_train_state(path)
        assert saved["step"] == step and saved["count"] == step
        assert set(saved["mu"]) == set(sd) == set(saved["nu"])


def test_port_checkpoint_serves_in_test_main(run, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    _, _, manifests, labels, models = run
    result = port_test_main([
        "--test-manifest-list", manifests[-1], "--labels-path", labels,
        "--continue-from", os.path.join(models, "port_run", "best_model"),
        "--k-test", "2", "--src-buckets", "64", "--tgt-buckets", "16",
        "--device", "cpu", "--name", "serve_trained"])
    assert result["utterances"] == 6
    assert "TOTAL CER" in capsys.readouterr().out


def test_port_resume_continues_at_the_saved_iteration(run, tmp_path,
                                                      monkeypatch, capsys):
    """--continue-from step_4 with --epochs 6 runs iterations 5 and 6 from
    the saved weights and Adam state (count 4 -> 6)."""
    monkeypatch.chdir(tmp_path)
    _, _, manifests, labels, models = run
    state = meta_transfer_train_main([
        "--train-manifest-list", *manifests, "--valid-manifest-list",
        manifests[-1], "--labels-path", labels, "--src-buckets", "64",
        "--tgt-buckets", "16", "--epochs", "6", "--device", "cpu",
        "--name", "port_resume", "--continue-from",
        os.path.join(models, "port_run", "step_4")])
    out = capsys.readouterr().out
    its = [int(x) for x in re.findall(r"\(Iteration (\d+)\) TRAIN LOSS", out)]
    assert its == [5, 6]
    assert state.step == 6 and state.opt_state.count == 6
    assert os.path.isdir(os.path.join(models, "port_resume", "step_6"))
