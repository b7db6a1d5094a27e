"""The port's serving entry point against the JAX package's, end to end.

One synthetic corpus; one Flax param tree saved as a JAX checkpoint with
``mtl_tpu.utils.checkpoint.save_checkpoint`` and converted to a port
checkpoint through ``mtl_tpu_torch.interop``; then both ``test_main``s run
on the CPU at tiny dims and f32 (JAX: XLA STFT and conv path; port: the
plain versions of its kernels). The ragged final batch is padded with
duplicates and only its real rows are scored. Their ``PRED:``/``GOLD:``
lines and the ``TOTAL CER/WER/EN CER/ZH CER`` figures must be identical
(the wall-clock ``TIME`` field is not compared).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mtl_tpu.cli.asr import test_main as jax_test_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import test_main as port_test_main
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import flax_params_to_torch
from mtl_tpu_torch.utils.checkpoint import save_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401


def _tiny_config(name, save_folder):
    cfg = JaxConfig()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 2, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 128, 320
    cfg.name, cfg.save_folder = name, save_folder
    return cfg.finalize()


def _report(out):
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("PRED:", "GOLD:", "TOTAL CER"))]
    return [re.sub(r" TIME: .*$", "", ln) for ln in lines]


def test_test_main_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # both CLIs write log/<name>.log
    manifests, labels_path = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=1, utts_per_task=5, min_sec=0.2,
        max_sec=0.6, max_chars=6, seed=3)
    with open(labels_path, encoding="utf-8") as f:
        vocab = JaxVocab.from_labels(json.load(f))

    cfg = _tiny_config("jax_ckpt", str(tmp_path / "models"))
    model = jax_build_model(cfg, len(vocab))
    rng = np.random.RandomState(11)
    params = model.init(
        jax.random.PRNGKey(rng.randint(2 ** 31)),
        jnp.zeros((1, 32, cfg.audio.num_freq), jnp.float32),
        jnp.array([32], jnp.int32), jnp.zeros((1, 4), jnp.int32))
    jax_path = jax_save_checkpoint(cfg, vocab, {"params": params}, step=0,
                                   best_model=True)

    # JAX checkpoint -> port checkpoint
    saved_cfg, saved_vocab, state, step, _ = jax_load_checkpoint(jax_path)
    port_cfg = Config.from_dict(json.loads(saved_cfg.to_json()))
    port_cfg.name = "port_ckpt"
    port_path = save_checkpoint(
        port_cfg, Vocab.from_dict(saved_vocab.to_dict()),
        flax_params_to_torch(jax.tree.map(np.asarray, state["params"])),
        step, best_model=True)
    assert os.path.exists(os.path.join(port_path, "meta.json"))

    common = ["--test-manifest-list", manifests[0],
              "--labels-path", labels_path, "--k-test", "2",
              "--src-buckets", "64", "--tgt-buckets", "16"]
    jax_test_main(common + ["--name", "jax_test", "--continue-from",
                            jax_path])
    want = _report(capsys.readouterr().out)
    result = port_test_main(common + ["--name", "port_test",
                                      "--continue-from", port_path,
                                      "--device", "cpu"])
    got = _report(capsys.readouterr().out)

    assert result["utterances"] == 5
    # 5 utterances in batches of 2: the third batch is padded with one
    # duplicate, which is not scored
    assert sum(ln.startswith("PRED:") for ln in want) == 5
    assert got == want


def test_breakdown_stages_on_cpu(tmp_path, monkeypatch, capsys):
    """The span-time tool serves one batch under the program's spans: every
    stage's span is counted once, and the decode loop's ``greedy.step`` and
    ``greedy.done_sync`` once a decode step the ids show."""
    from mtl_tpu_torch.cli.breakdown import breakdown_main
    from mtl_tpu_torch.models.transformer import build_model, init_weights

    monkeypatch.chdir(tmp_path)
    manifests, labels_path = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=1, utts_per_task=3, min_sec=0.2,
        max_sec=0.6, max_chars=6, seed=5)
    with open(labels_path, encoding="utf-8") as f:
        vocab = Vocab.from_labels(json.load(f))
    cfg = Config.from_dict(json.loads(
        _tiny_config("port_ckpt", str(tmp_path / "models")).to_json()))
    model = build_model(cfg, len(vocab))
    init_weights(model, torch.Generator().manual_seed(0))
    path = save_checkpoint(cfg, vocab, model.state_dict(), 0,
                           best_model=True)
    totals, steps = breakdown_main([
        "--test-manifest-list", manifests[0], "--labels-path", labels_path,
        "--continue-from", path, "--k-test", "2", "--src-buckets", "64",
        "--tgt-buckets", "16", "--device", "cpu"])
    once = ["serve.read_collate", "serve.to_device", "model.features",
            "model.vgg", "model.encoder", "model.cross_kv", "greedy.loop",
            "serve.to_strings"]
    assert set(totals) == set(once) | {"greedy.step", "greedy.done_sync"}
    assert all(totals[name].count == 1 for name in once)
    assert 1 <= steps <= 300
    assert totals["greedy.step"].count == steps
    assert totals["greedy.done_sync"].count == steps
    assert all(0 <= t.self_ns <= t.ns for t in totals.values())
    out = capsys.readouterr().out
    assert "decode steps; host ms by span:" in out
    assert "greedy.step" in out


def test_breakdown_short_kernel_names():
    from mtl_tpu_torch.cli.breakdown import _short_name

    assert _short_name("(anonymous namespace)::stft_fft_kernel<320, 2117u>"
                       "(float const*, int)") == "stft_fft_kernel"
    assert _short_name("void at::native::reduce_kernel<512, 1>(x)") == \
        "at::native::reduce_kernel"
