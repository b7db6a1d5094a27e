"""The port's epoch trainer (the shuffled ``iter_batches``, Noam Adam,
``EpochTrainer`` and ``train_main``) against the JAX package's, on the
CPU.

Tiny width, f32, dropout 0, one shared weight set (a Flax param tree moved
into the port by ``mtl_tpu_torch.interop``), one synthetic task. Tolerances:
the Noam rate rtol 1e-6; params and Adam moments after the Noam updates
rtol 1e-5 with atol 1e-6 of the largest update (f32, the order of a few
elementwise operations); the entry point prints the JAX entry point's
lines, each number within one unit of its last printed digit or 1e-5
relative (a loss's fourth decimal can flip with f32 summation order).
"""

import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.cli.asr import train_main as jax_train_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.train.optim import make_epoch_optimizer as jax_epoch_optimizer
from mtl_tpu.train.optim import noam_adam as jax_noam_adam
from mtl_tpu.train.optim import noam_schedule as jax_noam_schedule
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import train_main
from mtl_tpu_torch.data.dataset import SpectrogramDataset
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import (flax_params_to_torch, noam_state_from_optax,
                                   noam_state_to_optax, torch_to_flax_params)
from mtl_tpu_torch.train.optim import (SGD, Adam, NoamAdam, NoamState,
                                       make_epoch_optimizer, noam_schedule,
                                       restore_opt_state)
from mtl_tpu_torch.utils.checkpoint import load_checkpoint_meta, \
    save_checkpoint
from tests.test_torch_port_joint import _params, _tiny
from tests.test_torch_port_lm_train import _same_line
from tests.test_torch_port_maml import _port_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("epoch_corpus"))
    manifests, labels = make_synthetic_corpus(root, num_tasks=2,
                                              utts_per_task=5, max_sec=0.5,
                                              max_chars=6, seed=19)
    return manifests, labels, JaxVocab.from_json(labels)


def test_shuffled_epochs_follow_the_jax_order(corpus):
    """Two shuffled passes of ``iter_batches`` (batch 2, the last batch
    padded) draw their orders from the dataset's RandomState, as the JAX
    dataset's do: the same target arrays, pass by pass, and a new order in
    the second pass."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jds = JaxDataset(jvocab, jcfg, manifests[:1], is_train=True, seed=23)
    ds = SpectrogramDataset(Vocab.from_dict(jvocab.to_dict()),
                            _port_cfg(jcfg), manifests[:1], is_train=True,
                            seed=23)
    passes = []
    for _ in range(2):
        want = [b["targets"] for b in jds.iter_batches(2)]
        got = [b["targets"] for b in ds.iter_batches(2)]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        passes.append(np.concatenate([g[:, :6] for g in got]))
    assert not np.array_equal(*passes)


def test_noam_schedule_matches_jax():
    """The rate at steps 0, 1, warmup and 10x warmup (and the min_lr
    floor), at the flagship d = dim_input 5120 and at a small width."""
    for args in ((5120, 1.0, 4000, 1e-6), (16, 2.0, 10, 1e-6),
                 (16, 0.01, 3, 5e-4)):
        want, got = jax_noam_schedule(*args), noam_schedule(*args)
        for count in (0, 1, args[2], 10 * args[2]):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6)


def test_noam_adam_matches_optax_and_round_trips():
    """Three updates of the port's NoamAdam and of optax's ``noam_adam``
    (warmup 2, so the rate rises and falls): params, moments and counts;
    the state after two updates, moved from optax through interop,
    continues the third update alike and maps back exactly. A Noam state
    restores neither into plain Adam nor the reverse."""
    rng = np.random.RandomState(3)
    tree = {"params": {"dec": {"kernel": rng.randn(4, 3).astype(np.float32),
                               "bias": rng.randn(3).astype(np.float32)}}}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                          tree) for _ in range(3)]
    args = (16, 2.0, 2, 1e-6)
    tx, opt = jax_noam_adam(*args), NoamAdam(*args)
    params, st = tree, tx.init(tree)
    sd = flax_params_to_torch(tree)
    state = opt.init(sd)
    for i, g in enumerate(grads):
        if i == 2:  # continue from the optax state, through interop
            state = noam_state_from_optax(st)
            mu, nu, count, sched = noam_state_to_optax(state)
            jax.tree.map(np.testing.assert_array_equal, (mu, nu),
                         jax.tree.map(np.asarray, (st[0].mu, st[0].nu)))
            assert int(count) == int(st[0].count) == 2
            assert int(sched) == int(st[1].count) == 2
            sd = flax_params_to_torch(jax.tree.map(np.asarray, params))
        upd, st = tx.update(g, st, params)
        params = optax.apply_updates(params, upd)
        opt.update(flax_params_to_torch(g), state, sd)
        want = flax_params_to_torch(jax.tree.map(np.asarray, params))
        moved = max(float(np.abs(np.asarray(u)).max())
                    for u in jax.tree.leaves(upd))
        for a, b in ((sd, want),
                     (state.mu, flax_params_to_torch(st[0].mu)),
                     (state.nu, flax_params_to_torch(st[0].nu))):
            for k, v in b.items():
                torch.testing.assert_close(a[k], v, rtol=1e-5,
                                           atol=1e-6 * moved)
        assert state.count == state.schedule_count == i + 1
    back = torch_to_flax_params(sd)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                         atol=1e-7),
                 back, jax.tree.map(np.asarray, params))
    adam = Adam(0.1)
    assert not restore_opt_state(adam.init(sd), state.tensors())
    assert not restore_opt_state(opt.init(sd), adam.init(sd).tensors())
    fresh = opt.init(sd)
    assert restore_opt_state(fresh, state.tensors())
    assert fresh.schedule_count == 3


def test_epoch_optimizer_is_noam_at_dim_input():
    """d is the config's ``dim_input`` (5120 for vgg_cnn over 161 bins),
    as the JAX package passes it; under ``--loss ctc`` it is nesterov SGD
    at ``lr`` and ``momentum``, whose first two updates equal JAX's."""
    jcfg = _tiny(JaxConfig())
    jcfg.train.warmup = 10
    cfg = _port_cfg(jcfg)
    opt = make_epoch_optimizer(cfg)
    assert isinstance(opt, NoamAdam) and cfg.model.dim_input == 5120
    assert isinstance(opt.init({"w": torch.zeros(2)}), NoamState)
    jtx = jax_epoch_optimizer(jcfg)
    w = {"w": jnp.zeros(2)}
    upd, _ = jtx.update({"w": jnp.ones(2)}, jtx.init(w), w)
    p = {"w": torch.zeros(2)}
    opt.update({"w": torch.ones(2)}, opt.init(p), p)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(upd["w"]),
                               rtol=1e-6)
    cfg.train.loss = jcfg.train.loss = "ctc"
    cfg.train.lr = jcfg.train.lr = 0.1
    opt, jtx = make_epoch_optimizer(cfg), jax_epoch_optimizer(jcfg)
    assert isinstance(opt, SGD) and opt.nesterov
    assert opt.momentum == cfg.train.momentum == 0.9
    w, p = {"w": jnp.zeros(2)}, {"w": torch.zeros(2)}
    jstate, state = jtx.init(w), opt.init(p)
    for g in ([1.0, -2.0], [0.5, 3.0]):
        upd, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, w)
        w = optax.apply_updates(w, upd)
        opt.update({"w": torch.tensor(g)}, state, p)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(w["w"]),
                                   rtol=1e-6)


def _epoch_lines(out):
    keep = ("(Epoch", "(Iteration", "EARLY STOP", "RESTORED", "Error")
    return [ln for ln in out.splitlines() if ln.startswith(keep)]


def test_train_main_prints_the_jax_lines(corpus, tmp_path, monkeypatch):
    """Both ``train_main``s continue one step-0 state (params + optax's
    Noam Adam state) for 2 epochs of batch 2 over one task (3 batches an
    epoch, the last padded, shuffled from the dataset's RandomState after
    the example batch's shuffle): the same Epoch and VALID lines. The
    port's checkpoints are ``step_1``, ``step_2`` and ``best_model`` (at
    step ``epoch``, as JAX writes it); a resume from ``step_2`` runs epoch
    2 (the third)."""
    monkeypatch.chdir(tmp_path)
    manifests, labels, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.warmup, jcfg.data.batch_size = 4, 2
    jcfg.data.train_manifest_list, jcfg.data.labels_path = \
        manifests[:1], labels
    jcfg.save_folder, jcfg.name = str(tmp_path / "models"), "init"
    _, params = _params(jcfg, len(jvocab))
    tx = jax_epoch_optimizer(jcfg)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    pcfg = _port_cfg(jcfg)
    pcfg.name = "init_port"
    paths = (jax_save_checkpoint(jcfg, jvocab, st, 0),
             save_checkpoint(pcfg, Vocab.from_dict(jvocab.to_dict()),
                             flax_params_to_torch(params), 0,
                             opt_state=noam_state_from_optax(
                                 jax.tree.map(np.asarray, st.opt_state))))
    argv = ["--train-manifest-list", manifests[0], "--valid-manifest-list",
            manifests[1], "--labels-path", labels, "--src-buckets", "64",
            "--tgt-buckets", "16", "--batch-size", "2", "--epochs", "2"]
    outs = []
    for side, main, path in zip(("jax", "port"), (jax_train_main, train_main),
                                paths):
        extra = ["--device", "cpu"] if side == "port" else []
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = main(argv + extra + ["--name", f"epoch_{side}",
                                         "--continue-from", path])
        outs.append(_epoch_lines(buf.getvalue()))
    want, got = outs
    assert [ln.split(")")[0] for ln in want if "TRAIN" in ln] == \
        ["(Epoch 0", "(Epoch 1"]
    assert got[0].startswith("RESTORED STATE")
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        _same_line(g, w)
    assert state.step == 6 and state.opt_state.schedule_count == 6
    models = tmp_path / "models" / "epoch_port"
    assert sorted(os.listdir(models)) == ["best_model", "step_1", "step_2"]
    best = load_checkpoint_meta(str(models / "best_model"))[2]
    with open(tmp_path / "models" / "epoch_jax" / "best_model" /
              "meta.json") as f:
        assert best == json.load(f)["step"]

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train_main(argv[:-1] + ["3", "--device", "cpu", "--name",
                                         "epoch_resume", "--continue-from",
                                         str(models / "step_2")])
    lines = _epoch_lines(buf.getvalue())
    assert [re.match(r"\(Epoch (\d+)\)", ln).group(1) for ln in lines
            if ln.startswith("(Epoch")] == ["2"]
    assert state.step == 9 and state.opt_state.schedule_count == 9
