"""The port's MAML path (the per-task query draw, the meta step with
``per_task_query``, meta-test and ``meta_train_main``) against the JAX
package's, on the CPU.

Tiny width, f32, dropout 0, one shared weight set (a Flax param tree moved
into the port by ``mtl_tpu_torch.interop``), batches drawn by the JAX
dataset from one synthetic 3-task corpus. Tolerances: losses rtol = atol =
1e-5 (f32, summation order only); params after Adam by the rule of the
meta-step test (tests/test_torch_port_train.py): 1e-2 lr wherever Adam's
second moment is above 1e-3 of its largest, 2 lr everywhere. The entry
point prints the JAX entry point's lines (the wall-clock TOTAL TIME
masked), each number within one unit of its last printed digit or 1e-5
relative, the losses' tolerance: a loss that f32 summation order moves by
1e-6 can flip its fourth decimal.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.cli.asr import meta_train_main as jax_meta_train_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.train.steps import make_meta_step as jax_make_meta_step
from mtl_tpu.train.trainer import MetaTrainer as JaxMetaTrainer
from mtl_tpu.train.trainer import meta_evaluate as jax_meta_evaluate
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import meta_train_main
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.dataset import SpectrogramDataset
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import adam_state_from_optax, flax_params_to_torch
from mtl_tpu_torch.train.optim import Adam
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       make_meta_step)
from mtl_tpu_torch.train.trainer import MetaTrainer, meta_evaluate
from mtl_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_port_joint import _lines, _params, _port_model, _tiny
from tests.test_torch_port_lm_train import _same_line
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _port_cfg(jcfg):
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    cfg.device = "cpu"
    return cfg


def assert_adam_params_close(got, st, lr, count):
    """The port's params after Adam against the JAX state ``st`` (whose
    ``opt_state[0]`` is the Adam state after ``count`` updates)."""
    want = flax_params_to_torch(jax.tree.map(np.asarray, st.params))
    nu = flax_params_to_torch(jax.tree.map(np.asarray, st.opt_state[0].nu))
    rms = {k: torch.sqrt(v / (1 - 0.999 ** count)) for k, v in nu.items()}
    top = max(float(v.max()) for v in rms.values())
    for k, v in want.items():
        d = (got[k].detach() - v).abs()
        sure = rms[k] > 1e-3 * top
        assert float(d.max()) <= 2 * lr, k
        assert not sure.any() or float(d[sure].max()) <= 1e-2 * lr, k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("maml_corpus"))
    manifests, labels = make_synthetic_corpus(root, num_tasks=3,
                                              utts_per_task=6, max_sec=0.5,
                                              max_chars=6, seed=11)
    return manifests, labels, JaxVocab.from_json(labels)


def test_per_task_query_draw_matches_jax(corpus):
    """MAML draws (support of every task, then a query of every task,
    [K, B, ...]) and a shared-query draw after them: the same arrays as
    the JAX dataset's for one seed."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=17)
    ds = SpectrogramDataset(Vocab.from_dict(jvocab.to_dict()),
                            _port_cfg(jcfg), manifests, is_train=True,
                            seed=17)
    for per_task, k_train, k_valid in ((True, 2, 2), (True, 1, 3),
                                       (False, 2, 2)):
        want = jds.sample_meta_batch(k_train, k_valid,
                                     per_task_query=per_task)
        got = ds.sample_meta_batch(k_train, k_valid, per_task_query=per_task)
        assert got[1]["audio"].shape[:2] == ((3, k_valid) if per_task
                                             else (k_valid,
                                                   got[1]["audio"].shape[1]))
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_maml_step_matches_jax(corpus):
    """Two MAML steps (3 tasks, each with its own query of raw audio, the
    inner and outer clip at max_norm 0.5), each from the JAX state before
    it: outer and support losses, and the params after the Adam update."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.clip, jcfg.train.max_norm = True, 0.5
    jcfg.train.meta_lr = 1e-3
    cfg = _port_cfg(jcfg)
    jmodel, params = _params(jcfg, len(jvocab))
    ds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=4)
    batches = [ds.sample_meta_batch(2, 2, per_task_query=True)
               for _ in range(2)]

    lr = jcfg.train.meta_lr
    tx = optax.adam(lr)
    jstep = jax_make_meta_step(jmodel, jcfg, tx, per_task_query=True)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    model = _port_model(jcfg, len(jvocab), params)
    opt = Adam(lr)
    state = init_train_state(model, opt)
    step = make_meta_step(model, cfg, opt, per_task_query=True)
    for i, (sup, qry) in enumerate(batches):
        adam = jax.tree.map(np.asarray, st.opt_state[0])
        with torch.no_grad():
            for k, v in flax_params_to_torch(
                    jax.tree.map(np.asarray, st.params)).items():
                state.params[k].copy_(v)
        state.opt_state = adam_state_from_optax(adam.mu, adam.nu, adam.count)
        st, mj = jstep(st, sup, qry, jax.random.PRNGKey(i))
        state, m = step(state, batch_to_device(sup, CPU),
                        batch_to_device(qry, CPU))
        np.testing.assert_allclose(float(m["outer_loss"]),
                                   float(mj["outer_loss"]), **TOL)
        np.testing.assert_allclose(m["support_losses"].numpy(),
                                   np.asarray(mj["support_losses"]), **TOL)
        np.testing.assert_array_equal(m["query_gold"].numpy(),
                                      np.asarray(mj["query_gold"]))
        assert tuple(m["query_hyp"].shape) == mj["query_hyp"].shape
        assert mj["query_hyp"].shape[:2] == (3, 2)
        assert state.step == i + 1
        assert_adam_params_close(state.params, st, lr, i + 1)


def test_meta_evaluate_matches_jax(corpus, tmp_path, monkeypatch):
    """Meta-test, 2 trials from one dataset seed: each trial adapts by one
    inner step (with the clip) on a support draw of the target manifest
    and evaluates at the adapted weights; the trials' averages agree."""
    monkeypatch.chdir(tmp_path)
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.clip, jcfg.train.max_norm = True, 0.5
    cfg = _port_cfg(jcfg)
    vocab = Vocab.from_dict(jvocab.to_dict())
    jmodel, params = _params(jcfg, len(jvocab))
    model = _port_model(jcfg, len(jvocab), params)
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            trainer = JaxMetaTrainer(jmodel, jcfg, jvocab)
            ds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=8)
            valid = [JaxDataset(jvocab, jcfg, [manifests[-1]], seed=9)]
            evaluate = lambda: jax_meta_evaluate(trainer, params, ds, valid,
                                                 num_meta_test=2)
        else:
            trainer = MetaTrainer(model, cfg, vocab, CPU)
            ds = SpectrogramDataset(vocab, cfg, manifests, is_train=True,
                                    seed=8)
            valid = [SpectrogramDataset(vocab, cfg, [manifests[-1]], seed=9)]
            evaluate = lambda: meta_evaluate(
                trainer, dict(model.named_parameters()), ds, valid,
                num_meta_test=2)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss, cer = evaluate()
        out.append((loss, cer, buf.getvalue()))
    (jloss, jcer, jout), (loss, cer, pout) = out
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert cer == pytest.approx(jcer, abs=1e-9)
    assert pout.splitlines() == jout.splitlines()
    assert "(Meta-test) trials=2" in pout
    # the model's own weights are left as they were
    for k, v in flax_params_to_torch(params).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_meta_train_main_prints_the_jax_lines(corpus, tmp_path, monkeypatch):
    """Both ``meta_train_main``s continue one step-0 state (params + optax
    Adam) for 4 MAML iterations with an evaluation every 2, then run
    ``--num-meta-test 2``: the same TRAIN, VALID and Meta-test lines."""
    monkeypatch.chdir(tmp_path)
    manifests, labels, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.meta_lr = 1e-3
    jcfg.data.train_manifest_list, jcfg.data.labels_path = manifests, labels
    jcfg.save_folder, jcfg.name = str(tmp_path / "models"), "init"
    _, params = _params(jcfg, len(jvocab))
    tx = optax.adam(jcfg.train.meta_lr)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    adam = jax.tree.map(np.asarray, st.opt_state[0])
    pcfg = _port_cfg(jcfg)
    pcfg.name = "init_port"
    paths = (jax_save_checkpoint(jcfg, jvocab, st, 0),
             save_checkpoint(pcfg, Vocab.from_dict(jvocab.to_dict()),
                             flax_params_to_torch(params), 0,
                             opt_state=adam_state_from_optax(
                                 adam.mu, adam.nu, adam.count)))
    argv = ["--train-manifest-list", *manifests, "--valid-manifest-list",
            manifests[-1], "--labels-path", labels, "--src-buckets", "64",
            "--tgt-buckets", "16", "--epochs", "4", "--num-meta-test", "2"]
    outs = []
    for side, main, path in zip(("jax", "port"),
                                (jax_meta_train_main, meta_train_main),
                                paths):
        extra = ["--device", "cpu"] if side == "port" else []
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = main(argv + extra + ["--name", f"maml_{side}",
                                         "--continue-from", path])
        outs.append(buf.getvalue())
    jout, pout = outs
    assert "Meta Trainer is initialized" in pout
    assert state.step == 4 and state.opt_state.count == 4
    keep = lambda out: _lines(out) + [ln for ln in out.splitlines()
                                      if ln.startswith("(Meta-test)")]
    want, got = keep(jout), keep(pout)
    assert sum("TRAIN LOSS" in ln for ln in want) == 4
    assert want[-1].startswith("(Meta-test) trials=2")
    assert want[0].startswith("RESTORED STATE")
    assert got[0].startswith("RESTORED STATE")
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        _same_line(g, w)
