"""The port's ASR joint training (``train/steps.py:make_joint_step``, the
joint optimizers of ``train/optim.py``, ``JointTrainer`` and the
``joint_train_main`` / ``finetune_main`` entry points) against the JAX
package's, on the CPU.

Tiny width, f32, dropout 0, one shared weight set (a Flax param tree moved
into the port by ``mtl_tpu_torch.interop``), batches drawn by the JAX
dataset from one synthetic 3-task corpus. Tolerances: losses 1e-5 (f32,
summation order only); gradients rtol 1e-4 with atol 3e-4 of the largest
(the f32 sums of the conv gradients run over ~1e4 products in other
orders); params after nesterov SGD within lr * 1.9 times that gradient
tolerance (the first nesterov step moves by lr * 1.9 g); after Adam, the
rule of the meta-step test (tests/test_torch_port_train.py): 1e-2 lr
wherever Adam's second moment is above 1e-3 of its largest, 2 lr
everywhere. The entry points print the JAX entry points' TRAIN/VALID
lines to their printed digits (the wall-clock TOTAL TIME masked).
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

from mtl_tpu.cli.asr import finetune_main as jax_finetune_main
from mtl_tpu.cli.asr import joint_train_main as jax_joint_train_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.train.optim import make_joint_optimizer as jax_joint_optimizer
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.train.steps import make_forward_fn as jax_forward_fn
from mtl_tpu.train.steps import make_joint_step as jax_make_joint_step
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import finetune_main, joint_train_main
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import (adam_state_from_optax, flax_params_to_torch,
                                   sgd_state_from_optax, sgd_state_to_optax)
from mtl_tpu_torch.models.transformer import build_model
from mtl_tpu_torch.train.optim import (SGD, Adam, AdamState, SGDState,
                                       make_joint_optimizer,
                                       restore_opt_state)
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       make_joint_step)
from mtl_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny(cfg):
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 64, 32
    cfg.data.src_bucket_frames, cfg.data.tgt_bucket_len = (64,), (16,)
    t = cfg.train
    t.k_train = t.k_valid = 2
    t.lr = 1e-2
    t.evaluate_every = t.save_every = 2
    t.early_stop = "loss,5"
    return cfg.finalize()


def _params(jcfg, vocab_size):
    """Flax params with conv biases drawn nonzero (at zero biases the
    padded frames put conv pre-activations at ~1e-8, whose ReLU side hangs
    on summation order; see tests/test_torch_port_train.py)."""
    model = jax_build_model(jcfg, vocab_size)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, jcfg.audio.num_freq)),
        jnp.array([32], jnp.int32), jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.RandomState(0)
    for conv in params["params"]["conv"]["conv"].values():
        conv["bias"] = (rng.randn(*conv["bias"].shape) * 0.1).astype(
            np.float32)
    return model, params


def _port_model(cfg, vocab_size, params):
    model = build_model(Config.from_dict(json.loads(cfg.to_json())),
                        vocab_size)
    model.load_state_dict(flax_params_to_torch(params))
    return model


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("joint_corpus"))
    manifests, labels = make_synthetic_corpus(root, num_tasks=3,
                                              utts_per_task=6, max_sec=0.5,
                                              max_chars=6, seed=7)
    return manifests, labels, JaxVocab.from_json(labels)


class _Recorder:
    """An optimizer that keeps the gradients and moves nothing."""

    def init(self, params):
        return AdamState(0, {}, {})

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in grads.items()}
        return state


@pytest.mark.parametrize("opt_name,clip", [("adam", False), ("sgd", True)])
def test_joint_step_matches_jax(corpus, opt_name, clip):
    """Two joint steps over 3 task batches of raw audio, each from the JAX
    state: loss and the params after each optimizer update; with
    ``--clip`` (max_norm 0.5) also the first step's clipped gradients."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jcfg.train.opt_name, jcfg.train.clip, jcfg.train.max_norm = \
        opt_name, clip, 0.5
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    jmodel, params = _params(jcfg, len(jvocab))
    ds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=3)
    batches = [ds.sample_meta_batch(2, 1)[0] for _ in range(2)]

    if clip:  # the gradients, read out once (one more JAX compile)
        forward = jax_forward_fn(jmodel, jcfg)
        want_g = jax.grad(lambda p: jnp.mean(jax.vmap(
            lambda b: forward(p, b)[0])(batches[0])))(params)
        norm = optax.global_norm(want_g)
        want_g = flax_params_to_torch(jax.tree.map(
            lambda g: np.asarray(g * jnp.minimum(1.0, 0.5 / (norm + 1e-6))),
            want_g))
        model = _port_model(jcfg, len(jvocab), params)
        rec = _Recorder()
        make_joint_step(model, cfg, rec)(init_train_state(model, rec),
                                         batch_to_device(batches[0], CPU))
        scale = max(float(v.abs().max()) for v in want_g.values())
        for k, v in want_g.items():
            torch.testing.assert_close(rec.grads[k], v, rtol=1e-4,
                                       atol=3e-4 * scale)

    tx = jax_joint_optimizer(jcfg)
    jstep = jax_make_joint_step(jmodel, jcfg, tx)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    model = _port_model(jcfg, len(jvocab), params)
    opt = make_joint_optimizer(cfg)
    assert isinstance(opt, SGD if opt_name == "sgd" else Adam)
    state = init_train_state(model, opt)
    step = make_joint_step(model, cfg, opt)
    lr = cfg.train.lr
    for i, batch in enumerate(batches):
        inner = jax.tree.map(np.asarray, st.opt_state[0])
        with torch.no_grad():
            for k, v in flax_params_to_torch(
                    jax.tree.map(np.asarray, st.params)).items():
                state.params[k].copy_(v)
        state.opt_state = (
            sgd_state_from_optax(inner.trace) if opt_name == "sgd"
            else adam_state_from_optax(inner.mu, inner.nu, inner.count))
        st, jloss, jaux = jstep(st, batch, jax.random.PRNGKey(i))
        state, loss, aux = step(state, batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        np.testing.assert_array_equal(aux["gold"].numpy(),
                                      np.asarray(jaux["gold"]))
        assert aux["hyp"].shape == jaux["hyp"].shape
        assert state.step == i + 1
        want = flax_params_to_torch(jax.tree.map(np.asarray, st.params))
        if opt_name == "sgd":
            for k, v in want.items():
                torch.testing.assert_close(
                    state.params[k].detach(), v, rtol=0,
                    atol=lr * 1.9 * 3e-4 * scale)
            continue
        nu = flax_params_to_torch(jax.tree.map(np.asarray,
                                               st.opt_state[0].nu))
        rms = {k: torch.sqrt(v / (1 - 0.999 ** (i + 1)))
               for k, v in nu.items()}
        top = max(float(v.max()) for v in rms.values())
        for k, v in want.items():
            d = (state.params[k].detach() - v).abs()
            sure = rms[k] > 1e-3 * top
            assert float(d.max()) <= 2 * lr, k
            assert not sure.any() or float(d[sure].max()) <= 1e-2 * lr, k


def test_nesterov_sgd_state_round_trips_through_interop():
    """optax.sgd(momentum 0.9, nesterov) for two updates -> the port's
    SGDState -> a third update on both sides: the same params and trace;
    the state maps back to optax's trace exactly."""
    rng = np.random.RandomState(1)
    tree = {"params": {"dec": {"kernel": rng.randn(4, 3).astype(np.float32),
                               "bias": rng.randn(3).astype(np.float32)}}}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                          tree) for _ in range(3)]
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    params, st = tree, tx.init(tree)
    for g in grads[:2]:
        upd, st = tx.update(g, st, params)
        params = optax.apply_updates(params, upd)
    port = sgd_state_from_optax(st[0].trace)
    back = sgd_state_to_optax(port)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, st[0].trace))
    sd = flax_params_to_torch(params)
    SGD(0.1, 0.9, nesterov=True).update(flax_params_to_torch(grads[2]), port,
                                        sd)
    upd, st = tx.update(grads[2], st, params)
    params = optax.apply_updates(params, upd)
    for a, b in ((sd, params), (port.trace, st[0].trace)):
        for k, v in flax_params_to_torch(b).items():
            torch.testing.assert_close(a[k], v, rtol=1e-6, atol=1e-7)


def test_opt_state_restores_only_into_its_own_structure():
    """Adam into Adam and a trace into nesterov SGD restore; across the
    two, or into SGD without momentum, nothing is copied (the JAX
    trainers' params-only branch)."""
    params = {"w": torch.ones(2, 3), "b": torch.zeros(3)}
    adam, sgd, plain = Adam(0.1), SGD(0.1, 0.9, True), SGD(0.1)
    src = {"adam": adam.init(params), "sgd": sgd.init(params),
           "plain": plain.init(params)}
    src["adam"].count = 4
    for s in (src["adam"].mu, src["sgd"].trace):
        s["w"].fill_(2.0)
    for name, opt in (("adam", adam), ("sgd", sgd), ("plain", plain)):
        for other, saved in src.items():
            state = opt.init(params)
            ok = restore_opt_state(state, saved.tensors())
            assert ok == (name == other), (name, other)
            if ok and name != "plain":
                field = state.mu if name == "adam" else state.trace
                assert float(field["w"].max()) == 2.0
    assert src["plain"].tensors() == {}
    assert isinstance(src["sgd"], SGDState)


def _lines(out):
    keep = [ln for ln in out.splitlines() if ln.startswith(
        ("(Iteration", "count_stop", "EARLY STOP", "RESTORED"))]
    return [re.sub(r" TOTAL TIME:.*$", "", ln) for ln in keep]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both packages' joint_train_main and finetune_main from shared
    checkpoints. One step-0 JAX state (params + optax Adam state) is saved
    twice by each package: with ``opt_name`` adam (the joint run, which
    restores the whole state) and as a meta checkpoint at step 2 whose
    config says ``opt_name`` sgd (the finetune, whose nesterov SGD cannot
    take the Adam state and restores the params alone)."""
    manifests, labels, jvocab = corpus
    tmp = tmp_path_factory.mktemp("joint_cli")
    jcfg = _tiny(JaxConfig())
    jcfg.data.train_manifest_list, jcfg.data.labels_path = manifests, labels
    jcfg.save_folder = str(tmp / "models")
    jmodel, params = _params(jcfg, len(jvocab))
    tx = optax.adam(jcfg.train.meta_lr)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    adam = jax.tree.map(np.asarray, st.opt_state[0])
    vocab = Vocab.from_dict(jvocab.to_dict())
    paths = {}
    for name, opt_name, step in (("joint", "adam", 0), ("meta", "sgd", 2)):
        jcfg.name, jcfg.train.opt_name = f"init_{name}", opt_name
        pcfg = Config.from_dict(json.loads(jcfg.to_json()))
        pcfg.name = f"init_{name}_port"
        paths[name] = (jax_save_checkpoint(jcfg, jvocab, st, step),
                       save_checkpoint(pcfg, vocab,
                                       flax_params_to_torch(params), step,
                                       opt_state=adam_state_from_optax(
                                           adam.mu, adam.nu, adam.count)))
    common = ["--train-manifest-list", *manifests, "--valid-manifest-list",
              manifests[-1], "--labels-path", labels, "--src-buckets", "64",
              "--tgt-buckets", "16"]
    out = {}
    with contextlib.chdir(tmp):  # the CLIs write log/<name>.log
        for key, mains, extra in (
                ("joint", (jax_joint_train_main, joint_train_main),
                 ["--epochs", "4"]),
                ("finetune", (jax_finetune_main, finetune_main),
                 ["--epochs", "5", "--opt_name", "sgd"])):
            for side, main in zip(("jax", "port"), mains):
                argv = common + extra + [
                    "--name", f"{key}_{side}", "--continue-from",
                    paths["joint" if key == "joint" else "meta"][
                        side == "port"]]
                if side == "port":
                    argv += ["--device", "cpu"]
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    state = main(argv)
                out[key, side] = (buf.getvalue(), state)
    out["models"] = str(tmp / "models")
    return out


@pytest.mark.parametrize("key,its", [("joint", [1, 2, 3, 4]),
                                     ("finetune", [3, 4, 5])])
def test_joint_entry_points_print_the_jax_lines(runs, key, its):
    (want, _), (got, state) = runs[key, "jax"], runs[key, "port"]
    want, got = _lines(want), _lines(got)
    assert [int(x) for x in re.findall(r"\(Iteration (\d+)\) TRAIN",
                                       "\n".join(want))] == its
    assert sum("AVG VALID" in ln for ln in want) >= 1
    assert want[0].startswith("RESTORED STATE")
    assert got[0].startswith("RESTORED STATE")
    assert got[1:] == want[1:]
    if key == "joint":  # the whole state restored: Adam continues
        assert isinstance(state.opt_state, AdamState)
        assert state.step == 4 and state.opt_state.count == 4
    else:  # params only: a fresh nesterov SGD from step 0
        assert isinstance(state.opt_state, SGDState)
        assert state.step == 3 and state.opt_state.trace is not None
        saved = load_train_state(os.path.join(runs["models"],
                                              "finetune_port", "step_4"))
        assert set(saved) == {"step", "trace"} and saved["step"] == 4
