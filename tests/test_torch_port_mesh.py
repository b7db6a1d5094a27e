"""The port's (task, data) mesh against the JAX package's single-device
training, on the CPU.

Sharded steps: one gloo group of 4 CPU ranks (``parallel/launch.py``, rank
0 this process; the ranks' side is tests/torch_mesh_worker.py) computes
every case once per module, each on a sub-mesh of its first ranks; each
case is held against the JAX package's single-device step on the same
weights (``interop.py``) and inputs, f32, dropout 0:

* first-order meta-transfer steps on (task 2, data 2) with ``--device-cer``
  and at K 4 on (task 4, data 1); a second-order step on (task 1, data 2);
  a MAML step on (task 2, data 2); a joint step and an adversarial joint
  step on (task 2, data 2); an emb_cnn CTC epoch step (K 1) on data 4,
  its BatchNorm synchronized over the ranks;
* losses within rtol = atol = 1e-5; the outer gradients (the global ones
  every rank applies, recorded by the worker's Adam) within rtol 1e-4 and
  atol 1e-5 of the largest; the params after the outer Adam step by
  tests/test_torch_port_maml.py's criterion; emb_cnn's running BatchNorm
  statistics within 1e-5; every rank holds bitwise the same weights and
  buffers after the step.

The steps take precomputed feature batches (13 frequency bins, 161 for
emb_cnn) so that XLA compiles each JAX step in seconds.

CLI: ``meta_transfer_train_main --mesh-task 2 --mesh-data 2``,
``joint_train_main`` on the same mesh and ``train_main --mesh-data 2``
(``--device cpu``, ``--feat_extractor none``: a tied max-pool routes its
gradient by the conv's rounding, ROADMAP C, and the trajectories would part
by ~1e-3) print the JAX single-device run's TRAIN / AVG VALID losses
within rtol 2e-4, atol 1e-4, as tests/test_trainer_mesh.py holds the JAX
mesh; a mesh checkpoint resumes single-process and a single-process one
on the mesh; the refusals raise before any rank starts (among them a
``--mesh-model`` that does not divide the split weights' dims: at the
CLI's default width r 100 is not divisible by 3). The tensor-parallel
steps and CLIs are tests/test_torch_port_tp.py's.
"""

import json
import os
import re
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.models.discriminator import Discriminator as JaxDiscriminator
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.train.steps import make_joint_step as jax_joint_step
from mtl_tpu.train.steps import make_meta_step as jax_meta_step
from mtl_tpu.train.steps_disc import DiscTrainState as JaxDiscTrainState
from mtl_tpu.train.steps_disc import _disc_optimizer as jax_disc_optimizer
from mtl_tpu.train.steps_disc import make_joint_step_disc as jax_joint_disc
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.interop import disc_params_to_torch, flax_params_to_torch
from mtl_tpu_torch.parallel import launch
from tests.torch_mesh_worker import run_step_cases
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB, NFREQ, FRAMES = 12, 13, 32
CPU = torch.device("cpu")


def _jax_cfg(kind):
    cfg = JaxConfig()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 64, 32
    t = cfg.train
    t.lr, t.meta_lr = 0.05, 1e-3
    if kind == "epoch":
        m.feat_extractor, t.loss = "emb_cnn", "ctc"
    else:
        cfg.audio.window_size = 0.0015  # n_fft 24: 13 bins
    t.second_order = kind == "meta_so"
    t.device_cer = kind == "meta_cer"
    if kind == "joint_disc":
        t.adversarial, t.lr_disc = True, 1e-2
    return cfg.finalize()


def _features(seed, k, b, nfreq=NFREQ):
    """k task batches of b precomputed feature rows (lengths from 32 down
    to 20 frames) with 6-id targets (two of them shorter), [K, B, ...]."""
    rng = np.random.RandomState(seed)
    targets = rng.randint(3, VOCAB, (k, b, 6)).astype(np.int32)
    targets[:, 1::2, 4:] = 0
    return {"features": (rng.randn(k, b, FRAMES, nfreq) * 0.5).astype(
                np.float32),
            "input_lengths": np.tile(
                np.linspace(FRAMES, 20, b).astype(np.int32), (k, 1)),
            "targets": targets,
            "src_percentages": np.tile(np.linspace(1.0, 0.7, b).astype(
                np.float32), (k, 1))}


def _params(jcfg, seed=3):
    """Flax weights with conv biases drawn nonzero
    (tests/test_torch_port_train.py:_meta_params)."""
    model = jax_build_model(jcfg, VOCAB)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, FRAMES, jcfg.audio.num_freq), jnp.float32),
        jnp.array([FRAMES], jnp.int32), jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.RandomState(seed)
    for conv in params["params"]["conv"]["conv"].values():
        conv["bias"] = (rng.randn(*conv["bias"].shape) * 0.1).astype(
            np.float32)
    return model, params


def _recorder():
    """An optax transform whose state is the last gradient it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


# name: (kind, (task, data), K, B per task)
CASES = {
    "meta_fo_cer-t2d2": ("meta_cer", (2, 2), 4, 4),
    "meta_fo-k4-t4d1": ("meta", (4, 1), 4, 2),
    "meta_so-t1d2": ("meta_so", (1, 2), 2, 4),
    "maml-t2d2": ("maml", (2, 2), 2, 4),
    "joint-t2d2": ("joint", (2, 2), 2, 4),
    "joint_adversarial-t2d2": ("joint_disc", (2, 2), 2, 4),
    "epoch_emb_cnn_ctc-d4": ("epoch", (1, 4), 1, 4),
}


def _inputs(kind, k, b):
    nfreq = 161 if kind == "epoch" else NFREQ
    support = _features(1, k, b, nfreq)
    if kind == "epoch":  # CTC: 3 ids, feasible in the decoder's frames
        support["targets"][..., 3:] = 0
    if kind == "maml":
        return support, _features(2, k, b, nfreq)
    return support, {key: v[0] for key, v in
                     _features(2, 1, b, nfreq).items()}


def _jax_case(kind, jcfg, params, support, query, dparams):
    """(outer gradients by port name, metrics and the running BatchNorm
    statistics after the step) of the JAX step."""
    jmodel = jax_build_model(jcfg, VOCAB)
    rec = _recorder()
    base = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=rec.init(params))
    key = jax.random.PRNGKey(0)
    if kind in ("meta", "meta_cer", "meta_so", "maml"):
        st, m = jax_meta_step(jmodel, jcfg, rec,
                              per_task_query=kind == "maml",
                              space_id=1 if kind == "meta_cer" else None,
                              scan_tasks=True)(base, support, query, key)
    elif kind == "joint_disc":
        jdisc = JaxDiscriminator(jcfg.train.num_class)
        dtx = jax_disc_optimizer(jcfg)
        st = JaxDiscTrainState(base=base, disc_params=dparams,
                               disc_opt_state=dtx.init(dparams))
        st, loss, m = jax_joint_disc(jmodel, jdisc, jcfg, rec)(
            st, support, key, jnp.asarray(0.7))
        m = dict(m, loss=loss, disc_params=disc_params_to_torch(
            jax.tree.map(np.asarray, st.disc_params)))
        st = st.base
    else:
        st, loss, m = jax_joint_step(jmodel, jcfg, rec)(base, support, key)
        m = dict(m, loss=loss)
    grads = flax_params_to_torch(jax.tree.map(np.asarray, st.opt_state))
    stats = (".mean", ".var")  # emb_cnn's running BatchNorm statistics
    m["batch_stats"] = {
        k: v for k, v in flax_params_to_torch(
            jax.tree.map(np.asarray, st.params)).items() if k.endswith(stats)}
    return {k: g for k, g in grads.items() if not k.endswith(stats)}, m


@pytest.fixture(scope="module")
def step_results():
    """{case: (port result of rank 0, JAX gradients, JAX metrics, the
    weights before the step by port name)}, the port's cases all in one
    4-rank group."""
    specs, want = [], {}
    for name, (kind, shape, k, b) in CASES.items():
        jcfg = _jax_cfg(kind)
        _, params = _params(jcfg)
        support, query = _inputs(kind, k, b)
        dparams = None
        if kind == "joint_disc":
            dparams = jax.tree.map(np.asarray, JaxDiscriminator(
                jcfg.train.num_class).init(jax.random.PRNGKey(4), jnp.zeros(
                    (1, jcfg.model.dim_model))))
            dparams["params"]["Dense_0"]["bias"] = np.linspace(
                -0.2, 0.2, jcfg.train.num_class).astype(np.float32)
        grads, metrics = _jax_case(kind, jcfg, params, support, query,
                                   dparams)
        before = flax_params_to_torch(params)
        want[name] = (grads, metrics, before)
        spec = {"kind": "meta" if kind.startswith("meta") else kind,
                "shape": shape, "cfg": jcfg.to_json(), "vocab_size": VOCAB,
                "state_dict": {key: v.numpy() for key, v in before.items()},
                "support": support, "query": query, "beta": 0.7,
                "space_id": 1 if kind == "meta_cer" else None}
        if dparams is not None:
            spec["disc_state_dict"] = {
                key: v.numpy()
                for key, v in disc_params_to_torch(dparams).items()}
        specs.append(spec)
    cfg = Config()
    cfg.mesh.data = 4
    got = launch.run(cfg, CPU, run_step_cases, specs)
    return {name: (got[i],) + want[name] for i, name in enumerate(CASES)}


def _adam_params_close(got, before, grads, lr):
    """The params after one Adam step from ``before`` on the JAX gradients
    ``grads`` (optax.adam's first update: lr * g / (|g| + 1e-8)), by
    tests/test_torch_port_maml.py:assert_adam_params_close's criterion:
    within 2 lr everywhere and 1e-2 lr where |g| is above 1e-3 of the
    largest."""
    top = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        want = before[k] - lr * g / (g.abs() + 1e-8)
        d = (torch.from_numpy(got[k]) - want).abs()
        sure = g.abs() > 1e-3 * top
        assert float(d.max()) <= 2 * lr, k
        assert not sure.any() or float(d[sure].max()) <= 1e-2 * lr, k


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(step_results, name):
    got, grads, metrics, before = step_results[name]
    kind = CASES[name][0]
    assert got["same_on_every_rank"]
    tol = dict(rtol=1e-5, atol=1e-5)
    if kind.startswith("meta") or kind == "maml":
        np.testing.assert_allclose(got["metrics"]["outer_loss"],
                                   float(metrics["outer_loss"]), **tol)
        np.testing.assert_allclose(got["metrics"]["support_losses"],
                                   np.asarray(metrics["support_losses"]),
                                   **tol)
        for key in ("support_gold", "query_gold", "support_hyp"):
            np.testing.assert_array_equal(got["metrics"][key],
                                          np.asarray(metrics[key]))
        lr = 1e-3
    else:
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   float(metrics["loss"]), **tol)
        np.testing.assert_array_equal(got["metrics"]["gold"],
                                      np.asarray(metrics["gold"]))
        lr = 0.05
    if kind == "meta_cer":
        for key in ("cer_dist", "cer_chars"):
            assert int(got["metrics"][key]) == int(metrics[key])
    if kind == "joint_disc":
        for key in ("disc_loss", "enc_loss"):
            np.testing.assert_allclose(got["metrics"][key],
                                       float(metrics[key]), **tol)
        for key, v in metrics["disc_params"].items():
            np.testing.assert_allclose(got["disc_params"][key], v.numpy(),
                                       rtol=0, atol=1e-2 * 1e-2)
    assert set(got["grads"]) == set(grads)
    scale = max(float(g.abs().max()) for g in grads.values())
    for key, g in grads.items():
        np.testing.assert_allclose(got["grads"][key], g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=key)
    _adam_params_close(got["params"], before, grads, lr)
    # the synchronized BatchNorm's running statistics (emb_cnn)
    assert set(metrics["batch_stats"]) <= set(got["buffers"])
    for key, v in metrics["batch_stats"].items():
        np.testing.assert_allclose(got["buffers"][key], v.numpy(), **tol,
                                   err_msg=key)
    assert bool(metrics["batch_stats"]) == (kind == "epoch")


# -- the entry points on a mesh ---------------------------------------------

def _run_lines(out):
    keep = [ln for ln in out.splitlines() if ln.startswith(
        ("(Iteration", "(Epoch", "count_stop", "EARLY STOP"))]
    return [re.sub(r" TOTAL TIME:.*$", "", ln) for ln in keep]


def _losses(out):
    return ([float(x) for x in re.findall(r"TRAIN LOSS:([\d.]+)", out)],
            [float(x) for x in re.findall(r"AVG VALID LOSS:([\d.]+)", out)])


def _call(main, argv):
    buf = StringIO()
    with redirect_stdout(buf):
        state = main(argv)
    return buf.getvalue(), state


def cli_setup(tmp):
    """A synthetic corpus of 2 tasks under ``tmp`` and one step-0 JAX
    state saved by both packages (Adam and Noam Adam optimizer states):
    (the argv of the iteration trainers, the epoch trainer's, {optimizer:
    (JAX checkpoint, port checkpoint)})."""
    from mtl_tpu.data.vocab import Vocab as JaxVocab
    from mtl_tpu.train.optim import make_epoch_optimizer
    from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.interop import (adam_state_from_optax,
                                       noam_state_from_optax)
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    manifests, labels = make_synthetic_corpus(
        str(tmp / "corpus"), num_tasks=2, utts_per_task=8, max_sec=0.5,
        max_chars=6, seed=5)
    jcfg = JaxConfig()
    m = jcfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 64, 32
    m.feat_extractor = "none"
    t = jcfg.train
    t.k_train = t.k_valid = 4
    t.lr, t.meta_lr, t.warmup = 0.01, 0.001, 4
    t.evaluate_every = t.save_every = 2
    t.early_stop = "loss,5"
    jcfg.data.train_manifest_list, jcfg.data.labels_path = \
        manifests, labels
    jcfg.data.src_bucket_frames, jcfg.data.tgt_bucket_len = (64,), (16,)
    jcfg.data.batch_size = 4
    jcfg.save_folder = str(tmp / "models")
    jcfg.finalize()
    jvocab = JaxVocab.from_json(labels)
    vocab = Vocab.from_dict(jvocab.to_dict())
    jmodel = jax_build_model(jcfg, len(jvocab))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3),
        jnp.zeros((1, 32, jcfg.audio.num_freq), jnp.float32),
        jnp.array([32], jnp.int32), jnp.zeros((1, 4), jnp.int32)))
    paths = {}
    for opt_name, tx in (("adam", optax.adam(t.meta_lr)),
                         ("noam", make_epoch_optimizer(jcfg))):
        st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
        state = jax.tree.map(np.asarray, st.opt_state)
        port_state = (noam_state_from_optax(state) if opt_name == "noam"
                      else adam_state_from_optax(
                          state[0].mu, state[0].nu, state[0].count))
        jcfg.name = f"init_{opt_name}"
        pcfg = Config.from_dict(json.loads(jcfg.to_json()))
        pcfg.name = f"init_{opt_name}_port"
        paths[opt_name] = (
            jax_save(jcfg, jvocab, st, 0),
            save_checkpoint(pcfg, vocab, flax_params_to_torch(params), 0,
                            opt_state=port_state))
    common = ["--train-manifest-list", *manifests,
              "--valid-manifest-list", manifests[-1],
              "--labels-path", labels, "--src-buckets", "64",
              "--tgt-buckets", "16", "--epochs", "4"]
    epoch = ["--train-manifest-list", manifests[0],
             "--valid-manifest-list", manifests[1],
             "--labels-path", labels, "--src-buckets", "64",
             "--tgt-buckets", "16", "--batch-size", "4", "--epochs", "2"]
    return common, epoch, paths


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``cli_setup``'s corpus and checkpoints, then each entry point's JAX
    single-device run and the port's mesh run from them: {name: (JAX
    output, port output)}, plus the argv and the models folder."""
    from mtl_tpu.cli import asr as jax_cli
    from mtl_tpu_torch.cli import asr

    tmp = tmp_path_factory.mktemp("mesh_cli")
    old = os.getcwd()
    os.chdir(tmp)  # the CLIs write log/<name>.log
    try:
        common, epoch, paths = cli_setup(tmp)
        runs = {}
        for name, jmain, main, argv, opt, mesh in (
                ("meta_transfer", jax_cli.meta_transfer_train_main,
                 asr.meta_transfer_train_main, common, "adam",
                 ["--mesh-task", "2", "--mesh-data", "2"]),
                ("joint", jax_cli.joint_train_main, asr.joint_train_main,
                 common, "adam", ["--mesh-task", "2", "--mesh-data", "2"]),
                ("epoch", jax_cli.train_main, asr.train_main, epoch, "noam",
                 ["--mesh-data", "2"])):
            jax_out, _ = _call(jmain, argv + [
                "--name", f"{name}_jax", "--continue-from", paths[opt][0]])
            port_out, _ = _call(main, argv + mesh + [
                "--name", f"{name}_mesh", "--device", "cpu",
                "--continue-from", paths[opt][1]])
            runs[name] = (jax_out, port_out)
        runs["argv"], runs["models"] = common, tmp / "models"
        yield runs
    finally:
        os.chdir(old)


@pytest.mark.parametrize("name", ["meta_transfer", "joint", "epoch"])
def test_mesh_cli_prints_the_jax_single_device_losses(cli, name):
    jax_out, port_out = cli[name]
    mesh = "task=1 data=2" if name == "epoch" else "task=2 data=2"
    assert f"MESH: {mesh} model=1 over 4" in port_out or \
        f"MESH: {mesh} model=1 over 2" in port_out
    t1, v1 = _losses(jax_out)
    t2, v2 = _losses(port_out)
    assert len(t1) == len(t2) == (2 if name == "epoch" else 4)
    assert len(v1) == len(v2) == 2
    np.testing.assert_allclose(t2, t1, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(v2, v1, rtol=2e-4, atol=1e-4)


def test_mesh_checkpoints_resume_across_process_counts(cli, tmp_path,
                                                       monkeypatch):
    """The meta-transfer mesh run's ``step_2`` resumes single-process and
    on a (task 2, data 2) mesh with the same losses; the single-process
    resume's ``step_4`` resumes on the mesh with the losses of a
    single-process resume of it (rtol 2e-4, atol 1e-4, as
    tests/test_trainer_mesh.py:159-189 holds the JAX mesh)."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main as main

    monkeypatch.chdir(tmp_path)
    models = cli["models"]
    mesh = ["--mesh-task", "2", "--mesh-data", "2"]

    def resume(name, path, epochs, flags=()):
        argv = cli["argv"][:-1] + [str(epochs), "--device", "cpu", *flags,
                                   "--name", name, "--continue-from",
                                   str(models / path)]
        out, state = _call(main, argv)
        assert "RESTORED STATE" in out
        return out, state

    for src, epochs, first in (("meta_transfer_mesh/step_2", 4, 3),
                               ("resumed_single/step_4", 6, 5)):
        tag = src.split("/")[0]
        single, state = resume("resumed_single" if first == 3
                               else f"{tag}_alone", src, epochs)
        on_mesh, _ = resume(f"{tag}_on_mesh{first}", src, epochs, mesh)
        assert state.step == epochs and "MESH" not in single
        assert f"(Iteration {first}) TRAIN" in on_mesh
        t1, v1 = _losses(single)
        t2, v2 = _losses(on_mesh)
        assert len(t1) == len(t2) == 2 and len(v1) == len(v2) == 1
        np.testing.assert_allclose(t2, t1, rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(v2, v1, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("main,flags,match", [
    ("meta_transfer_train_main", ["--mesh-task", "2", "--mesh-data", "3"],
     "must divide --k-train"),
    ("meta_transfer_train_main", ["--mesh-task", "4"],
     "number of train manifests"),
    ("meta_transfer_train_main", ["--mesh-task", "2", "--scan-tasks"],
     "--scan-tasks serializes the task axis"),
    ("train_main", ["--mesh-task", "2"], "shards over --mesh-data only"),
    ("train_main", ["--mesh-data", "3"], "must divide --batch-size"),
    ("joint_train_main", ["--mesh-model", "3"], "should be divisible by 3"),
], ids=["k_train", "manifests", "scan_tasks", "epoch_task", "epoch_batch",
        "mesh_model"])
def test_mesh_refusals_raise_before_any_rank(cli, main, flags, match):
    from mtl_tpu_torch.cli import asr

    with pytest.raises(ValueError, match=match):
        getattr(asr, main)(cli["argv"] + ["--device", "cpu", "--k-train",
                                          "4", "--batch-size", "4"] + flags)


def test_mesh_on_cuda_without_a_card_raises_before_any_rank(cli):
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meta_transfer_train_main(cli["argv"] + ["--device", "cuda",
                                                "--mesh-task", "2"])
