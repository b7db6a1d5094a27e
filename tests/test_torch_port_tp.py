"""The port's tensor-parallel training (``--mesh-model``, parallel/tp.py)
against the JAX package's single-device training, on the CPU.

Sharded steps: one gloo group of 4 CPU ranks (``parallel/launch.py``, rank
0 this process; the ranks' side is tests/torch_mesh_worker.py) computes
every case once per module, each on a sub-mesh of its first ranks with a
``model`` axis; each case is held against the JAX package's single-device
step on the same weights (``interop.py``) and inputs, f32, dropout 0, with
tests/test_torch_port_mesh.py's tolerances:

* a first-order meta-transfer step on (task 2, model 2); second-order with
  ``--clip`` on model 2 (the inner clip differentiated through the norm's
  reduction over the axis); MAML on model 2; a joint step with ``--clip``
  on (data 2, model 2); an adversarial joint step on model 2, whose model
  stays replicated as in the JAX package; an emb_cnn CTC epoch step on
  (data 2, model 2); a 2-block Conformer meta step at d 32, 2 heads, on
  model 2 (the GLU's interleaved split), and with ``--remat`` (the split
  blocks' collectives run again in the recompute); a meta step whose 2
  heads straddle the ranks of model 4;
* losses within rtol = atol = 1e-5; the outer gradients, gathered to full,
  within rtol 1e-4 and atol 1e-5 of the largest; the params after Adam by
  tests/test_torch_port_maml.py's criterion; on each rank a split leaf and
  its Adam moments hold 1/M of the full tensor; the replicated leaves are
  bitwise equal on every rank and a split leaf on the ranks of its plane.

The port's rule table gives JAX's spec (mtl_tpu/parallel/sharding.py) on
every leaf of 2 or more dims of the flagship and the Conformer.

CLI (``--device cpu --feat_extractor none``, as test_torch_port_mesh.py):
``meta_transfer_train_main --mesh-task 2 --mesh-model 2``,
``joint_train_main --mesh-model 2`` and ``train_main --mesh-data 2
--mesh-model 2`` print the JAX single-device run's TRAIN / AVG VALID
losses within rtol 2e-4, atol 1e-4; at dropout 0.1 ``--mesh-model 2``
prints the losses of the model-1 mesh at the same (task, data) within rtol
1e-5 (the same masks); a model-2 checkpoint resumes in one process and a
one-process checkpoint on model 2, with the same losses.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.models.discriminator import Discriminator as JaxDiscriminator
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.parallel.sharding import _spec_for
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.interop import (disc_params_to_torch, flax_path,
                                   flax_params_to_torch)
from mtl_tpu_torch.models.transformer import build_model
from mtl_tpu_torch.parallel import launch, tp
from tests.test_torch_port_mesh import (NFREQ, VOCAB, _adam_params_close,
                                        _call, _features, _jax_case, _losses,
                                        _params, cli_setup)
from tests.torch_mesh_worker import run_step_cases
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _jax_cfg(kind, conformer=False, clip=False, remat=False):
    cfg = JaxConfig()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len, m.remat = 64, 32, remat
    if conformer:
        m.encoder_type, m.num_enc_layers = "conformer", 2
        m.dim_model = m.dim_emb = m.dim_inner = 32
        m.dim_key = m.dim_value = 16
    t = cfg.train
    t.lr, t.meta_lr, t.clip = 0.05, 1e-3, clip
    if kind == "epoch":
        m.feat_extractor, t.loss = "emb_cnn", "ctc"
    else:
        cfg.audio.window_size = 0.0015  # n_fft 24: 13 bins
    t.second_order = kind == "meta_so"
    if kind == "joint_disc":
        t.adversarial, t.lr_disc = True, 1e-2
    return cfg.finalize()


# name: (kind, (task, data, model), K, B per task, config options)
CASES = {
    "meta_fo-t2m2": ("meta", (2, 1, 2), 2, 4, {}),
    "meta_so_clip-m2": ("meta_so", (1, 1, 2), 2, 4, {"clip": True}),
    "maml-m2": ("maml", (1, 1, 2), 2, 4, {}),
    "joint_clip-d2m2": ("joint", (1, 2, 2), 2, 4, {"clip": True}),
    "joint_adversarial-m2": ("joint_disc", (1, 1, 2), 2, 4, {}),
    "epoch_emb_cnn_ctc-d2m2": ("epoch", (1, 2, 2), 1, 4, {}),
    "conformer_meta-m2": ("meta", (1, 1, 2), 2, 4, {"conformer": True}),
    "conformer_meta_remat-m2": ("meta", (1, 1, 2), 2, 4,
                                {"conformer": True, "remat": True}),
    "meta_straddling_heads-m4": ("meta", (1, 1, 4), 2, 2, {}),
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


@pytest.fixture(scope="module")
def step_results():
    """{case: (port result of rank 0, JAX gradients, JAX metrics, the
    weights before the step by port name)}, the port's cases all in one
    4-rank group."""
    specs, want = [], {}
    for name, (kind, shape, k, b, opts) in CASES.items():
        jcfg = _jax_cfg(kind, **opts)
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
                "support": support, "query": query, "beta": 0.7}
        if dparams is not None:
            spec["disc_state_dict"] = {
                key: v.numpy()
                for key, v in disc_params_to_torch(dparams).items()}
        specs.append(spec)
    cfg = Config()
    cfg.mesh.data = 4
    got = launch.run(cfg, CPU, run_step_cases, specs)
    return {name: (got[i],) + want[name] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_jax(step_results, name):
    got, grads, metrics, before = step_results[name]
    kind, shape = CASES[name][:2]
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
    if kind == "joint_disc":
        assert "layout" not in got  # replicated, as in the JAX package
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
    for key, v in metrics["batch_stats"].items():
        np.testing.assert_allclose(got["buffers"][key], v.numpy(), **tol,
                                   err_msg=key)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0] != "joint_disc"])
def test_split_leaves_and_moments_hold_a_slice(step_results, name):
    """Each split leaf and its Adam moments hold 1/M of the full tensor on
    the rank, along the split dim; every other leaf is whole."""
    got, _, _, before = step_results[name]
    m = CASES[name][1][2]
    layout = got["layout"]
    assert layout
    for key, full in before.items():
        if key.endswith((".mean", ".var")):  # emb_cnn's buffers
            continue
        want = list(full.shape)
        if key in layout:
            want[layout[key][0]] //= m
        assert list(got["local_shapes"][key]) == want, key
        assert list(got["moment_shapes"][key]) == want, key


def _jax_leaves(jcfg):
    """{flax path below "params": JAX's split} of every >= 2-D leaf of
    the JAX model at ``jcfg``."""
    _, params = _params(jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    out = {}
    for kp, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "name", str(k))) for k in kp]
        if keys[0] != "params" or leaf.ndim < 2:
            continue
        spec = _spec_for("/".join(keys), leaf.ndim)
        out["/".join(keys[1:])] = (None if spec == jax.sharding.PartitionSpec()
                                   else "col" if spec[-1] == "model"
                                   else "row")
    return out


@pytest.mark.parametrize("conformer", [False, True],
                         ids=["flagship", "conformer"])
def test_rule_table_gives_jax_spec_on_every_leaf(conformer):
    """``tp.jax_spec`` and the port's layout, leaf by leaf, against
    mtl_tpu/parallel/sharding.py:_spec_for on the JAX model's params
    (as tests/test_parallel.py:369-408 checks JAX's coverage)."""
    jcfg = _jax_cfg("meta", conformer=conformer)
    jax_specs = _jax_leaves(jcfg)
    model = build_model(Config.from_dict(json.loads(jcfg.to_json())),
                        VOCAB)
    layout = tp.param_layout(model)
    seen = set()
    for name, p in model.named_parameters():
        path = "/".join(flax_path(name, p.dim()))
        if p.dim() < 2:
            continue
        seen.add(path)
        kind = jax_specs[path]
        assert tp.jax_spec("params/" + path, p.dim()) == kind, path
        want = None if kind is None else (0 if kind == "col" else 1)
        assert (layout[name].dim if name in layout else None) == want, name
    assert seen == set(jax_specs)
    assert any(v == "col" for v in jax_specs.values())
    assert any(v == "row" for v in jax_specs.values())
    if conformer:  # the GLU's values and gates, a slice of each
        assert layout["encoder.blocks.0.conv.pw1.weight"] == tp.Split(0, 2)


@pytest.mark.parametrize("conformer", [False, True],
                         ids=["flagship", "conformer"])
def test_interop_shards_round_trip(conformer):
    """A JAX param tree cut to each rank's state_dict on model 2 is what
    ``tp.shard_module`` leaves in that rank's model, and joins back to the
    same tree."""
    from mtl_tpu_torch.interop import (flax_params_to_torch_shard,
                                       torch_shards_to_flax_params)

    jcfg = _jax_cfg("meta", conformer=conformer)
    _, params = _params(jcfg)
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    shards = []
    for index in range(2):
        model = build_model(cfg, VOCAB)
        model.load_state_dict(flax_params_to_torch(params))
        layout = tp.shard_module(model, _Axis(2, index))
        shard = flax_params_to_torch_shard(params, layout, 2, index)
        assert set(shard) == set(model.state_dict())
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), shard[k].numpy(),
                                          err_msg=k)
        shards.append(shard)
    back = torch_shards_to_flax_params(shards, layout)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    for kp, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(v, np.asarray(flat[kp]))
    assert len(flat) == len(jax.tree_util.tree_leaves(back))


class _Axis:
    """A ``model`` axis as one rank sees it, without a process group
    (``shard_module`` only slices)."""

    def __init__(self, size, index):
        self.size, self.index, self.group = size, index, None


def test_undivided_split_dim_is_refused():
    """A ``--mesh-model`` that does not divide a split dim is refused on
    the meta device, with JAX's word for it."""
    cfg = Config()
    tp.check_config(cfg, 2)
    tp.check_config(cfg, 4)
    with pytest.raises(ValueError, match="should be divisible by 3"):
        tp.check_config(cfg, 3)


# -- the entry points on a model axis ----------------------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Each entry point's JAX single-device run and the port's run on a
    mesh with a model axis, from one step-0 state: {name: (JAX output,
    port output)}, with the argv and the models folder."""
    from mtl_tpu.cli import asr as jax_cli
    from mtl_tpu_torch.cli import asr

    tmp = tmp_path_factory.mktemp("tp_cli")
    old = os.getcwd()
    os.chdir(tmp)  # the CLIs write log/<name>.log
    try:
        common, epoch, paths = cli_setup(tmp)
        runs = {}
        for name, jmain, main, argv, opt, mesh in (
                ("meta_transfer", jax_cli.meta_transfer_train_main,
                 asr.meta_transfer_train_main, common, "adam",
                 ["--mesh-task", "2", "--mesh-model", "2"]),
                ("joint", jax_cli.joint_train_main, asr.joint_train_main,
                 common, "adam", ["--mesh-model", "2"]),
                ("epoch", jax_cli.train_main, asr.train_main, epoch, "noam",
                 ["--mesh-data", "2", "--mesh-model", "2"])):
            jax_out, _ = _call(jmain, argv + [
                "--name", f"{name}_jax", "--continue-from", paths[opt][0]])
            port_out, _ = _call(main, argv + mesh + [
                "--name", f"{name}_tp", "--device", "cpu",
                "--continue-from", paths[opt][1]])
            runs[name] = (jax_out, port_out)
        runs["argv"], runs["models"] = common, tmp / "models"
        runs["init"] = paths["adam"][1]
        yield runs
    finally:
        os.chdir(old)


@pytest.mark.parametrize("name", ["meta_transfer", "joint", "epoch"])
def test_tp_cli_prints_the_jax_single_device_losses(cli, name):
    jax_out, port_out = cli[name]
    mesh = {"meta_transfer": "task=2 data=1 model=2 over 4",
            "joint": "task=1 data=1 model=2 over 2",
            "epoch": "task=1 data=2 model=2 over 4"}[name]
    assert f"MESH: {mesh}" in port_out
    t1, v1 = _losses(jax_out)
    t2, v2 = _losses(port_out)
    assert len(t1) == len(t2) == (2 if name == "epoch" else 4)
    assert len(v1) == len(v2) == 2
    np.testing.assert_allclose(t2, t1, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(v2, v1, rtol=2e-4, atol=1e-4)


def test_tp_draws_the_masks_of_the_model_1_mesh(cli, tmp_path, monkeypatch):
    """At dropout 0.1 the (task 2, model 2) run prints the (task 2) run's
    losses: the ranks of a model group draw the masks of their place in
    the plane, a split activation the full mask's slice."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main as main

    monkeypatch.chdir(tmp_path)
    argv = cli["argv"] + ["--device", "cpu", "--dropout", "0.1",
                          "--continue-from", cli["init"], "--mesh-task", "2"]
    plain, _ = _call(main, argv + ["--name", "drop_plane"])
    split, _ = _call(main, argv + ["--name", "drop_tp", "--mesh-model", "2"])
    t1, v1 = _losses(plain)
    t2, v2 = _losses(split)
    assert len(t1) == len(t2) == 4 and len(v1) == len(v2) == 2
    np.testing.assert_allclose(t2, t1, rtol=1e-5)
    np.testing.assert_allclose(v2, v1, rtol=1e-5)


def test_tp_checkpoints_resume_across_process_counts(cli, tmp_path,
                                                     monkeypatch):
    """The (task 2, model 2) run's ``step_2`` (full tensors) resumes in one
    process and on the mesh with the same losses; the one-process
    resume's ``step_4`` resumes on the mesh with the losses of a
    one-process resume of it."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main as main

    monkeypatch.chdir(tmp_path)
    models = cli["models"]
    mesh = ["--mesh-task", "2", "--mesh-model", "2"]

    def resume(name, path, epochs, flags=()):
        argv = cli["argv"][:-1] + [str(epochs), "--device", "cpu", *flags,
                                   "--name", name, "--continue-from",
                                   str(models / path)]
        out, state = _call(main, argv)
        assert "RESTORED STATE" in out
        return out, state

    saved = torch.load(models / "meta_transfer_tp/step_2/model.pt")
    init = torch.load(os.path.join(cli["init"], "model.pt"))
    assert {k: v.shape for k, v in saved.items()} == \
        {k: v.shape for k, v in init.items()}  # full tensors
    for src, epochs, first in (("meta_transfer_tp/step_2", 4, 3),
                               ("resumed_single/step_4", 6, 5)):
        tag = src.split("/")[0]
        single, state = resume("resumed_single" if first == 3
                               else f"{tag}_alone", src, epochs)
        on_mesh, _ = resume(f"{tag}_on_tp{first}", src, epochs, mesh)
        assert state.step == epochs and "MESH" not in single
        assert f"(Iteration {first}) TRAIN" in on_mesh
        t1, v1 = _losses(single)
        t2, v2 = _losses(on_mesh)
        assert len(t1) == len(t2) == 2 and len(v1) == len(v2) == 1
        np.testing.assert_allclose(t2, t1, rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(v2, v1, rtol=2e-4, atol=1e-4)
