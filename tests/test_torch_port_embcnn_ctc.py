"""The other front-end, subsampler and loss of the port against the JAX
package: the log-mel filterbank, emb_cnn with flax's BatchNorm, and CTC.

One Flax emb_cnn model at tiny width (f32, dropout 0) with random
BatchNorm scales, biases and running statistics goes into the port through
``interop`` (``params`` and ``batch_stats``). Both packages then take the
same steps on the same batches of one synthetic corpus:

* the subsampler's forward in training and evaluation mode, and the
  running statistics a training forward reports (flax's momentum 0.99 and
  biased variance), within 1e-5;
* a joint step at K = 2 and a meta step at K = 2: the parameters
  after the update and the running statistics, which are the mean over the
  tasks of what each task's forward (the meta step: each query forward)
  gave from the same starting statistics, within 1e-5;
* an epoch step under ``--loss ctc`` (nesterov SGD, the epoch trainer's
  optimizer): parameters within 1e-5; the CTC evaluation step's per-row
  losses;
* ``ctc_loss`` itself on a batch with an infeasible row (more target
  symbols than frames), where optax's finite log(0) gives a large finite
  loss and ``F.ctc_loss`` gives inf;
* ``test_main`` serving an emb_cnn checkpoint and a log-fbank (vgg_cnn)
  checkpoint: the same ``PRED:`` / ``TOTAL`` lines. emb_cnn over the 80
  log-fbank bins would leave no frequency row after its second conv, so
  the two front-ends are served by two checkpoints.
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
import torch.nn.functional as F

from mtl_tpu.cli.asr import test_main as jax_test_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.subsampler import FeatureExtractor as JaxFeatureExtractor
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.ops.frontend import log_fbank as jax_log_fbank
from mtl_tpu.ops.frontend import log_fbank_oracle
from mtl_tpu.train import steps as jax_steps
from mtl_tpu.train.losses import ctc_loss as jax_ctc_loss
from mtl_tpu.train.optim import make_epoch_optimizer as jax_epoch_optimizer
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import test_main as port_test_main
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import flax_params_to_torch, torch_to_flax_params
from mtl_tpu_torch.models.subsampler import (FeatureExtractor,
                                             subsampled_freq)
from mtl_tpu_torch.models.transformer import build_model
from mtl_tpu_torch.ops.frontend import log_fbank
from mtl_tpu_torch.train.losses import ctc_loss
from mtl_tpu_torch.train.optim import SGD, Adam, make_epoch_optimizer
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       make_eval_step, make_joint_step,
                                       make_meta_step)
from mtl_tpu_torch.utils.checkpoint import (load_checkpoint,
                                            save_checkpoint)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _tiny(cfg, feat_extractor="emb_cnn", feat="spectrogram"):
    m = cfg.model
    m.feat_extractor = feat_extractor
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 64, 32
    cfg.audio.feat = feat
    t = cfg.train
    t.k_train = t.k_valid = 2
    t.lr, t.meta_lr = 1e-2, 1e-3
    cfg.data.src_bucket_frames, cfg.data.tgt_bucket_len = (64,), (16,)
    return cfg.finalize()


def _perturbed(variables, seed):
    """The model's variables with BatchNorm scales, biases and running
    statistics moved off their initial values, so each of them counts."""
    rng = np.random.RandomState(seed)
    v = jax.tree.map(np.asarray, variables)
    for i in range(2):
        bn = v["params"]["conv"]["conv"][f"BatchNorm_{i}"]
        bn["scale"] = (1 + 0.2 * rng.randn(*bn["scale"].shape)).astype(
            np.float32)
        bn["bias"] = (0.1 * rng.randn(*bn["bias"].shape)).astype(np.float32)
        st = v["batch_stats"]["conv"]["conv"][f"BatchNorm_{i}"]
        st["mean"] = (0.3 * rng.randn(*st["mean"].shape)).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tmp dir, manifests, labels, JAX cfg, port cfg, JAX vocab, port
    vocab, JAX model, perturbed variables, support [K=2], query)."""
    tmp = tmp_path_factory.mktemp("embcnn")
    manifests, labels = make_synthetic_corpus(
        str(tmp / "corpus"), num_tasks=2, utts_per_task=5, max_sec=0.5,
        max_chars=6, seed=4)
    jcfg = _tiny(JaxConfig())
    jcfg.data.train_manifest_list, jcfg.data.labels_path = manifests, labels
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    jvocab, vocab = JaxVocab.from_json(labels), Vocab.from_json(labels)
    ds = JaxDataset(jvocab, jcfg, manifests, is_train=True, seed=1)
    support, query = ds.sample_meta_batch(2, 2)
    model = jax_build_model(jcfg, len(jvocab))
    feats, lengths = jax_steps.prepare_features(
        jax.tree.map(lambda x: jnp.asarray(x[0]), support), jcfg)
    from mtl_tpu.ops.targets import make_teacher_forcing

    seq_in, _ = make_teacher_forcing(jnp.asarray(support["targets"][0]))
    variables = _perturbed(model.init(jax.random.PRNGKey(5), feats, lengths,
                                      seq_in), 6)
    return (tmp, manifests, labels, jcfg, cfg, jvocab, vocab, model,
            variables, support, query)


def _port_model(cfg, vocab, variables):
    model = build_model(cfg, len(vocab))
    model.load_state_dict(flax_params_to_torch(variables))
    return model


def _stats(fx):
    """The running statistics of a port ``FeatureExtractor``."""
    return [t.detach().clone() for pair in fx.batch_stats() for t in pair]


def _jax_stats(variables):
    bs = variables["batch_stats"]["conv"]["conv"]
    return [np.asarray(bs[f"BatchNorm_{i}"][k]) for i in range(2)
            for k in ("mean", "var")]


def _assert_params(model, jax_params, atol=1e-5):
    sd = flax_params_to_torch(jax.tree.map(np.asarray, jax_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), sd[name].numpy(),
                                   atol=atol, rtol=1e-5, err_msg=name)


# -- the log-mel filterbank ----------------------------------------------

@pytest.mark.parametrize("normalize", [True, False])
def test_log_fbank_matches_jax_and_the_oracle(normalize):
    rng = np.random.RandomState(0)
    audio = (rng.randn(3, 6000) * 0.3).astype(np.float32)
    lengths = np.array([6000, 3700, 390], np.int32)
    got, frames = log_fbank(torch.from_numpy(audio),
                            torch.from_numpy(lengths), normalize=normalize)
    want, want_frames = jax_log_fbank(jnp.asarray(audio),
                                      jnp.asarray(lengths),
                                      normalize=normalize)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(want_frames))
    assert got.shape == (3, 36, 80)
    # log values down to log(f32 eps) = -15.9: relative to their size
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if not normalize:
        for i in range(3):
            oracle = log_fbank_oracle(audio[i, :lengths[i]])
            np.testing.assert_allclose(got[i, :len(oracle)].numpy(), oracle,
                                       rtol=1e-4, atol=1e-4)


# -- emb_cnn with BatchNorm ----------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_emb_cnn_forward_and_stats_match_flax(setup, train):
    _, _, _, jcfg, cfg, _, _, _, variables, support, _ = setup
    feats, _ = jax_steps.prepare_features(
        jax.tree.map(lambda x: jnp.asarray(x[0]), support), jcfg)
    conv_vars = {"params": variables["params"]["conv"],
                 "batch_stats": variables["batch_stats"]["conv"]}
    fx = JaxFeatureExtractor("emb_cnn", dtype=jnp.float32)
    if train:
        want, mutated = fx.apply(conv_vars, feats, train=True,
                                 mutable=["batch_stats"])
    else:
        want = fx.apply(conv_vars, feats, train=False)
    model = FeatureExtractor("emb_cnn", dtype=torch.float32)
    sd = {k[len("conv."):]: v for k, v in flax_params_to_torch(
        variables).items() if k.startswith("conv.")}
    model.load_state_dict(sd)
    before = _stats(model)
    stats_out = []
    got = model(torch.from_numpy(np.asarray(feats)), train, stats_out)
    assert got.shape == want.shape
    assert got.shape[-1] == subsampled_freq("emb_cnn", 161) * 32 == \
        jcfg.model.dim_input
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    # the forward reports; it never writes the buffers
    assert all(torch.equal(a, b) for a, b in zip(before, _stats(model)))
    if train:
        reported = [t for pair in stats_out for t in pair]
        for g, w in zip(reported, _jax_stats({"batch_stats": {
                "conv": mutated["batch_stats"]}})):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    else:
        assert stats_out == []


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables)
    return jax_steps.TrainState(step=jnp.zeros((), jnp.int32),
                                params=params, opt_state=tx.init(params))


def test_joint_step_merges_the_tasks_stats_as_jax(setup):
    """K = 2 joint step (nesterov SGD: Adam would turn the conv biases'
    gradients, zero up to rounding under a training-mode BatchNorm, into
    steps of +-lr): each task's forward starts from the same statistics;
    the buffers take the mean of the two results."""
    _, _, _, jcfg, cfg, _, vocab, jmodel, variables, support, _ = setup
    tx = optax.sgd(jcfg.train.lr, momentum=0.9, nesterov=True)
    jstate, jloss, _ = jax_steps.make_joint_step(jmodel, jcfg, tx)(
        _jax_state(variables, tx), jax.tree.map(jnp.asarray, support),
        jax.random.PRNGKey(0))
    model = _port_model(cfg, vocab, variables)
    opt = SGD(cfg.train.lr, 0.9, nesterov=True)
    state = init_train_state(model, opt)
    _, loss, _ = make_joint_step(model, cfg, opt)(
        state, batch_to_device(support, torch.device("cpu")))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for g, w in zip(_stats(model.conv), _jax_stats(jstate.params)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    _assert_params(model, jstate.params["params"])


def test_meta_step_keeps_the_query_stats_as_jax(setup):
    """K = 2 meta step: the support forwards' statistics are dropped, the
    buffers take the mean over the tasks of the query forwards' (each at
    its task's adapted weights). The outer update is plain SGD at
    meta_lr (see the joint step's case)."""
    _, _, _, jcfg, cfg, _, vocab, jmodel, variables, support, query = setup
    tx = optax.sgd(jcfg.train.meta_lr)
    jstate, m = jax_steps.make_meta_step(jmodel, jcfg, tx)(
        _jax_state(variables, tx), jax.tree.map(jnp.asarray, support),
        jax.tree.map(jnp.asarray, query), jax.random.PRNGKey(0))
    model = _port_model(cfg, vocab, variables)
    opt = SGD(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    dev = torch.device("cpu")
    _, metrics = make_meta_step(model, cfg, opt)(
        state, batch_to_device(support, dev), batch_to_device(query, dev))
    assert float(metrics["outer_loss"]) == pytest.approx(
        float(m["outer_loss"]), rel=1e-5)
    for g, w in zip(_stats(model.conv), _jax_stats(jstate.params)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    _assert_params(model, jstate.params["params"])


# -- CTC -------------------------------------------------------------------

def _ctc_batch():
    rng = np.random.RandomState(0)
    b, t, c, n = 4, 7, 9, 6
    logits = rng.randn(b, t, c).astype(np.float32)
    targets = rng.randint(1, c, (b, n)).astype(np.int32)
    tlens = np.array([6, 3, 0, 2])
    for i in range(b):
        targets[i, tlens[i]:] = 0
    # row 1: three repeats of one symbol in 3 frames cannot be aligned
    targets[1, :3] = 4
    return logits, targets, tlens, np.array([7, 3, 5, 1])


def test_ctc_loss_matches_optax_on_an_infeasible_row():
    logits, targets, tlens, in_lens = _ctc_batch()
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(in_lens),
                   torch.from_numpy(targets), torch.from_numpy(tlens))
    got.backward()

    def jax_loss(lg):
        return jax_ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(in_lens),
                            jnp.asarray(targets), jnp.asarray(tlens))

    want, jgrad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    assert np.isfinite(float(got.detach())) and float(got.detach()) > 1e4
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    grad, jgrad = x.grad.numpy(), np.asarray(jgrad)
    feasible = [0, 2]  # rows 1 and 3 need more frames than they have
    np.testing.assert_allclose(grad[feasible], jgrad[feasible], atol=1e-6)
    # an infeasible row's alphas sit near -1e5, where f32 resolves 2^-7:
    # its softmax weights carry ~1 % rounding in either package
    for r in (1, 3):
        np.testing.assert_allclose(grad[r], jgrad[r],
                                   atol=1e-2 * np.abs(jgrad[r]).max())
    # torch's own CTC has no finite log(0): the infeasible row is inf, so a
    # loss built on it would be zeroed whole by masked_loss_guard
    per_row = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                         torch.from_numpy(targets).long(),
                         torch.from_numpy(in_lens), torch.from_numpy(tlens),
                         blank=0, reduction="none")
    assert torch.isinf(per_row[1]) and torch.isfinite(per_row[0])


def _ctc_cfgs(setup):
    _, _, _, jcfg, cfg, *_ = setup
    jc = JaxConfig.from_json(jcfg.to_json())
    c = Config.from_dict(json.loads(cfg.to_json()))
    jc.train.loss = c.train.loss = "ctc"
    return jc, c


def test_ctc_epoch_step_with_nesterov_sgd_matches_jax(setup):
    """The epoch trainer's step under --loss ctc: K = 1, CTC of the
    decoder's logits, nesterov SGD at lr; params within 1e-5."""
    _, _, _, _, _, _, vocab, jmodel, variables, support, _ = setup
    jcfg, cfg = _ctc_cfgs(setup)
    batch = {k: v[:1] for k, v in support.items()}
    tx = jax_epoch_optimizer(jcfg)
    jstate, jloss, _ = jax_steps.make_joint_step(jmodel, jcfg, tx)(
        _jax_state(variables, tx), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    model = _port_model(cfg, vocab, variables)
    opt = make_epoch_optimizer(cfg)
    assert isinstance(opt, SGD) and opt.nesterov
    state = init_train_state(model, opt)
    _, loss, _ = make_joint_step(model, cfg, opt)(
        state, batch_to_device(batch, torch.device("cpu")))
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_params(model, jstate.params["params"])
    for g, w in zip(_stats(model.conv), _jax_stats(jstate.params)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def test_ctc_eval_step_row_losses_match_jax(setup):
    _, _, _, _, _, _, vocab, jmodel, variables, support, _ = setup
    jcfg, cfg = _ctc_cfgs(setup)
    batch = {k: v[1] for k, v in support.items()}
    jloss, jaux = jax_steps.make_eval_step(jmodel, jcfg)(
        jax.tree.map(jnp.asarray, variables),
        jax.tree.map(jnp.asarray, batch))
    model = _port_model(cfg, vocab, variables)
    loss, aux = make_eval_step(model, cfg)(
        batch_to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(aux["row_loss"].numpy(),
                               np.asarray(jaux["row_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(aux["row_tokens"].numpy(),
                                  np.asarray(jaux["row_tokens"]))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


# -- batch_stats through interop and checkpoints ------------------------

def test_batch_stats_round_trip_through_interop_and_a_resume(setup,
                                                            tmp_path):
    from mtl_tpu_torch.train.trainer import JointTrainer

    _, _, _, _, cfg, _, vocab, _, variables, _, _ = setup
    sd = flax_params_to_torch(variables)
    assert {"conv.bns.0.mean", "conv.bns.1.var"} <= set(sd)
    back = torch_to_flax_params(sd)
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax.tree.leaves(back[coll]),
                        jax.tree.leaves(variables[coll])):
            np.testing.assert_array_equal(a, b)
    cfg = Config.from_dict(json.loads(cfg.to_json()))
    cfg.save_folder, cfg.name = str(tmp_path), "resume"
    opt = Adam(cfg.train.lr)
    model = _port_model(cfg, vocab, variables)
    path = save_checkpoint(cfg, vocab, model.state_dict(), 3,
                           opt_state=opt.init(dict(model.named_parameters())))
    assert torch.equal(load_checkpoint(path)[2]["conv.bns.0.var"],
                       sd["conv.bns.0.var"])
    cfg.continue_from = path
    fresh = build_model(cfg, len(vocab))
    trainer = JointTrainer(fresh, cfg, vocab, torch.device("cpu"))
    state = trainer._build_state(opt)
    assert state.step == 3
    for g, w in zip(_stats(fresh.conv), _jax_stats(variables)):
        np.testing.assert_array_equal(g.numpy(), w)


# -- test_main -------------------------------------------------------------

def _report(out):
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("PRED:", "GOLD:", "TOTAL CER"))]
    return [re.sub(r" TIME: .*$", "", ln) for ln in lines]


@pytest.mark.parametrize("front_end", ["emb_cnn", "logfbank"])
def test_test_main_serves_as_jax(setup, front_end, monkeypatch, capsys):
    """Greedy serving of an emb_cnn checkpoint (running statistics in eval
    mode) and of a log-fbank vgg_cnn checkpoint."""
    tmp, manifests, labels, _, _, jvocab, vocab, jmodel, variables, \
        support, _ = setup
    monkeypatch.chdir(tmp)
    if front_end == "emb_cnn":
        jcfg = _tiny(JaxConfig())
    else:
        jcfg = _tiny(JaxConfig(), "vgg_cnn", "logfbank")
        assert jcfg.model.dim_input == 2560
        jmodel = jax_build_model(jcfg, len(jvocab))
        batch = jax.tree.map(lambda x: jnp.asarray(x[0]), support)
        feats, lengths = jax_steps.prepare_features(batch, jcfg)
        assert feats.shape[-1] == 80
        from mtl_tpu.ops.targets import make_teacher_forcing

        variables = jax.tree.map(np.asarray, jmodel.init(
            jax.random.PRNGKey(7), feats, lengths,
            make_teacher_forcing(batch["targets"])[0]))
    jcfg.name, jcfg.save_folder = f"jax_{front_end}", str(tmp / "serve")
    jax_path = jax_save_checkpoint(jcfg, jvocab, {"params": variables}, 0,
                                   best_model=True)
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    cfg.name = f"port_{front_end}"
    port_path = save_checkpoint(cfg, vocab, flax_params_to_torch(variables),
                                0, best_model=True)
    common = ["--test-manifest-list", manifests[-1], "--labels-path", labels,
              "--k-test", "2", "--src-buckets", "64", "--tgt-buckets", "16",
              "--tgt-max-len", "32"]
    jax_test_main(common + ["--name", "jt", "--continue-from", jax_path])
    want = _report(capsys.readouterr().out)
    result = port_test_main(common + ["--name", "pt", "--continue-from",
                                      port_path, "--device", "cpu"])
    got = _report(capsys.readouterr().out)
    assert result["utterances"] == 5
    assert sum(ln.startswith("PRED:") for ln in want) == 5
    assert got == want
    assert os.path.exists(os.path.join(port_path, "model.pt"))
