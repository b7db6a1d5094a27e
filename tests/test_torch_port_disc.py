"""The port's discriminator heads (``models/discriminator.py``, the
adversarial losses, ``train/steps_disc.py`` on the joint and meta steps,
the trainers' disc state and the ``--adversarial`` / ``--multitask`` entry
points) against the JAX package's, on the CPU.

Tiny width, f32, dropout 0, one shared weight set for the model and the
discriminator (Flax trees moved into the port by ``mtl_tpu_torch.interop``),
batches drawn by the JAX dataset from one synthetic 3-task corpus.
Tolerances: losses and logits rtol = atol = 1e-5 (f32, summation order
only); params after an update by SGD within 1e-4 of their move plus 3e-4
of the largest move (the gradients' tolerance, rtol 1e-4 with atol 3e-4 of
the largest, carried through a linear update); after Adam by the rule of
the meta-step test (tests/test_torch_port_train.py). The entry points print
the JAX entry points' lines (TOTAL TIME masked), each number within one
unit of its last printed digit or 1e-5 relative, the losses' tolerance: the
sum-pooled discriminator puts the multitask outer loss near 50, where four
decimals are 2e-6 relative and f32 summation order flips the last one.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtl_tpu.cli.asr import joint_train_main as jax_joint_train_main
from mtl_tpu.cli.asr import \
    meta_transfer_train_main as jax_meta_transfer_train_main
from mtl_tpu.config import Config as JaxConfig
from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
from mtl_tpu.data.synthetic import make_synthetic_corpus
from mtl_tpu.data.vocab import Vocab as JaxVocab
from mtl_tpu.models.discriminator import Discriminator as JaxDiscriminator
from mtl_tpu.ops.targets import make_teacher_forcing as jax_teacher_forcing
from mtl_tpu.train.losses import adversarial_losses as jax_adversarial_losses
from mtl_tpu.train.optim import make_joint_optimizer as jax_joint_optimizer
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.train.steps import prepare_features as jax_prepare_features
from mtl_tpu.train.steps_disc import DiscTrainState as JaxDiscTrainState
from mtl_tpu.train.steps_disc import _disc_optimizer as jax_disc_optimizer
from mtl_tpu.train.steps_disc import make_joint_step_disc as jax_joint_disc
from mtl_tpu.train.steps_disc import make_meta_step_disc as jax_meta_disc
from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mtl_tpu_torch.cli.asr import joint_train_main, meta_transfer_train_main
from mtl_tpu_torch.cli.asr import test_main as port_test_main
from mtl_tpu_torch.data.vocab import Vocab
from mtl_tpu_torch.interop import (adam_state_from_optax, disc_params_to_torch,
                                   flax_params_to_torch,
                                   torch_to_flax_disc_params)
from mtl_tpu_torch.models.discriminator import Discriminator
from mtl_tpu_torch.ops.targets import make_teacher_forcing
from mtl_tpu_torch.train.losses import adversarial_losses
from mtl_tpu_torch.train.optim import (SGD, Adam, AdamState,
                                       make_joint_optimizer)
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       prepare_features)
from mtl_tpu_torch.train.steps_disc import (DiscTrainState, init_disc_state,
                                            make_joint_step_disc,
                                            make_meta_step_disc)
from mtl_tpu_torch.train.trainer import JointTrainer
from mtl_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_port_joint import _lines, _params, _port_model, _tiny
from tests.test_torch_port_lm_train import _same_line
from tests.test_torch_port_maml import _port_cfg, assert_adam_params_close
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("disc_corpus"))
    manifests, labels = make_synthetic_corpus(root, num_tasks=3,
                                              utts_per_task=6, max_sec=0.5,
                                              max_chars=6, seed=13)
    return manifests, labels, JaxVocab.from_json(labels)


def _disc_params(jcfg, seed=3):
    """Flax discriminator params with a nonzero bias."""
    disc = JaxDiscriminator(jcfg.train.num_class)
    params = jax.tree.map(np.asarray, disc.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.model.dim_model))))
    params["params"]["Dense_0"]["bias"] = (np.random.RandomState(seed).randn(
        jcfg.train.num_class) * 0.1).astype(np.float32)
    return disc, params


def test_discriminator_and_losses_match_jax(corpus):
    """``forward_with_encoder`` (logits and the encoder output, its padded
    frames included), the discriminator over it (the sum over all frames)
    and both adversarial losses for each accent id; the interop of the
    discriminator's params round-trips exactly."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    jmodel, params = _params(jcfg, len(jvocab))
    jdisc, dparams = _disc_params(jcfg)
    batch = JaxDataset(jvocab, jcfg, manifests, is_train=True,
                       seed=2).sample_meta_batch(3, 1)[1]
    feats, lengths = jax_prepare_features(batch, jcfg)
    seq_in, _ = jax_teacher_forcing(batch["targets"])
    jlogits, jenc = jmodel.apply(params, feats, lengths, seq_in,
                                 method="forward_with_encoder")
    jd = jdisc.apply(dparams, jnp.sum(jenc.astype(jnp.float32), axis=1))

    model = _port_model(jcfg, len(jvocab), params)
    disc = Discriminator(jcfg.model.dim_model, jcfg.train.num_class)
    disc.load_state_dict(disc_params_to_torch(dparams))
    tb = batch_to_device(batch, CPU)
    pf, pl = prepare_features(tb, _port_cfg(jcfg))
    logits, enc = model.forward_with_encoder(
        pf, pl, make_teacher_forcing(tb["targets"])[0])
    assert bool((pl < enc.shape[1] * 4).any())  # padded frames are summed
    torch.testing.assert_close(logits, torch.from_numpy(np.asarray(jlogits)),
                               **TOL)
    torch.testing.assert_close(enc, torch.from_numpy(np.asarray(jenc)), **TOL)
    d = disc(enc)
    torch.testing.assert_close(d, torch.from_numpy(np.asarray(jd)), **TOL)
    for accent in range(jcfg.train.num_class):
        got = adversarial_losses(d, accent)
        want = jax_adversarial_losses(jd, accent)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), **TOL)
    back = torch_to_flax_disc_params(disc.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, dparams)


def _assert_sgd_close(got, before, want):
    """Params after a linear (SGD) update: within 1e-4 of their move plus
    3e-4 of the largest move."""
    moves = {k: (want[k] - before[k]).abs() for k in want}
    top = max(float(m.max()) for m in moves.values())
    for k, v in want.items():
        d = (got[k].detach() - v).abs()
        assert bool((d <= 1e-4 * moves[k] + 3e-4 * top + 1e-9).all()), k


def _jax_disc_state(jcfg, params, dparams, model_tx):
    """The JAX state at step 0: the model's params, a fresh optimizer, the
    discriminator's params and a fresh discriminator optimizer."""
    jdisc_tx = jax_disc_optimizer(jcfg)
    return JaxDiscTrainState(
        base=JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=model_tx.init(params)),
        disc_params=dparams, disc_opt_state=jdisc_tx.init(dparams))


def _port_disc_state(jcfg, model, dparams, opt):
    """(the port's state of the same, its discriminator)."""
    disc = Discriminator(jcfg.model.dim_model, jcfg.train.num_class)
    state = init_disc_state(disc, _port_cfg(jcfg),
                            init_train_state(model, opt))
    with torch.no_grad():
        for k, v in disc_params_to_torch(dparams).items():
            state.disc_params[k].copy_(v)
    return state, disc


@pytest.mark.parametrize("head,opt_name", [("adversarial", "adam"),
                                           ("multitask", "sgd")])
def test_joint_step_disc_matches_jax(corpus, head, opt_name):
    """One joint step with the head over 3 task batches (accent k for task
    k, beta 0.7, ``--clip`` at max_norm 0.5 on the model's gradients):
    the mean CE it returns, the disc and encoder losses, the model's params
    after Adam or nesterov SGD, and the discriminator's after Adam or
    plain SGD at ``lr_disc``."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    t = jcfg.train
    t.adversarial, t.multitask = head == "adversarial", head == "multitask"
    t.opt_name, t.clip, t.max_norm, t.lr_disc = opt_name, True, 0.5, 1e-2
    cfg = _port_cfg(jcfg)
    jmodel, params = _params(jcfg, len(jvocab))
    jdisc, dparams = _disc_params(jcfg)
    batch = JaxDataset(jvocab, jcfg, manifests, is_train=True,
                       seed=6).sample_meta_batch(2, 1)[0]
    tx = jax_joint_optimizer(jcfg)
    jstate, jce, jaux = jax_joint_disc(jmodel, jdisc, jcfg, tx)(
        _jax_disc_state(jcfg, params, dparams, tx), batch,
        jax.random.PRNGKey(0), jnp.asarray(0.7))

    model = _port_model(jcfg, len(jvocab), params)
    opt = make_joint_optimizer(cfg)
    state, disc = _port_disc_state(jcfg, model, dparams, opt)
    assert isinstance(state, DiscTrainState)
    state, ce, aux = make_joint_step_disc(model, disc, cfg, opt)(
        state, batch_to_device(batch, CPU), None, 0.7)
    np.testing.assert_allclose(float(ce), float(jce), **TOL)
    for key in ("ce", "disc_loss", "enc_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **TOL)
    np.testing.assert_array_equal(aux["gold"].numpy(),
                                  np.asarray(jaux["gold"]))
    assert state.step == 1
    if opt_name == "adam":
        assert_adam_params_close(state.params, jstate.base, t.lr, 1)
    else:
        _assert_sgd_close(state.params, flax_params_to_torch(params),
                          flax_params_to_torch(jax.tree.map(
                              np.asarray, jstate.base.params)))
    _assert_disc_close(state, jstate, dparams, opt_name, t.lr_disc)


def _assert_disc_close(state, jstate, dparams, opt_name, lr):
    want = disc_params_to_torch(jax.tree.map(np.asarray, jstate.disc_params))
    if opt_name == "sgd":
        assert state.disc_opt_state.trace is None  # plain SGD
        _assert_sgd_close(state.disc_params, disc_params_to_torch(dparams),
                          want)
        return
    assert state.disc_opt_state.count == 1
    for k, v in want.items():  # every entry's gradient is well above 0
        torch.testing.assert_close(state.disc_params[k].detach(), v,
                                   rtol=0, atol=1e-2 * lr)


@pytest.mark.parametrize("head,per_task,opt_name", [
    ("adversarial", True, "adam"), ("multitask", False, "sgd")],
    ids=["adversarial-maml-adam", "multitask-shared-sgd"])
def test_meta_step_disc_matches_jax(corpus, head, per_task, opt_name):
    """One first-order meta step with the head on each task's query loss
    (MAML's own queries with accent k, or the shared query with accent
    K - 1), beta 0.7, the inner and outer clip at max_norm 0.5: the
    augmented outer loss, query CE, disc and encoder losses, support
    losses, the model's params after outer Adam and the discriminator's
    after Adam or plain SGD."""
    manifests, _, jvocab = corpus
    jcfg = _tiny(JaxConfig())
    t = jcfg.train
    t.adversarial, t.multitask = head == "adversarial", head == "multitask"
    t.opt_name, t.clip, t.max_norm = opt_name, True, 0.5
    t.meta_lr, t.lr_disc = 1e-3, 1e-2
    cfg = _port_cfg(jcfg)
    jmodel, params = _params(jcfg, len(jvocab))
    jdisc, dparams = _disc_params(jcfg)
    sup, qry = JaxDataset(jvocab, jcfg, manifests, is_train=True,
                          seed=7).sample_meta_batch(
        2, 2, per_task_query=per_task)
    tx = optax.adam(t.meta_lr)
    jstate, mj = jax_meta_disc(jmodel, jdisc, jcfg, tx,
                               per_task_query=per_task)(
        _jax_disc_state(jcfg, params, dparams, tx), sup, qry,
        jax.random.PRNGKey(0), jnp.asarray(0.7))

    model = _port_model(jcfg, len(jvocab), params)
    opt = Adam(t.meta_lr)
    state, disc = _port_disc_state(jcfg, model, dparams, opt)
    state, m = make_meta_step_disc(model, disc, cfg, opt, per_task)(
        state, batch_to_device(sup, CPU), batch_to_device(qry, CPU), None,
        0.7)
    for key in ("outer_loss", "query_ce", "disc_loss", "enc_loss"):
        np.testing.assert_allclose(float(m[key]), float(mj[key]), **TOL)
    np.testing.assert_allclose(m["support_losses"].numpy(),
                               np.asarray(mj["support_losses"]), **TOL)
    assert state.step == 1
    assert_adam_params_close(state.params, jstate.base, t.meta_lr, 1)
    _assert_disc_close(state, jstate, dparams, opt_name, t.lr_disc)


def test_second_order_with_a_head_is_refused():
    cfg = _port_cfg(_tiny(JaxConfig()))
    cfg.train.adversarial = cfg.train.second_order = True
    with pytest.raises(ValueError, match="second-order"):
        make_meta_step_disc(None, None, cfg, Adam(1e-3))


def test_disc_trainer_restores_all_or_the_weights_alone(tmp_path):
    """A disc trainer restores step, optimizer and discriminator from a
    disc checkpoint; from a checkpoint without a discriminator, or whose
    discriminator's optimizer has another structure, the weights alone
    (the JAX trainers' params-only branch)."""
    jcfg = _tiny(JaxConfig())
    jcfg.train.adversarial = True
    cfg = _port_cfg(jcfg)
    cfg.save_folder = str(tmp_path)
    vocab = Vocab.from_labels(["_", "a", "b", " "])
    model = _port_model(jcfg, len(vocab), _params(jcfg, len(vocab))[1])
    weights = {k: v.clone() + 1.0 for k, v in model.state_dict().items()}
    disc = Discriminator(16, 3)
    src = init_disc_state(disc, cfg, init_train_state(model, Adam(0.1)))
    src.step, src.opt_state.count, src.disc_opt_state.count = 5, 5, 5
    dweights = {k: v.detach() + 2.0 for k, v in src.disc_params.items()}
    for name, kw in (
            ("disc", dict(disc=(dweights, src.disc_opt_state))),
            ("plain", {}),
            ("disc_sgd", dict(disc=(dweights, SGD(0.1).init(dweights))))):
        cfg.name = name
        save_checkpoint(cfg, vocab, weights, 5, opt_state=src.opt_state, **kw)
    for name in ("disc", "plain", "disc_sgd"):
        cfg.continue_from = os.path.join(str(tmp_path), name, "step_5")
        trainer = JointTrainer(model, cfg, vocab, CPU,
                               Discriminator(16, 3))
        with contextlib.redirect_stdout(io.StringIO()):
            state = trainer._build_state(Adam(0.1))
        for k, v in weights.items():
            torch.testing.assert_close(model.state_dict()[k], v)
        restored = name == "disc"
        assert state.step == (5 if restored else 0), name
        assert state.opt_state.count == (5 if restored else 0)
        assert state.disc_opt_state.count == (5 if restored else 0)
        assert isinstance(state.disc_opt_state, AdamState)
        same = all(torch.equal(state.disc_params[k], v)
                   for k, v in dweights.items())
        assert same == restored, name


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both packages' ``joint_train_main --adversarial --beta-decay`` and
    ``meta_transfer_train_main --multitask`` from step-0 checkpoints of
    one model and discriminator (the discriminator flags sit in each
    checkpoint's config, which a resumed run takes), 4 iterations each."""
    manifests, labels, jvocab = corpus
    tmp = tmp_path_factory.mktemp("disc_cli")
    jcfg = _tiny(JaxConfig())
    jcfg.train.meta_lr, jcfg.train.lr_disc = 1e-3, 1e-2
    jcfg.data.train_manifest_list, jcfg.data.labels_path = manifests, labels
    jcfg.save_folder = str(tmp / "models")
    _, params = _params(jcfg, len(jvocab))
    _, dparams = _disc_params(jcfg)
    vocab = Vocab.from_dict(jvocab.to_dict())
    common = ["--train-manifest-list", *manifests, "--valid-manifest-list",
              manifests[-1], "--labels-path", labels, "--src-buckets", "64",
              "--tgt-buckets", "16", "--epochs", "4"]
    out = {}
    with contextlib.chdir(tmp):  # the CLIs write log/<name>.log
        for key, flags, mains in (
                ("joint", ["--adversarial", "--beta-decay"],
                 (jax_joint_train_main, joint_train_main)),
                ("meta", ["--multitask"], (jax_meta_transfer_train_main,
                                           meta_transfer_train_main))):
            t = jcfg.train
            t.adversarial, t.beta_decay = key == "joint", key == "joint"
            t.multitask = key == "meta"
            lr = t.lr if key == "joint" else t.meta_lr
            st = _jax_disc_state(jcfg, params, dparams, optax.adam(lr))
            jcfg.name = f"init_{key}"
            pcfg = _port_cfg(jcfg)
            pcfg.name = f"init_{key}_port"
            adam = jax.tree.map(np.asarray, st.base.opt_state[0])
            dadam = jax.tree.map(np.asarray, st.disc_opt_state[0])
            paths = (jax_save_checkpoint(jcfg, jvocab, st, 0),
                     save_checkpoint(
                         pcfg, vocab, flax_params_to_torch(params), 0,
                         opt_state=adam_state_from_optax(adam.mu, adam.nu,
                                                         adam.count),
                         disc=(disc_params_to_torch(dparams), AdamState(
                             int(dadam.count), disc_params_to_torch(dadam.mu),
                             disc_params_to_torch(dadam.nu)))))
            for side, main, path in zip(("jax", "port"), mains, paths):
                argv = common + flags + ["--name", f"{key}_{side}",
                                         "--continue-from", path]
                if side == "port":
                    argv += ["--device", "cpu"]
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    state = main(argv)
                out[key, side] = (buf.getvalue(), state)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["test_main"] = port_test_main([
                "--device", "cpu", "--test-manifest-list", manifests[-1],
                "--labels-path", labels, "--k-test", "2", "--continue-from",
                str(tmp / "models" / "joint_port" / "best_model")])
    return out


@pytest.mark.parametrize("key", ["joint", "meta"])
def test_disc_entry_points_print_the_jax_lines(runs, key):
    """The TRAIN lines (joint: the mean CE; meta: the augmented outer
    loss) and the VALID lines agree; the port's state holds the
    discriminator, restored from the checkpoint and trained 4 steps."""
    (want, _), (got, state) = runs[key, "jax"], runs[key, "port"]
    want, got = _lines(want), _lines(got)
    assert sum("TRAIN LOSS" in ln for ln in want) == 4
    assert sum("AVG VALID" in ln for ln in want) == 2
    assert want[0].startswith("RESTORED STATE")
    assert got[0].startswith("RESTORED STATE")
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        _same_line(g, w)
    assert isinstance(state, DiscTrainState)
    assert state.step == 4 and state.disc_opt_state.count == 4


def test_disc_checkpoint_serves_in_test_main(runs):
    """``model.pt`` of a disc-trained checkpoint holds the ASR weights
    alone: the port's ``test_main`` serves it unchanged."""
    assert runs["test_main"]["utterances"] == 6
