"""The port's second-order meta steps against the JAX package's, on the CPU.

``make_meta_step`` with ``--second-order`` differentiates through the
inner SGD step (mtl_tpu/train/steps.py:273-284, 354-380). The JAX steps
run jitted at tiny width, f32, dropout 0, inner lr 0.05 (as
tests/test_steps.py:116, so that the Hessian term is far above the
tolerance), on 13 frequency bins (``--window-size 0.0015``: n_fft 24) to
keep XLA's compile of the double backward short; the port's VGG stack then
runs its plain version on both sides, as the JAX package's XLA convs do.
Each compiled JAX step is built once, in a module fixture, and read by
every test that needs it. Outer gradients are held to 1e-5 of the largest
and losses to 1e-5 (f32, only the order of the sums differs), except the
weights of the first VGG block (``conv.convs.0``, ``conv.convs.1``), held to
1e-4 of the largest: without the inner clip the inner step takes the
weights far enough that a few of that block's ReLU and max-pool decisions
sit within f32 rounding of their kink, and the two packages' first-order
steps, already held to each other, part there by 2-4e-5 of the largest at
these inputs too (the second-order steps by 1.3-6.9e-5; every other
gradient by under 1.1e-6).

Also here: ``--remat`` with second order, the refusals of
``--copy-grad --second-order`` and of a discriminator head with
``--second-order``, the VGG stack's double-backward guard, and the two
``meta_transfer_train_main``s with ``--second-order --remat`` from one
step-0 state.
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
from mtl_tpu.models.transformer import build_model as jax_build_model
from mtl_tpu.train.steps import TrainState as JaxTrainState
from mtl_tpu.train.steps import make_meta_step as jax_make_meta_step
from mtl_tpu_torch.config import Config
from mtl_tpu_torch.interop import flax_params_to_torch
from mtl_tpu_torch.models.transformer import build_model
from mtl_tpu_torch.train.optim import Adam
from mtl_tpu_torch.train.steps import init_train_state, make_meta_step
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB, NFREQ, FRAMES = 12, 13, 32


def _jax_cfg(encoder="transformer", clip=False, remat=False, dropout=0.0,
             second_order=True):
    cfg = JaxConfig()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", dropout
    m.src_max_len, m.tgt_max_len = 64, 32
    m.encoder_type, m.remat = encoder, remat
    cfg.audio.window_size = 0.0015  # n_fft 24: 13 bins
    t = cfg.train
    t.lr, t.meta_lr, t.second_order = 0.05, 1e-3, second_order
    t.clip, t.max_norm = clip, 0.5
    cfg.finalize()
    assert cfg.audio.num_freq == NFREQ
    return cfg


def _port_cfg(jcfg):
    return Config.from_dict(json.loads(jcfg.to_json()))


def _feature_batches(seed, k):
    """k task batches of 2 precomputed feature rows (one padded to 24 of 32
    frames) with 6-id targets, as numpy with a leading task axis."""
    rng = np.random.RandomState(seed)
    return {"features": (rng.randn(k, 2, FRAMES, NFREQ) * 0.5).astype(
                np.float32),
            "input_lengths": np.tile(np.array([FRAMES, 24], np.int32),
                                     (k, 1)),
            "targets": rng.randint(3, VOCAB, (k, 2, 6)).astype(np.int32),
            "src_percentages": np.ones((k, 2), np.float32)}


def _params(jcfg, seed):
    """Flax weights with conv biases drawn nonzero (trained biases are not
    zero; at zero the padded frames' pre-activations cancel to rounding,
    tests/test_torch_port_train.py:_meta_params)."""
    model = jax_build_model(jcfg, VOCAB)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, FRAMES, NFREQ), jnp.float32),
                        jnp.array([FRAMES], jnp.int32),
                        jnp.zeros((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    for conv in params["params"]["conv"]["conv"].values():
        conv["bias"] = (rng.randn(*conv["bias"].shape) * 0.1).astype(
            np.float32)
    return model, params


def _jax_recorder():
    """An optax transform whose state is the last gradient it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


class _Recorder:
    """The port's counterpart: keeps the outer gradients, moves nothing."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in grads.items()}
        return state


def _inputs(per_task_query):
    support = _feature_batches(1, 2)
    if per_task_query:
        query = _feature_batches(2, 2)
    else:
        query = {k: v[0] for k, v in _feature_batches(2, 1).items()}
    return support, query


# (encoder, per_task_query, clip) of the cases held against JAX
CASES = {
    "meta_transfer-noclip": ("transformer", False, False),
    "meta_transfer-clip": ("transformer", False, True),
    "maml-noclip": ("transformer", True, False),
    "maml-clip": ("transformer", True, True),
    "conformer-meta_transfer-clip": ("conformer", False, True),
}


@pytest.fixture(scope="module")
def jax_steps():
    """Each case's JAX second-order step, run once: {case: (flax params,
    outer gradients by port name, outer loss, support losses)}."""
    out = {}
    for case, (encoder, per_task, clip) in CASES.items():
        jcfg = _jax_cfg(encoder, clip)
        model, params = _params(jcfg, 3)
        rec = _jax_recorder()
        st = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=rec.init(params))
        step = jax_make_meta_step(model, jcfg, rec, per_task_query=per_task,
                                  scan_tasks=True)
        st, m = step(st, *_inputs(per_task), jax.random.PRNGKey(0))
        out[case] = (params, flax_params_to_torch(
            jax.tree.map(np.asarray, st.opt_state)), float(m["outer_loss"]),
            np.asarray(m["support_losses"]))
    return out


def _port_step(jcfg, params, per_task, remat=False, second_order=True):
    """The port's meta step from ``params``: (outer gradients, metrics,
    the model)."""
    cfg = _port_cfg(jcfg)
    cfg.model.remat, cfg.train.second_order = remat, second_order
    model = build_model(cfg, VOCAB)
    model.load_state_dict(flax_params_to_torch(params))
    rec = _Recorder()
    support, query = (
        {k: torch.from_numpy(v) for k, v in b.items()}
        for b in _inputs(per_task))
    _, m = make_meta_step(model, cfg, rec, per_task_query=per_task)(
        init_train_state(model, Adam(1.0)), support, query)
    return rec.grads, m, model


def _scale(grads):
    return max(float(g.abs().max()) for g in grads.values())


BLOCK1 = ("conv.convs.0.", "conv.convs.1.")


@pytest.mark.parametrize("case", list(CASES))
def test_second_order_meta_step_matches_jax(jax_steps, case):
    """Outer gradients within 1e-5 of the largest (the first VGG block's
    1e-4, see the module docstring); outer and support losses within
    1e-5."""
    encoder, per_task, clip = CASES[case]
    params, want, want_loss, want_support = jax_steps[case]
    got, m, _ = _port_step(_jax_cfg(encoder, clip), params, per_task)
    assert set(got) == set(want)
    scale = _scale(want)
    for k, g in want.items():
        tol = 1e-4 if k.startswith(BLOCK1) else 1e-5
        torch.testing.assert_close(got[k], g, rtol=0, atol=tol * scale,
                                   msg=k)
    np.testing.assert_allclose(float(m["outer_loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(m["support_losses"].numpy(), want_support,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["meta_transfer-noclip", "maml-clip"])
def test_second_order_is_not_first_order(jax_steps, case):
    """At inner lr 0.05 the Hessian term moves the outer gradients by far
    more than the tolerance above: the port's first-order step from the
    same weights and batches differs from its second-order step by over
    100 times it."""
    encoder, per_task, clip = CASES[case]
    params = jax_steps[case][0]
    jcfg = _jax_cfg(encoder, clip)
    so, _, _ = _port_step(jcfg, params, per_task)
    fo, _, _ = _port_step(jcfg, params, per_task, second_order=False)
    diff = max(float((so[k] - fo[k]).abs().max()) for k in so)
    assert diff > 100 * 1e-5 * _scale(so)


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_second_order_with_remat_equals_without(jax_steps, encoder):
    """--remat recomputes each encoder layer (block) inside the double
    backward and gives the same gradients and losses."""
    case = ("conformer-meta_transfer-clip" if encoder == "conformer"
            else "meta_transfer-clip")
    params = jax_steps[case][0]
    jcfg = _jax_cfg(encoder, clip=True)
    want, m0, _ = _port_step(jcfg, params, False)
    got, m1, model = _port_step(jcfg, params, False, remat=True)
    assert model.encoder.remat
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=0, atol=0, msg=k)
    assert torch.equal(m0["outer_loss"], m1["outer_loss"])


def test_copy_grad_with_second_order_raises_as_jax():
    jcfg = _jax_cfg()
    jcfg.train.copy_grad = True
    with pytest.raises(ValueError, match="contradicts --second-order"):
        jax_make_meta_step(jax_build_model(jcfg, VOCAB), jcfg,
                           optax.adam(1e-3))
    cfg = _port_cfg(jcfg)
    with pytest.raises(ValueError, match="contradicts --second-order"):
        make_meta_step(build_model(cfg, VOCAB), cfg, Adam(1e-3))


@pytest.mark.parametrize("head", ["adversarial", "multitask"])
def test_discriminator_with_second_order_raises_as_jax(head):
    from mtl_tpu.models.discriminator import Discriminator as JaxDisc
    from mtl_tpu.train.steps_disc import make_meta_step_disc as jax_disc_step
    from mtl_tpu_torch.models.discriminator import Discriminator
    from mtl_tpu_torch.train.steps_disc import make_meta_step_disc

    jcfg = _jax_cfg()
    setattr(jcfg.train, head, True)
    with pytest.raises(ValueError, match="not implemented for the "
                                         "adversarial/multitask"):
        jax_disc_step(jax_build_model(jcfg, VOCAB), JaxDisc(3), jcfg,
                      optax.adam(1e-3))
    cfg = _port_cfg(jcfg)
    with pytest.raises(ValueError, match="not implemented for the "
                                         "adversarial/multitask"):
        make_meta_step_disc(build_model(cfg, VOCAB), Discriminator(16, 3),
                            cfg, Adam(1e-3))


def test_vgg_stack_refuses_a_double_backward():
    """The stack's Function recomputes its plain version from detached
    inputs, so a create_graph backward through it would lose the second
    derivative; it raises instead. The plain version differentiates
    twice."""
    from mtl_tpu_torch.ops.vgg import vgg_stack, vgg_stack_plain

    rng = np.random.RandomState(0)
    shapes = [(3, 3, 1, 64), (64,), (3, 3, 64, 64), (64,),
              (3, 3, 64, 128), (128,), (3, 3, 128, 128), (128,)]
    w = [torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
         .requires_grad_(True) for s in shapes]
    x = torch.from_numpy(rng.randn(1, 8, 9).astype(np.float32))
    y = vgg_stack(x, w, out_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no double backward"):
        torch.autograd.grad(y.square().sum(), w, create_graph=True)
    y = vgg_stack_plain(x, w, out_dtype=torch.float32)
    g = torch.autograd.grad(y.square().sum(), w, create_graph=True)
    hv = torch.autograd.grad(sum((gi * gi).sum() for gi in g), w)
    assert all(float(h.abs().max()) > 0 for h in hv)


# -- the CLIs ---------------------------------------------------------------

def _train_lines(out):
    return [re.sub(r" TOTAL TIME:.*$", "", ln) for ln in out.splitlines()
            if ln.startswith("(Iteration")]


def test_cli_second_order_remat_train_lines_match_jax(tmp_path, monkeypatch):
    """Both ``meta_transfer_train_main``s continue one step-0 state (a JAX
    ``TrainState`` saved by the JAX package and moved into a port
    checkpoint through ``interop``) for 2 iterations with ``--second-order
    --remat``, read from the checkpoint's config as a resumed run reads
    it; their TRAIN lines agree to the printed digits."""
    from mtl_tpu.cli.asr import meta_transfer_train_main as jax_main
    from mtl_tpu.data.dataset import SpectrogramDataset as JaxDataset
    from mtl_tpu.data.synthetic import make_synthetic_corpus
    from mtl_tpu.data.vocab import Vocab as JaxVocab
    from mtl_tpu.train.steps import init_train_state as jax_init_state
    from mtl_tpu.utils.checkpoint import save_checkpoint as jax_save
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.interop import adam_state_from_optax
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)  # both CLIs write log/<name>.log
    manifests, labels = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_tasks=3, utts_per_task=6, max_sec=0.4,
        max_chars=5, seed=7)
    cfg = _jax_cfg(clip=True, remat=True)
    cfg.train.k_train = cfg.train.k_valid = 2
    cfg.train.evaluate_every = cfg.train.save_every = 10
    cfg.data.train_manifest_list, cfg.data.labels_path = manifests, labels
    cfg.data.src_bucket_frames, cfg.data.tgt_bucket_len = (64,), (16,)
    cfg.name, cfg.save_folder = "init", str(tmp_path / "models")
    vocab = JaxVocab.from_json(labels)
    example, _ = JaxDataset(vocab, cfg, manifests, is_train=True,
                            seed=0).sample_meta_batch(2, 2)
    tx = optax.adam(cfg.train.meta_lr)
    state = jax_init_state(jax_build_model(cfg, len(vocab)), cfg, tx,
                           jax.random.PRNGKey(3),
                           jax.tree.map(lambda x: jnp.asarray(x[0]), example))
    jax_path = jax_save(cfg, vocab, state, 0)
    port_cfg = _port_cfg(cfg)
    port_cfg.name = "init_port"
    adam = jax.tree.map(np.asarray, state.opt_state[0])
    port_path = save_checkpoint(
        port_cfg, Vocab.from_dict(vocab.to_dict()),
        flax_params_to_torch(jax.tree.map(np.asarray, state.params)), 0,
        opt_state=adam_state_from_optax(adam.mu, adam.nu, adam.count))

    common = ["--train-manifest-list", *manifests, "--valid-manifest-list",
              manifests[-1], "--labels-path", labels, "--src-buckets", "64",
              "--tgt-buckets", "16", "--epochs", "2"]
    outs = []
    for main, extra in ((jax_main, ["--name", "jax_so", "--continue-from",
                                    jax_path]),
                        (meta_transfer_train_main,
                         ["--name", "port_so", "--continue-from", port_path,
                          "--device", "cpu"])):
        buf = StringIO()
        with redirect_stdout(buf):
            main(common + extra)
        outs.append(buf.getvalue())
    want, got = (_train_lines(o) for o in outs)
    assert len(want) == 2 and "RESTORED STATE" in outs[1]
    assert got == want
    saved = json.load(open(os.path.join(port_path, "meta.json")))
    assert saved["config"]["train"]["second_order"]
    assert saved["config"]["model"]["remat"]
