"""The port's LM training (``mtl_tpu_torch/lm/train.py`` steps and the
four training mains of ``cli/lm.py``) against the JAX package's, on the
CPU.

One Flax ``RNNLM`` param tree (``init``, then moved by seeded numpy noise of
scale 0.1 so that every bias is nonzero) goes into the port through
``mtl_tpu_torch.interop.lm_params_to_torch``; token windows come from three
chained synthetic word corpora. Both sides run f32 with dropout 0, at lr 20
and clip 0.25 (``lm_parser``'s defaults). Tolerances: losses 1e-5 relative
(f32, summation order only); parameters after the steps 1e-5 * max(1, lr)
absolute, since an update moves a weight by up to lr times its clipped
gradient. The mains print the JAX mains' lines: time fields masked, every
other printed number within one unit of its last printed digit or within
the losses' 1e-5 relative (a loss printed to six decimals carries f32
rounding there, and a perplexity exp(loss) magnifies it).
"""

import contextlib
import io
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtl_tpu.cli import lm as jax_cli
from mtl_tpu.data.synthetic import make_synthetic_lm_corpus
from mtl_tpu.lm import train as jax_train
from mtl_tpu.lm.model import RNNLM as JaxLM
from mtl_tpu_torch.cli import lm as port_cli
from mtl_tpu_torch.interop import lm_params_to_torch
from mtl_tpu_torch.lm import train as port_train
from mtl_tpu_torch.lm.data import Corpus, LMDataset, batchify, get_batch
from mtl_tpu_torch.lm.model import RNNLM
from tests.torch_threads import one_torch_thread  # noqa: F401

LR, CLIP, BPTT, BATCH, FACTOR = 20.0, 0.25, 5, 3, 3.0
RATIOS = port_train.joint_ratios(3, 0.8)


def _arch(rnn_type, ntoken):
    return {"rnn_type": rnn_type, "ntoken": ntoken, "ninp": 8, "nhid": 8,
            "nlayers": 2, "dropout": 0.0, "tie_weights": False}


def _models(rnn_type, ntoken, cell_loop=False, seed=0):
    jm = JaxLM(rnn_type, ntoken, 8, 8, 2, 0.0, False)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32),
        jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 1), jnp.int32)))
    model = RNNLM(rnn_type, ntoken, 8, 8, 2, 0.0, False, cell_loop=cell_loop)
    model.load_state_dict(lm_params_to_torch(params, _arch(rnn_type,
                                                           ntoken)))
    return jm, params, model


def _assert_params(model, params, rnn_type):
    want = lm_params_to_torch(params, _arch(rnn_type, model.ntoken))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0,
                                   atol=1e-5 * max(1.0, LR), msg=k)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(task dirs, chained corpora, LMDataset over their train streams)."""
    root = str(tmp_path_factory.mktemp("lm_train"))
    tasks = make_synthetic_lm_corpus(root, num_tasks=3, sentences_per_task=40,
                                     seed=5)
    chained, dictionary = [], None
    for t in tasks:
        c = Corpus(f"{t}/train.txt", f"{t}/valid.txt", f"{t}/test.txt",
                   dictionary)
        dictionary = c.dictionary
        chained.append(c)
    ds = LMDataset([c.train for c in chained], BPTT, BATCH)
    return tasks, chained, ds


KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_sgd_steps_carry_the_state_like_jax(corpora, rnn_type):
    """Three bptt windows of one epoch, the carry passed on detached."""
    _, chained, _ = corpora
    n = len(chained[-1].dictionary)
    jm, params, model = _models(rnn_type, n)
    jstep = jax_train.make_lm_sgd_step(jm, CLIP)
    pstep = port_train.make_lm_sgd_step(model, CLIP)
    source = batchify(chained[-1].train, BATCH)
    jcarry = jm.apply(params, BATCH, method="init_carry")
    pcarry = model.init_carry(BATCH)
    for w in range(3):
        data, target = get_batch(source, w * BPTT, BPTT)
        params, jloss, jcarry = jstep(params, data, target, LR, KEY, jcarry)
        loss, pcarry = pstep(data, target, LR, None, pcarry)
        assert not any(t.requires_grad for c in pcarry for t in c)
        assert math.isclose(float(loss), float(jloss), rel_tol=1e-5)
    _assert_params(model, params, rnn_type)


def _windows(ds, it):
    samples = [ds.sample(i, it) for i in range(3)]
    return (np.stack([s[0] for s in samples]),
            np.stack([s[1] for s in samples]), *ds.sample(-1, it)[2:])


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_joint_steps_match_jax(corpora, rnn_type):
    _, chained, ds = corpora
    jm, params, model = _models(rnn_type, len(chained[-1].dictionary))
    jstep = jax_train.make_lm_joint_step(jm, CLIP, RATIOS)
    pstep = port_train.make_lm_joint_step(model, CLIP, RATIOS)
    for it in range(2):
        datas, targets, _, _ = _windows(ds, it)
        params, jtotal, jlosses = jstep(params, datas, targets, LR, KEY)
        total, losses = pstep(datas, targets, LR, None)
        assert math.isclose(float(total), float(jtotal), rel_tol=1e-5)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-5)
    _assert_params(model, params, rnn_type)


@pytest.mark.parametrize("second_order", [False, True],
                         ids=["first_order", "second_order"])
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_meta_steps_match_jax(corpora, rnn_type, second_order):
    """Two meta iterations; second order runs the port's cell loop."""
    _, chained, ds = corpora
    jm, params, model = _models(rnn_type, len(chained[-1].dictionary),
                                cell_loop=second_order)
    jstep = jax_train.make_lm_meta_step(jm, CLIP, RATIOS, FACTOR,
                                        second_order=second_order)
    pstep = port_train.make_lm_meta_step(model, CLIP, RATIOS, FACTOR,
                                         second_order=second_order)
    for it in range(2):
        datas, targets, q_data, q_target = _windows(ds, it)
        params, jtotal, jq = jstep(params, datas, targets, q_data, q_target,
                                   LR, KEY)
        total, q_losses = pstep(datas, targets, q_data, q_target, LR, None)
        assert math.isclose(float(total), float(jtotal), rel_tol=1e-5)
        np.testing.assert_allclose(q_losses.numpy(), np.asarray(jq),
                                   rtol=1e-5)
    _assert_params(model, params, rnn_type)


def test_second_order_needs_the_cell_loop():
    with pytest.raises(ValueError, match="cell_loop"):
        port_train.make_lm_meta_step(RNNLM("LSTM", 10, 4, 4, 1), CLIP,
                                     [1.0], FACTOR, second_order=True)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU", "RNN_TANH", "RNN_RELU"])
def test_cell_loop_equals_the_library_recurrence(rnn_type):
    """The second-order route's forward and gradients equal the library
    call's, with a carry in and out (f32, summation order only)."""
    torch.manual_seed(0)
    lib = RNNLM(rnn_type, 30, 6, 7, 2, 0.0, False)
    with torch.no_grad():
        for p in lib.parameters():
            p.normal_(0.0, 0.3)
    loop = RNNLM(rnn_type, 30, 6, 7, 2, 0.0, False, cell_loop=True)
    loop.load_state_dict(lib.state_dict())
    tokens = torch.randint(0, 30, (9, 4))
    carry = [tuple(torch.randn(1, 4, 7) for _ in c) if isinstance(c, tuple)
             else torch.randn(1, 4, 7) for c in lib.init_carry(4)]
    outs = []
    for m in (lib.train(), loop.train()):
        logits, new = m(tokens, carry)
        grads = torch.autograd.grad(logits.square().mean(),
                                    list(m.parameters()))
        flat = [t for c in new for t in (c if isinstance(c, tuple) else [c])]
        outs.append([logits, *flat, *grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# -- the four training mains -------------------------------------------------

TIME = re.compile(r"(time: *\S+s|ms/batch +\S+)")
NUM = re.compile(r"-?\d+\.\d+|-?\d+")


def _same_line(got, want):
    """Equal text; each number within one unit of its last printed digit
    or 1e-5 relative."""
    g, w = TIME.sub("", got), TIME.sub("", want)
    assert NUM.sub("#", g) == NUM.sub("#", w), (got, want)
    for a, b in zip(NUM.findall(g), NUM.findall(w)):
        ulp = 10.0 ** -len(b.split(".")[1]) if "." in b else 1.0
        assert abs(float(a) - float(b)) <= max(ulp * 1.0001,
                                               1e-5 * abs(float(b))), \
            (got, want)


def _run(main, argv, cwd):
    os.makedirs(cwd, exist_ok=True)
    buf = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        main(argv)
    return [ln for ln in buf.getvalue().splitlines() if ln.strip()]


@pytest.fixture(scope="module")
def mains(corpora, tmp_path_factory):
    """Each of the four mains run by both packages on the chained corpora
    (finetune from each side's meta-transfer checkpoint); the port's init
    draws the JAX init's weights. Returns {main: (JAX lines, port
    lines)}."""
    tasks, _, _ = corpora
    root = tmp_path_factory.mktemp("lm_mains")
    mp = pytest.MonkeyPatch()

    def jax_init(model, generator):
        jm = JaxLM(model.rnn_type, model.ntoken, model.embed.embedding_dim,
                   model.nhid, len(model.rnns), 0.0, model.tie_weights)
        params = jm.init(jax.random.PRNGKey(1111),
                         jnp.zeros((2, 1), jnp.int32))
        model.load_state_dict(lm_params_to_torch(
            params, _arch(model.rnn_type, model.ntoken)))

    mp.setattr(port_cli, "init_lm_weights", jax_init)
    width = ["--emsize", "8", "--nhid", "8", "--bptt", str(BPTT),
             "--batch_size", str(BATCH), "--dropout", "0", "--seed", "1111"]
    last = [f"--{s}_path" for s in ("train", "valid", "test")]

    def lists(*splits):
        return [a for s in splits for a in
                [f"--{s}-path-list"] + [f"{t}/{s}.txt" for t in tasks]]

    # each JAX evaluation compiles anew, so the test sets (the per-valid
    # test lines and the end-of-training report) run in one main only
    iters = ["--num-iterations", "6", "--log-interval", "2"]
    runs = {
        "main_main": width + ["--epochs", "2"] + [
            a for f, s in zip(last, ("train", "valid", "test"))
            for a in (f, f"{tasks[-1]}/{s}.txt")],
        "main_joint_main": width + lists("train", "valid") + iters + [
            "--valid-interval", "3"],
        "main_meta_transfer_main": width + lists("train", "valid", "test")
        + iters + ["--valid-interval", "6"],
    }
    out = {}
    try:
        for name, argv in runs.items():
            out[name] = (
                _run(getattr(jax_cli, name), argv, root / "jax"),
                _run(getattr(port_cli, name), argv + ["--device", "cpu"],
                     root / "port"))
        meta = [ln.split()[-1] for ln in out["main_meta_transfer_main"][0]
                if ln.startswith("SAVED")][0]
        argv = width + ["--epochs", "2", "--load", meta,
                        "--train_path", f"{tasks[-1]}/train.txt",
                        "--valid_path", f"{tasks[-1]}/valid.txt"]
        out["finetune_main"] = (
            _run(jax_cli.finetune_main, argv, root / "jax"),
            _run(port_cli.finetune_main, argv + ["--device", "cpu"],
                 root / "port"))
    finally:
        mp.undo()
    out["_root"] = root
    return out


@pytest.mark.parametrize("main", ["main_main", "main_joint_main",
                                  "main_meta_transfer_main",
                                  "finetune_main"])
def test_lm_training_mains_print_the_jax_lines(mains, main):
    want, got = mains[main]
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        _same_line(g, w)
    saved = got[-1].split()[-1]
    assert got[-1].startswith("SAVED ")
    for f in ("meta.json", "model.pt"):
        assert os.path.exists(os.path.join(mains["_root"], "port", saved, f))
