"""The port's E-Branchformer encoder (``mtl_tpu_torch/models/
ebranchformer.py``) on the CPU, against ``tests/plain_ebranchformer.py``,
a plain float32 model written from the equations with its relative
positions gathered by index.

At a small size (d 32, 4 heads, FFN 64, cgMLP 96, 2 blocks, gate kernel
31, merge kernel 7; one decoder layer), seeded random weights (every leaf,
LayerNorms and biases too, moved off its initial value) and uneven lengths:
the encoder takes 13-bin frames without the VGG front end, whose ReLUs
make an f32 gradient jump where a pre-activation within rounding of zero
takes the other sign in another order of sums (the front end is the
Transformer's and the Conformer's, held against JAX in their tests; the
CLI cases below run it):

* at f32 the encoder output, the teacher-forced logits and the loss agree
  to 1e-5 of the largest |value|, and every leaf's gradient to 1e-4 of the
  larger of its own and the median leaf's gradient norm. Both sides
  compute in f32 and differ only in the order of their sums (the gather
  against the rel-shift, einsum against matmul orders); a key's bias,
  whose gradient is zero but for round-off under the softmax, is judged
  against the median leaf;
* the port at bf16 fails those tolerances;
* at dropout 0.1 with one generator seed each, the port draws the plain
  model's masks in its order: the same loss and gradients within the f32
  tolerances, and the generators end in the same state;
* ``--remat`` keeps the loss, the gradients and the dropout stream; a
  second-order meta step runs (the unfolded depthwise convs);
* the sequence-parallel encode and tensor parallel refuse the encoder by
  name; a task mesh of two gloo ranks trains it as one process does;
* the CLI trains it (first-order meta step) and decodes it greedily;
* the benchmark's copy of the encoder (``benchmark/reference/encoders/
  e_branchformer.py``), taken up by its name alone, lays out the port's
  parameters at ``benchmark/configs/ebranchformer_l.json``, computes the
  plain model's encoder (dropout on), and counts the FLOPs of the
  equations.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mtl_tpu_torch.config import Config
from mtl_tpu_torch.models import ebranchformer
from mtl_tpu_torch.models.transformer import build_model, init_weights
from mtl_tpu_torch.ops.targets import make_teacher_forcing
from mtl_tpu_torch.train.losses import ce_loss
from tests.plain_ebranchformer import Plain
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
VOCAB, HEADS, BLOCKS = 20, 4, 2
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _cfg(dtype="float32", dropout=0.0, **extra):
    cfg = Config()
    m = cfg.model
    m.encoder_type = "e_branchformer"
    m.num_enc_layers, m.num_dec_layers, m.num_heads = BLOCKS, 1, HEADS
    m.dim_model = m.dim_emb = 32
    m.dim_key = m.dim_value = 8
    m.dim_inner, m.r = 64, 8
    m.linear_units, m.cgmlp_linear_units = 64, 96
    m.cgmlp_conv_kernel, m.merge_conv_kernel = 31, 7
    m.dtype, m.dropout = dtype, dropout
    m.src_max_len, m.tgt_max_len = 64, 32
    m.feat_extractor, m.dim_input = "none", 13
    for k, v in extra.items():
        setattr(m, k, v)
    return cfg.finalize()


def _model(cfg):
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _batch(seed=2):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(3, 20, 13).astype(np.float32))
    lengths = torch.tensor([20, 13, 17])
    targets = torch.from_numpy(rng.randint(3, VOCAB, (3, 6)))
    targets[1, 3:] = 0
    return feats, lengths, targets


def _port_run(model, gen=None):
    feats, lengths, targets = _batch()
    seq_in, seq_out = make_teacher_forcing(targets)
    logits, enc = model(feats, lengths, seq_in, deterministic=gen is None,
                        generator=gen, return_encoder=True)
    loss, _ = ce_loss(logits, seq_out)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    return enc.float(), logits, loss, dict(zip(names, grads))


def _plain_run(model, dropout=0.0, gen=None):
    feats, lengths, targets = _batch()
    seq_in, seq_out = make_teacher_forcing(targets)
    W = {n: p.detach().float().clone().requires_grad_(True)
         for n, p in model.named_parameters()}
    plain = Plain(W, HEADS, BLOCKS, 1, dropout, gen)
    enc, logits = plain.forward(feats, lengths, seq_in)
    loss = plain.loss(logits, seq_out)
    grads = torch.autograd.grad(loss, list(W.values()))
    return enc, logits, loss, dict(zip(W, grads))


def _gaps(got, want):
    """(output gaps over the largest |value|: encoder, logits, loss;
    the worst leaf's gradient gap over the larger of its norm and the
    median leaf's)."""
    out = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip((t.detach() for t in got[:3]),
                           (t.detach() for t in want[:3]))]
    norms = {n: float(g.norm()) for n, g in want[3].items()}
    med = float(np.median(list(norms.values())))
    grad = max(float((got[3][n] - g).norm()) / max(norms[n], med)
               for n, g in want[3].items())
    return out, grad


def test_rel_shift_is_an_index_gather():
    t, n = 7, 13
    x = torch.randn(2, 3, t, n)
    i = torch.arange(t)
    want = x[:, :, i[:, None], (t - 1) - (i[:, None] - i[None, :])]
    assert torch.equal(ebranchformer.rel_shift(x), want)


def test_rel_positions_equal_the_plain_table():
    got = ebranchformer.device_rel_positions(9, 32, torch.device("cpu"))
    assert got.shape == (17, 32) and got.dtype == torch.float32
    torch.testing.assert_close(got, Plain.rel_table(9, 32), rtol=0,
                               atol=1e-7)
    # the row of r = 0 is sin 0, cos 0 interleaved
    assert torch.equal(got[8], torch.tensor([0.0, 1.0] * 16))


def test_f32_port_matches_the_plain_model():
    model = _model(_cfg())
    (enc, logits, loss), grad = _gaps(_port_run(model), _plain_run(model))
    assert max(enc, logits, loss) <= OUT_TOL, (enc, logits, loss)
    assert grad <= GRAD_TOL, grad
    # the pad mask: the padded frames are zero
    enc = _port_run(model)[0]
    assert bool((enc[1, 13:] == 0).all() and (enc[2, 17:] == 0).all())
    assert bool((enc[1, :13] != 0).any(-1).all())


def test_bf16_port_fails_the_tolerances():
    f32 = _model(_cfg())
    bf16 = build_model(_cfg("bfloat16"), VOCAB)
    bf16.load_state_dict(f32.state_dict())
    (enc, logits, loss), grad = _gaps(_port_run(bf16), _plain_run(f32))
    assert max(enc, logits, loss) > OUT_TOL and grad > GRAD_TOL, \
        (enc, logits, loss, grad)


def test_dropout_draws_the_plain_models_masks_in_order():
    model = _model(_cfg(dropout=0.1))
    g_port = torch.Generator().manual_seed(7)
    g_plain = torch.Generator().manual_seed(7)
    got = _port_run(model, g_port)
    want = _plain_run(model, 0.1, g_plain)
    (enc, logits, loss), grad = _gaps(got, want)
    assert max(enc, logits, loss) <= OUT_TOL and grad <= GRAD_TOL, \
        (enc, logits, loss, grad)
    assert torch.equal(g_port.get_state(), g_plain.get_state())
    # and the masks were drawn: without them the loss moves
    assert abs(float(got[2].detach() - _port_run(model)[2].detach())) > 1e-3


def test_remat_keeps_loss_gradients_and_dropout_stream():
    runs = []
    for remat in (False, True):
        model = _model(_cfg(dropout=0.1, remat=remat))
        gen = torch.Generator().manual_seed(5)
        _, _, loss, grads = _port_run(model, gen)
        runs.append((loss, grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)


def test_second_order_meta_step_runs():
    """One meta step through the inner SGD (the unfolded depthwise convs
    differentiated twice): finite metrics, every weight moved, and other
    weights than the first-order step's."""
    from mtl_tpu_torch.train.optim import Adam
    from mtl_tpu_torch.train.steps import init_train_state, make_meta_step

    feats, lengths, targets = _batch()
    support = {"features": torch.stack([feats[:2], feats[1:]]),
               "input_lengths": torch.stack([lengths[:2], lengths[1:]]),
               "targets": torch.stack([targets[:2], targets[1:]]),
               "src_percentages": torch.ones(2, 2)}
    query = {"features": feats[:2], "input_lengths": lengths[:2],
             "targets": targets[:2], "src_percentages": torch.ones(2)}
    after = {}
    for second in (False, True):
        cfg = _cfg()
        cfg.train.second_order, cfg.train.lr = second, 0.05
        model = _model(cfg)
        assert model.encoder.blocks[0].cgmlp.conv.unfolded == second
        opt = Adam(1e-3)
        state = init_train_state(model, opt)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        state, metrics = make_meta_step(model, cfg, opt)(state, support,
                                                         query)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        after[second] = {n: p.detach().clone()
                         for n, p in state.params.items()}
        moved = [n for n in before if not torch.equal(before[n],
                                                      after[second][n])]
        assert len(moved) > 0.9 * len(before)
    assert any(not torch.equal(after[False][n], after[True][n])
               for n in after[False])


# -- the paths that do not run it --------------------------------------------

def test_sequence_parallel_encode_refuses_it():
    from types import SimpleNamespace

    from mtl_tpu_torch.parallel import sp

    with pytest.raises(ValueError, match="e_branchformer"):
        sp.check_encoder("e_branchformer")
    sp.check_encoder("conformer")
    model = build_model(_cfg(), VOCAB)
    axis = SimpleNamespace(size=2, index=0)
    with pytest.raises(ValueError, match="e_branchformer"):
        sp.encode_sp(model, torch.zeros(1, 20, 13), torch.tensor([20]), axis)


def test_sequence_parallel_test_main_refuses_it_before_any_rank(tmp_path):
    from mtl_tpu_torch.cli.asr import test_main
    from mtl_tpu_torch.data.vocab import Vocab
    from mtl_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _cfg()
    cfg.name, cfg.save_folder = "eb", str(tmp_path)
    vocab = Vocab.from_labels(["_", " ", "a", "b"])
    model = build_model(cfg, len(vocab))
    path = save_checkpoint(cfg, vocab, model.state_dict(), 0,
                           best_model=True)
    with pytest.raises(ValueError, match="e_branchformer"):
        test_main(["--continue-from", path, "--test-manifest-list", "none",
                   "--labels-path", "none", "--mesh-model", "2", "--device",
                   "cpu"])


def test_tensor_parallel_refuses_it():
    from types import SimpleNamespace

    from mtl_tpu_torch.parallel import tp

    with pytest.raises(ValueError, match="e_branchformer"):
        tp.check_config(_cfg(), 2)
    model = build_model(_cfg(), VOCAB)
    with pytest.raises(ValueError, match="e_branchformer"):
        tp.shard_module(model, SimpleNamespace(size=2, index=0))
    # nothing was cut
    assert model.encoder.blocks[0].ff1.Dense_0.weight.shape == (64, 32)


# -- the entry points ----------------------------------------------------------

FLAGS = ["--encoder-type", "e_branchformer", "--num-enc-layers", "2",
         "--num-dec-layers", "1", "--num-heads", "2", "--dim-model", "16",
         "--dim-key", "8", "--dim-value", "8", "--dim-inner", "16",
         "--dim-emb", "16", "--linear-units", "32", "--cgmlp-linear-units",
         "48", "--merge-conv-kernel", "7", "--r", "4", "--dtype", "float32",
         "--window-size", "0.0015", "--src-max-len", "64", "--tgt-max-len",
         "32", "--src-buckets", "64", "--tgt-buckets", "16", "--device",
         "cpu", "--lr", "1e-2", "--meta-lr", "1e-3"]


def _corpus(tmp_path, tasks=3, utts=4):
    from mtl_tpu_torch.data.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(str(tmp_path / "corpus"), num_tasks=tasks,
                                 utts_per_task=utts, max_sec=0.4,
                                 max_chars=5, seed=8)


def _train_flags(manifests, labels, models):
    return ["--train-manifest-list", *manifests, "--valid-manifest-list",
            manifests[-1], "--labels-path", labels, "--k-train", "2",
            "--k-valid", "2", "--evaluate-every", "2", "--save-every", "2",
            "--save-folder", models, "--dropout", "0.0", *FLAGS]


def test_cli_trains_and_decodes_it(tmp_path, monkeypatch, capsys):
    """Two first-order meta steps through ``meta_transfer_train_main``
    (its checkpoint holds the E-Branchformer's leaves and its config),
    then greedy ``test_main`` from that checkpoint."""
    from mtl_tpu_torch.cli.asr import meta_transfer_train_main, test_main
    from mtl_tpu_torch.utils.checkpoint import load_checkpoint_meta

    monkeypatch.chdir(tmp_path)
    manifests, labels = _corpus(tmp_path)
    models = str(tmp_path / "models")
    state = meta_transfer_train_main(
        _train_flags(manifests, labels, models) + ["--epochs", "2",
                                                   "--name", "eb"])
    assert state.step == 2
    assert "encoder.blocks.1.attn.pos_bias_u" in state.params
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"TRAIN LOSS:\s*([0-9.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    ckpt = os.path.join(models, "eb", "step_2")
    saved = load_checkpoint_meta(ckpt)[0].model
    assert (saved.encoder_type, saved.linear_units, saved.cgmlp_linear_units,
            saved.merge_conv_kernel) == ("e_branchformer", 32, 48, 7)
    result = test_main(["--test-manifest-list", manifests[-1],
                        "--labels-path", labels, "--continue-from", ckpt,
                        "--k-test", "2", "--src-buckets", "64",
                        "--tgt-buckets", "16", "--device", "cpu", "--name",
                        "serve_eb"])
    assert result["utterances"] == 4
    assert "TOTAL CER" in capsys.readouterr().out


MESH_RUN = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from mtl_tpu_torch.cli.asr import meta_transfer_train_main
meta_transfer_train_main({argv!r})
"""
MESH_LIMIT_S = 240


def _train_subprocess(tmp_path, argv):
    proc = subprocess.Popen(
        [sys.executable, "-c", MESH_RUN.format(repo=REPO, argv=argv)],
        cwd=tmp_path, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=MESH_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the ranks too
        proc.communicate()
        pytest.fail(f"the run did not end within {MESH_LIMIT_S} s")
    assert proc.returncode == 0, err[-3000:]
    return [float(x) for x in re.findall(r"TRAIN LOSS:\s*([0-9.]+)", out)]


def test_task_mesh_of_two_gloo_ranks_trains_it_as_one_process(tmp_path):
    """A task mesh replicates the model, so it needs no refusal: one meta
    step over two gloo ranks (a task each) prints the TRAIN LOSS of the
    step in one process, to 1e-4 relative (f32; the all-reduce sums the
    tasks' gradients in another order)."""
    manifests, labels = _corpus(tmp_path, tasks=2)
    argv = _train_flags(manifests, labels, str(tmp_path / "models")) + [
        "--epochs", "1", "--evaluate-every", "5", "--save-every", "5"]
    start = time.monotonic()
    one = _train_subprocess(tmp_path, argv + ["--name", "one"])
    mesh = _train_subprocess(tmp_path, argv + ["--name", "mesh",
                                               "--mesh-task", "2"])
    print(f"one process and a 2-rank task mesh: {one} {mesh}, "
          f"{time.monotonic() - start:.1f} s")
    assert len(one) == len(mesh) == 1
    assert abs(mesh[0] - one[0]) <= 1e-4 * abs(one[0])


# -- the benchmark's copy -------------------------------------------------------

@pytest.fixture(scope="module")
def bench_modules():
    """The benchmark's ``reference`` and ``roofline``, imported from its
    folder (taken off the path again after)."""
    sys.path.insert(0, BENCH)
    try:
        import roofline
        from reference.encoders import load
        from reference.model import Reference
        from reference.params import param_shapes
        yield load, Reference, param_shapes, roofline
    finally:
        sys.path.remove(BENCH)


def _bench_config():
    with open(os.path.join(BENCH, "configs", "ebranchformer_l.json"),
              encoding="utf-8") as f:
        return json.load(f)


def test_benchmark_lays_out_the_ports_parameters(bench_modules):
    load, _, param_shapes, _ = bench_modules
    c = _bench_config()
    assert load(c["encoder_type"]).__file__ == os.path.join(
        BENCH, "reference", "encoders", "e_branchformer.py")
    cfg = Config()
    for key, value in c.items():
        for sec in (cfg.model, cfg.audio, cfg.train):
            if key in type(sec).__dataclass_fields__:
                setattr(sec, key, value)
    cfg.finalize()
    with torch.device("meta"):
        model = build_model(cfg, 4 + c["labels"])
    mine = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert mine == param_shapes(c, 4 + c["labels"])
    # a LayerNorm's leaves, and only those, are named "norm"
    norms = {n for n, m in model.named_modules()
             if isinstance(m, torch.nn.LayerNorm)}
    assert {n for n in mine if "norm" in n.lower()} == {
        f"{m}.{leaf}" for m in norms for leaf in ("weight", "bias")}
    assert sum(np.prod(s) for s in mine.values()) == 132954560


def test_benchmark_encoder_computes_the_plain_model(bench_modules):
    _, Reference, _, _ = bench_modules
    cfg = _cfg(dropout=0.1)
    model = _model(cfg)
    W = {n: p.detach().clone() for n, p in model.named_parameters()}
    c = {"encoder_type": "e_branchformer", "dropout": 0.1,
         "sample_rate": 16000, "window_size": 0.0015, "window_stride": 0.01,
         "num_heads": HEADS, "num_enc_layers": BLOCKS}
    ref = Reference(c, "cpu")
    feats, lengths, _ = _batch()
    plain = Plain(W, HEADS, BLOCKS, 1, 0.1, torch.Generator().manual_seed(3))
    x = feats  # the encoder input (the model has no front end)
    want = plain.encoder(x, lengths)
    got = ref.encoder.forward(ref, W, x, lengths,
                              torch.Generator().manual_seed(3))
    assert float((got - want).abs().max()) <= OUT_TOL * float(
        want.abs().max())


def test_benchmark_counts_the_equations_flops(bench_modules):
    _, _, _, roofline = bench_modules
    c = _bench_config()
    b, t = 8, 800
    tt, d_in = t // 4, 40 * 128
    d, lu, cu = 512, 1024, 3072
    per_frame = (2 * 2 * (d * lu + lu * d)  # the FFN halves
                 + 4 * 2 * d * d  # q, k, v, out
                 + 2 * d * cu + 2 * (cu // 2) * 31 + 2 * (cu // 2) * d  # cgMLP
                 + 2 * (2 * d) * 31 + 2 * (2 * d) * d)  # the merge
    per_block = (b * tt * per_frame + 2 * (2 * tt - 1) * d * d  # W_pos
                 + 3 * 2 * b * tt * tt * d)  # content, position, context
    want = 2 * b * tt * d_in * d + 17 * per_block
    assert roofline.encoder_flops(c, b, t) == want
