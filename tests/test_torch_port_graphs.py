"""The graph-replayed meta step (``mtl_tpu_torch/train/graphs.py``) on the
CPU, where no CUDA graph exists: what decides that a trainer takes it, the
shape key of a batch, and its policy through a stand-in graph.

* ``graphs_engage``: a CUDA device with no mesh, first order, no
  discriminator head and no remat; the CPU, a mesh, second order, a head,
  ``--remat`` and ``--remat-conv`` keep the eager step. The meta trainers on
  the CPU return the eager step and never make a graph.
* ``step_key``: (K, support batch, query batch, time, labels) of a host
  batch, for the shared and the per-task query, audio or features.
* The policy, through ``RerunGraph``, which runs the step at its capture
  and again at each later replay, into the outputs of the capture: over
  the keys A, A, B, B, A, C, B the first sighting of each key runs
  eagerly, the second captures and replays, later ones replay (B's last
  after C's eager step), and C, seen once, is never captured. Every
  step's metrics (kept to the end, so an output handed out of the graphs'
  buffers would show), the weights, Adam's moments and count, the step
  counter, emb_cnn's running statistics and the dropout generator are
  bitwise those of the eager step run beside it on the same batches, for
  the shared query and for ``per_task_query``; 2 captures and 4 replays
  are counted in ``native.launch_counts``. A replay refuses another
  generator or another state than its capture's, and hands out copies of
  its graph's outputs, never the outputs themselves.
* What the captured step reads from the device: Adam's update with a
  ``DeviceBiasCorrection`` gives the bits of the host's bias corrections,
  and the Conformer's RoPE angles made on the device the host's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mtl_tpu_torch.config import Config
from mtl_tpu_torch.models.conformer import device_rope_angles, rope_angles
from mtl_tpu_torch.models.transformer import build_model, init_weights
from mtl_tpu_torch.train import graphs
from mtl_tpu_torch.train.graphs import GraphedMetaStep, StepKey, step_key
from mtl_tpu_torch.ops import native
from mtl_tpu_torch.train.optim import Adam, DeviceBiasCorrection
from mtl_tpu_torch.train.steps import (batch_to_device, init_train_state,
                                       make_meta_step)
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB, K, B = 12, 2, 2


def _cfg(feat_extractor="vgg_cnn", second_order=False):
    cfg = Config()
    m = cfg.model
    m.feat_extractor = feat_extractor
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.1
    m.src_max_len, m.tgt_max_len = 400, 32
    if feat_extractor == "vgg_cnn":
        cfg.audio.window_size = 0.0015  # n_fft 24: 13 bins
    cfg.train.lr, cfg.train.meta_lr = 0.05, 1e-3
    cfg.train.clip, cfg.train.max_norm = True, 0.5
    cfg.train.device_cer = True
    cfg.train.second_order = second_order
    return cfg.finalize()


def _audio(rng, lead, samples, labels):
    """A host batch of raw prepadded audio with a leading ``lead`` shape."""
    n = int(np.prod(lead))
    lengths = np.array([samples, samples * 3 // 4] * n)[:n]
    return {"audio": (rng.randn(*lead, samples + 320) * 0.1).astype(
                np.float32),
            "audio_lengths": lengths.reshape(lead).astype(np.int32),
            "targets": rng.randint(3, VOCAB, lead + (labels,)).astype(
                np.int32),
            "src_percentages": np.ones(lead, np.float32)}


def _batch(seed, samples, labels, per_task_query):
    rng = np.random.RandomState(seed)
    support = _audio(rng, (K, B), samples, labels)
    query = _audio(rng, (K, B) if per_task_query else (B,), samples, labels)
    return support, query


# -- where the graphs engage -------------------------------------------------

CASES = {
    "one card, first order": (dict(), True),
    "the CPU": (dict(device="cpu"), False),
    "a mesh": (dict(mesh=object()), False),
    "second order": (dict(second_order=True), False),
    "a discriminator head": (dict(discriminator=object()), False),
    "--remat": (dict(remat=True), False),
    "--remat-conv": (dict(remat_conv=True), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphs_engage_on_one_card_first_order_only(case):
    kw, want = CASES[case]
    cfg = _cfg(second_order=kw.get("second_order", False))
    cfg.model.remat = kw.get("remat", False)
    cfg.model.remat_conv = kw.get("remat_conv", False)
    device = torch.device(kw.get("device", "cuda"))
    assert graphs.graphs_engage(device, cfg, kw.get("mesh"),
                                kw.get("discriminator")) is want


@pytest.mark.parametrize("per_task_query", [False, True])
@pytest.mark.parametrize("second_order", [False, True])
def test_cpu_meta_trainers_run_the_eager_step(monkeypatch, per_task_query,
                                              second_order):
    """On the CPU ``make_step`` returns the eager step and ``run_step``
    takes the batch to the device itself; no graph is ever made."""
    from mtl_tpu_torch.train.trainer import MetaTrainer, TransientTrainer

    def no_graph(*a, **k):
        raise AssertionError("a graph was made on the CPU")

    monkeypatch.setattr(graphs, "CudaStepGraph", no_graph)
    monkeypatch.setattr(graphs.GraphedMetaStep, "__init__", no_graph)
    cfg = _cfg(second_order=second_order)
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    vocab = SimpleNamespace(label2id={" ": 3})
    cls = MetaTrainer if per_task_query else TransientTrainer
    trainer = cls(model, cfg, vocab, torch.device("cpu"))
    opt = trainer.make_optimizer()
    step = trainer.make_step(opt)
    assert not isinstance(step, GraphedMetaStep)
    state = init_train_state(model, opt)
    for seed in (1, 2):
        state, loss, _, _, _ = trainer.run_step(
            step, state, _batch(seed, 4800, 6, per_task_query),
            torch.Generator().manual_seed(0), 0.5)
        assert np.isfinite(float(loss))
    assert state.step == 2


# -- the key -----------------------------------------------------------------

@pytest.mark.parametrize("per_task_query", [False, True])
@pytest.mark.parametrize("samples,labels", [(4800, 6), (8000, 9)])
def test_step_key_is_the_batch_shapes(per_task_query, samples, labels):
    support, query = _batch(0, samples, labels, per_task_query)
    assert step_key(support, query) == StepKey(K, B, B, samples + 320,
                                               labels)
    q = {k: v[..., :1] if k == "audio" else v for k, v in query.items()}
    assert step_key(support, q) == step_key(support, query)
    feats = {"features": np.zeros((K, B, 50, 13), np.float32),
             "input_lengths": np.zeros((K, B), np.int32),
             "targets": support["targets"]}
    assert step_key(feats, query) == StepKey(K, B, B, 50, labels)


# -- the policy --------------------------------------------------------------

class RerunGraph:
    """A stand-in for ``CudaStepGraph``: the CPU runs work as it is issued,
    so the capture runs the step and the replay right after it is that
    step; a later replay runs the step again and writes its outputs into
    the capture's, as a graph's replay writes its static outputs."""

    made = []

    def __init__(self, pool, generator):
        self.captures, self.replays, self.ran = 0, 0, False
        RerunGraph.made.append(self)

    def capture(self, fn):
        self.fn, self.captures, self.ran = fn, self.captures + 1, True
        self.out = fn()
        return self.out

    def replay(self):
        self.replays += 1
        if self.ran:
            self.ran = False
            return
        _, metrics = self.fn()
        for k, v in self.out[1].items():
            v.copy_(metrics[k])


def _run(cfg, per_task_query, graphed, keys):
    """(metrics by step, state, model, generator) of the steps over the
    batches of ``keys`` (seed, samples, labels) from a seeded model."""
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    if graphed:
        step = GraphedMetaStep(model, cfg, opt, torch.device("cpu"),
                               per_task_query, space_id=3,
                               new_graph=RerunGraph)
    else:
        step = make_meta_step(model, cfg, opt, per_task_query, space_id=3)
    gen = torch.Generator().manual_seed(7)
    cpu = torch.device("cpu")
    out = []
    for seed, samples, labels in keys:
        support, query = _batch(seed, samples, labels, per_task_query)
        if not graphed:
            support, query = (batch_to_device(support, cpu),
                              batch_to_device(query, cpu))
        state, metrics = step(state, support, query, gen)
        out.append(metrics)
    return out, state, model, gen


@pytest.mark.parametrize("per_task_query,feat_extractor",
                         [(False, "vgg_cnn"), (True, "emb_cnn")])
def test_policy_and_results_through_a_stand_in_graph(per_task_query,
                                                     feat_extractor):
    RerunGraph.made.clear()
    cfg = _cfg(feat_extractor)
    a, b, c = (4800, 6), (6400, 9), (8000, 6)
    keys = [(1, *a), (2, *a), (3, *b), (4, *b), (5, *a), (6, *c), (7, *b)]
    want, s0, m0, g0 = _run(cfg, per_task_query, False, keys)
    native.reset_launch_counts()
    got, s1, m1, g1 = _run(cfg, per_task_query, True, keys)
    # A and B captured once each at their second sighting, C never
    assert [(g.captures, g.replays) for g in RerunGraph.made] == [(1, 2),
                                                                  (1, 2)]
    assert (native.launch_counts["meta_graph_captures"],
            native.launch_counts["meta_graph_replays"]) == (2, 4)
    for i, (w, g) in enumerate(zip(want, got)):
        assert set(w) == set(g) and {"cer_dist", "cer_chars"} <= set(g)
        for k in w:
            assert torch.equal(w[k], g[k]), (i, k)
    assert (s1.step, s1.opt_state.count) == (s0.step, s0.opt_state.count) \
        == (len(keys), len(keys))
    for group in ("params", "mu", "nu"):
        want_t = s0.params if group == "params" else getattr(s0.opt_state,
                                                             group)
        got_t = s1.params if group == "params" else getattr(s1.opt_state,
                                                            group)
        for n in want_t:
            assert torch.equal(want_t[n], got_t[n]), (group, n)
    stats = [list(m.conv.batch_stats()) for m in (m0, m1)]
    assert len(stats[0]) == (2 if feat_extractor == "emb_cnn" else 0)
    for (mw, vw), (mg, vg) in zip(*stats):
        assert torch.equal(mw, mg) and torch.equal(vw, vg)
    assert torch.equal(g0.get_state(), g1.get_state())


def test_a_replay_refuses_another_generator_or_state():
    cfg = _cfg()
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    step = GraphedMetaStep(model, cfg, opt, torch.device("cpu"),
                           new_graph=RerunGraph)
    gen = torch.Generator().manual_seed(7)
    for seed in (1, 2):
        state, _ = step(state, *_batch(seed, 4800, 6, False), gen)
    with pytest.raises(ValueError, match="generator"):
        step(state, *_batch(3, 4800, 6, False), torch.Generator())
    other = init_train_state(model, Adam(cfg.train.meta_lr))
    with pytest.raises(ValueError, match="state"):
        step(other, *_batch(3, 4800, 6, False), gen)


def test_a_step_hands_out_copies_of_the_graph_outputs():
    """The metrics a replay returns are copies: the graph's own outputs,
    which the next replay of any key overwrites, are never handed out."""
    RerunGraph.made.clear()
    cfg = _cfg()
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    step = GraphedMetaStep(model, cfg, opt, torch.device("cpu"),
                           new_graph=RerunGraph)
    gen = torch.Generator().manual_seed(7)
    for seed in (1, 2, 3):
        state, metrics = step(state, *_batch(seed, 4800, 6, False), gen)
        if seed == 1:  # the eager first sighting
            assert not step.entries
            continue
        (entry,) = step.entries.values()
        own = {v.data_ptr() for v in entry.outputs.values()}
        assert not own & {v.data_ptr() for v in metrics.values()}
        assert all(torch.equal(metrics[k], v)
                   for k, v in entry.outputs.items())
    assert (entry.replays, state.step) == (2, 3)


# -- what the captured step reads from the device ----------------------------

@pytest.mark.parametrize("count", [1, 2, 7, 1000])
def test_adam_with_device_corrections_is_bitwise_the_host_update(count):
    """``Adam.update`` with a ``DeviceBiasCorrection`` written for the
    update's count gives the bits of the update that computes the bias
    corrections on the host."""
    rng = np.random.RandomState(count)
    shapes = {"w": (5, 3), "b": (3,)}
    runs = []
    for device_side in (False, True):
        opt = Adam(1e-3)
        params = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for k, s in shapes.items()}
        state = opt.init(params)
        state.count = count - 1
        for t in list(state.mu.values()) + list(state.nu.values()):
            t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32)))
        grads = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for k, s in shapes.items()}
        corr = None
        if device_side:
            corr = DeviceBiasCorrection(torch.device("cpu"))
            corr.write(*opt.bias_corrections(count))
        opt.update(grads, state, params, corrections=corr)
        runs.append((params, state))
        rng = np.random.RandomState(count)  # the same draws again
    (p0, s0), (p1, s1) = runs
    assert s0.count == s1.count == count
    for k in shapes:
        for a, b in ((p0, p1), (s0.mu, s1.mu), (s0.nu, s1.nu)):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("t,dim", [(1, 8), (200, 64), (625, 128), (1000, 128)])
def test_device_rope_angles_are_the_host_angles(t, dim):
    """The Conformer's RoPE angles made on the device (nothing cached per
    length) hold the bits of the host's float64 product cast to f32."""
    got = device_rope_angles(t, dim, torch.device("cpu")).numpy()
    want = rope_angles(t, dim)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
