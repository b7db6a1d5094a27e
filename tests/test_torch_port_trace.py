"""The program's spans (``mtl_tpu_torch/utils/trace.py``) on the CPU.

Off, a span is one shared no-op object: no totals, no profiler range.
Enabled, it keeps count, inclusive and self ns by name, each thread on its
own stack, and many threads closing one name lose no count. Under
torch.profiler each span is a ``record_function`` range nested as in the
program, and keeps totals only when enabled too. One tiny meta step (K 2, first and second order) opens each
per-task span K times and ``meta.step``, ``meta.query_features`` and
``meta.outer`` once, and its outputs and updated weights are bitwise those
of the step with tracing off. The graph-replayed meta step opens
``meta.graph_capture`` once and ``meta.graph_replay`` a replay, and nothing
with tracing off. A forward of an E-Branchformer opens each
``model.ebranch.*`` span once a block, inside ``model.encoder``.
``greedy_loop`` opens a ``greedy.step`` and a
``greedy.done_sync`` a step it ran, an early EOS stop too; the prefetchers
open ``data.wait`` in the caller, and a fetch's own spans stay on its
worker's stack. ``cli/breakdown.py`` puts each kernel's device ms down to
the innermost span the host launched it from.
"""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mtl_tpu_torch.config import Config
from mtl_tpu_torch.data.vocab import EOS_ID
from mtl_tpu_torch.decode.greedy import greedy_loop
from mtl_tpu_torch.models.transformer import build_model, init_weights
from mtl_tpu_torch.train.optim import Adam
from mtl_tpu_torch.train.steps import init_train_state, make_meta_step
from mtl_tpu_torch.train.trainer import MultiWorkerPrefetcher, Prefetcher
from mtl_tpu_torch.utils import trace
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB, NFREQ, FRAMES, K = 12, 13, 32, 2
PER_TASK = ("meta.support_fwd", "meta.support_grad", "meta.inner_sgd",
            "meta.query_fwd", "meta.query_grad")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no totals."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def test_off_is_a_no_op(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert trace.span("meta.step") is trace.span("greedy.step")
    with trace.span("meta.step"):
        with trace.span("meta.support_fwd"):
            pass
    assert trace.totals() == {}


def test_nesting_gives_self_and_inclusive_time():
    trace.enable()
    with trace.span("meta.step"):
        time.sleep(0.01)
        for _ in range(2):
            with trace.span("meta.support_fwd"):
                time.sleep(0.01)
    tot = trace.totals()
    step, fwd = tot["meta.step"], tot["meta.support_fwd"]
    assert (step.count, fwd.count) == (1, 2)
    assert fwd.ns >= 2e7 and fwd.self_ns == fwd.ns
    assert step.ns >= 3e7 and step.self_ns == step.ns - fwd.ns
    assert step.self_ns >= 1e7
    trace.disable()
    with trace.span("meta.step"):
        pass
    assert trace.totals() == tot


def test_a_worker_span_is_not_a_child_of_the_main_thread_span():
    trace.enable()

    def work():
        with trace.span("test.work"):
            time.sleep(0.02)

    with trace.span("data.wait"):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    tot = trace.totals()
    assert tot["test.work"].ns >= 2e7
    # the wait covers the work, but the work ran on another stack
    assert tot["data.wait"].self_ns == tot["data.wait"].ns
    assert tot["test.work"].self_ns == tot["test.work"].ns


def test_concurrent_workers_lose_no_count():
    trace.enable()
    threads, spans = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(spans):
                with trace.span("test.work"):
                    with trace.span("model.features"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    tot = trace.totals()
    assert tot["test.work"].count == threads * spans
    assert tot["model.features"].count == threads * spans
    assert tot["test.work"].self_ns == (tot["test.work"].ns
                                        - tot["model.features"].ns)


def test_profiler_sees_spans_nested_as_in_the_program():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("meta.step"):
            with trace.span("meta.support_fwd"):
                torch.ones(3).add_(1)
            with trace.span("meta.outer"):
                pass
    events = {e.name: e for e in prof.events()}
    assert events["meta.step"].cpu_parent is None
    assert events["meta.support_fwd"].cpu_parent.name == "meta.step"
    assert events["meta.outer"].cpu_parent.name == "meta.step"
    assert events["aten::add_"].cpu_parent.name == "meta.support_fwd"
    # a running profiler alone keeps no totals; enabled, the span does both
    assert trace.totals() == {}
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("meta.step"):
            with trace.span("meta.outer"):
                pass
    events = {e.name: e for e in prof.events()}
    assert events["meta.outer"].cpu_parent.name == "meta.step"
    assert {k: t.count for k, t in trace.totals().items()} == {
        "meta.step": 1, "meta.outer": 1}


def _cfg(second_order):
    cfg = Config()
    m = cfg.model
    m.num_enc_layers, m.num_dec_layers, m.num_heads = 1, 1, 2
    m.dim_model = m.dim_emb = m.dim_inner = 16
    m.dim_key = m.dim_value = 8
    m.r, m.dtype, m.dropout = 4, "float32", 0.0
    m.src_max_len, m.tgt_max_len = 64, 32
    cfg.audio.window_size = 0.0015  # n_fft 24: 13 bins
    cfg.train.lr, cfg.train.meta_lr = 0.05, 1e-3
    cfg.train.second_order = second_order
    cfg.train.clip, cfg.train.max_norm = True, 0.5
    cfg.finalize()
    assert cfg.audio.num_freq == NFREQ
    return cfg


def _batches(seed, k):
    rng = np.random.RandomState(seed)
    out = {"features": (rng.randn(k, 2, FRAMES, NFREQ) * 0.5).astype(
               np.float32),
           "input_lengths": np.tile(np.array([FRAMES, 24], np.int32), (k, 1)),
           "targets": rng.randint(3, VOCAB, (k, 2, 6)).astype(np.int32),
           "src_percentages": np.ones((k, 2), np.float32)}
    return {key: torch.from_numpy(v) for key, v in out.items()}


def _meta_step(second_order, traced):
    """(metrics, updated weights, the step's totals) of one step from a
    seeded model."""
    cfg = _cfg(second_order)
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    support = _batches(1, K)
    query = {key: v[0] for key, v in _batches(2, 1).items()}
    step = make_meta_step(model, cfg, opt)
    trace.reset()
    if traced:
        trace.enable()
    try:
        state, metrics = step(state, support, query)
    finally:
        trace.disable()
    weights = {n: p.detach().clone() for n, p in state.params.items()}
    return metrics, weights, trace.totals()


@pytest.mark.parametrize("second_order", [False, True],
                         ids=["first_order", "second_order"])
def test_meta_step_spans(second_order):
    _, _, tot = _meta_step(second_order, traced=True)
    counts = {k: t.count for k, t in tot.items()}
    assert counts == {
        **{name: K for name in PER_TASK},
        "meta.step": 1, "meta.query_features": 1, "meta.outer": 1,
        # each task's support and query forwards
        **{name: 2 * K for name in ("model.vgg", "model.encoder",
                                    "model.decoder", "model.loss")}}
    step = tot["meta.step"]
    phases = sum(tot[n].ns for n in PER_TASK + ("meta.query_features",
                                                "meta.outer"))
    assert step.self_ns == step.ns - phases >= 0


@pytest.mark.parametrize("second_order", [False, True],
                         ids=["first_order", "second_order"])
def test_meta_step_is_bitwise_the_same_traced(second_order):
    m_off, w_off, tot_off = _meta_step(second_order, traced=False)
    m_on, w_on, tot_on = _meta_step(second_order, traced=True)
    assert tot_off == {} and tot_on
    assert set(m_on) == set(m_off)
    for key in m_off:
        assert torch.equal(m_on[key], m_off[key]), key
    assert all(torch.equal(w_on[n], w_off[n]) for n in w_off)


class _StandInGraph:
    """``train/graphs.py``'s graph on the CPU, for counting spans: the
    capture runs the step, and a replay, like a CUDA graph's, runs no
    Python of the step (here nothing at all)."""

    def __init__(self, pool, generator):
        pass

    def capture(self, fn):
        return fn()

    def replay(self):
        pass


def test_graph_spans_are_no_ops_off_and_counted_enabled():
    """The graphed meta step over three sightings of one key: with tracing
    off no totals; enabled, one ``meta.graph_capture``, two
    ``meta.graph_replay`` (the capture's step and the third), and
    ``meta.step`` twice (the eager first sighting and the capture)."""
    from mtl_tpu_torch.train.graphs import GraphedMetaStep

    cfg = _cfg(False)
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = Adam(cfg.train.meta_lr)
    state = init_train_state(model, opt)
    step = GraphedMetaStep(model, cfg, opt, torch.device("cpu"),
                           new_graph=_StandInGraph)
    query = {key: v[0] for key, v in _batches(2, 1).items()}
    for traced in (False, True):
        trace.reset()
        if traced:
            trace.enable()
        step.sightings.clear()
        step.entries.clear()
        for _ in range(3):
            state, _ = step(state, _batches(1, K), query)
        trace.disable()
        counts = {k: t.count for k, t in trace.totals().items()
                  if k.startswith("meta.")}
        assert counts == ({} if not traced else {
            "meta.graph_capture": 1, "meta.graph_replay": 2, "meta.step": 2,
            "meta.query_features": 2, "meta.outer": 2,
            **{name: 2 * K for name in PER_TASK}})
    assert state.step == 6


EBRANCH = ("model.ebranch.attn", "model.ebranch.cgmlp",
           "model.ebranch.merge")


def test_e_branchformer_forward_opens_each_branch_span_once_a_block():
    """One teacher-forced forward of a 3-block E-Branchformer opens
    ``model.ebranch.attn``, ``.cgmlp`` and ``.merge`` 3 times each, inside
    ``model.encoder`` (opened once): their time is part of its."""
    cfg = _cfg(False)
    m = cfg.model
    m.encoder_type, m.num_enc_layers = "e_branchformer", 3
    m.linear_units, m.cgmlp_linear_units, m.merge_conv_kernel = 32, 48, 7
    cfg.finalize()
    model = build_model(cfg, VOCAB)
    init_weights(model, torch.Generator().manual_seed(0))
    batch = {k: v[0] for k, v in _batches(3, 1).items()}
    seq_in = torch.cat([torch.ones(2, 1, dtype=torch.long),
                        batch["targets"].long()], 1)
    trace.enable()
    try:
        model(batch["features"], batch["input_lengths"], seq_in)
    finally:
        trace.disable()
    tot = trace.totals()
    assert {k: tot[k].count for k in EBRANCH} == dict.fromkeys(EBRANCH, 3)
    assert tot["model.encoder"].count == 1
    assert sum(tot[k].ns for k in EBRANCH) <= (
        tot["model.encoder"].ns - tot["model.encoder"].self_ns)


class _Decoder:
    """A stand-in for the model's decode step: logits whose argmax is EOS
    from step ``eos_at`` on (never when None)."""

    def __init__(self, eos_at):
        self.eos_at = eos_at

    def init_cache(self, b, n, device):
        return None

    def decode_step(self, y_t, t, enc_kvs, caches):
        logits = torch.zeros(y_t.shape[0], VOCAB)
        hot = EOS_ID if self.eos_at is not None and t >= self.eos_at else 5
        logits[:, hot] = 1.0
        return logits, caches


@pytest.mark.parametrize("eos_at,steps", [(None, 9), (3, 4)],
                         ids=["max_steps", "early_eos"])
def test_greedy_loop_spans_a_step(eos_at, steps):
    trace.enable()
    ys = greedy_loop(_Decoder(eos_at), None, 3, torch.device("cpu"),
                     max_steps=9, start_token=1)
    tot = trace.totals()
    assert int((ys != EOS_ID).sum(1).max()) == min(steps, eos_at or 9)
    assert tot["greedy.loop"].count == 1
    assert tot["greedy.step"].count == tot["greedy.done_sync"].count == steps
    assert tot["greedy.step"].self_ns == (tot["greedy.step"].ns
                                          - tot["greedy.done_sync"].ns)


@pytest.mark.parametrize("workers", [1, 2], ids=["double_buffer", "pool"])
def test_prefetchers_span_fetch_and_wait(workers):
    trace.enable()
    threads = set()

    def fetch(i=None):
        threads.add(threading.get_ident())
        with trace.span("test.fetch"):
            time.sleep(0.005)
        return i

    if workers == 1:
        prefetch = Prefetcher(fetch)
    else:
        prefetch = MultiWorkerPrefetcher(fetch, workers)
    try:
        got = [prefetch.get() for _ in range(3)]
    finally:
        prefetch.stop()
    tot = trace.totals()
    assert tot["data.wait"].count == 3
    assert tot["test.fetch"].count >= 3
    assert threading.get_ident() not in threads
    if workers > 1:
        assert got == [0, 1, 2]
    # a fetch's spans are its worker's, never children of the wait
    assert tot["data.wait"].self_ns == tot["data.wait"].ns


def _event(name, start, end, device=False, eid=0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end), id=eid,
        is_user_annotation=False,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU))


def test_breakdown_puts_kernels_down_to_the_innermost_span():
    """Times in us. The host: greedy.loop [0, 100] around two greedy.step
    [10, 40] and [40, 90], the second around greedy.done_sync [80, 90]; a
    kernel launched at 15, two at 45 and 50, a copy launched at 85, and one
    launched at 95, outside any step. Kernels share their launch call's
    correlation id; one without a launch call counts under no span."""
    from mtl_tpu_torch.cli.breakdown import _device_ms_by_span

    events = [
        _event("greedy.loop", 0, 100), _event("greedy.step", 10, 40),
        _event("greedy.step", 40, 90), _event("greedy.done_sync", 80, 90),
        _event("aten::mm", 14, 17),
        _event("cudaLaunchKernel", 15, 16, eid=1),
        _event("cudaLaunchKernel", 45, 46, eid=2),
        _event("cudaLaunchKernel", 50, 51, eid=3),
        _event("cudaMemcpyAsync", 85, 89, eid=4),
        _event("cudaLaunchKernel", 95, 96, eid=5),
        _event("void gemm_kernel<1>(float)", 20, 30, device=True, eid=1),
        _event("void gemm_kernel<2>(float)", 50, 60, device=True, eid=2),
        _event("void at::native::argmax<4>(x)", 60, 62, device=True, eid=3),
        _event("Memcpy DtoH (Device -> Pageable)", 86, 87, device=True,
               eid=4),
        _event("void fill<1>(x)", 96, 99, device=True, eid=5),
        _event("void orphan(x)", 70, 71, device=True, eid=9),
        _event("greedy.step", 40, 90, device=True),  # its device range
    ]
    names = {"greedy.loop", "greedy.step", "greedy.done_sync"}
    got = {s: {k: round(ms, 9) for k, ms in by_kernel.items()}
           for s, by_kernel in _device_ms_by_span(events, names).items()}
    assert got == {
        "greedy.step": {"gemm_kernel": 0.02, "at::native::argmax": 0.002},
        "greedy.done_sync": {"Memcpy DtoH": 0.001},
        "greedy.loop": {"fill": 0.003},
        None: {"orphan": 0.001}}
