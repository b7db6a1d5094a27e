"""The first-order meta step replayed as a CUDA graph, one graph per batch
shape.

The eager meta step (``steps.make_meta_step``) dispatches tens of thousands
of ATen ops a step from the host, and the card waits for most of them. A
graph of the whole step, from its inputs to its metrics, is launched in one
call. ``GraphedMetaStep`` wraps the eager step and keeps, per shape key
(``step_key``: K, the support and query batch sizes, the time and label
buckets that ``sample_meta_batch`` fixes per step), a count of sightings:

* the first sighting runs the eager step, a real step whose result is
  kept. It runs on the stream that a capture will use, so that the
  libraries' handles, workspaces and algorithm choices for those shapes
  are made by real work;
* the second copies the batch into the key's static inputs, captures the
  step over them and replays the graph: the replay is that step;
* every later one copies the batch into the static inputs (pinned host
  buffers, ``non_blocking``) and replays.

A key seen once never pays for a capture, and there is no warm-up or
throwaway step. What changes from one step to the next without being an
input is carried thus: Adam's bias corrections are f32 scalars on the
card, written before each step and passed to its update
(``optim.DeviceBiasCorrection``); the dropout generator is registered with
every graph, so a replay draws the masks the eager step would and leaves
the generator where it would; ``state.step`` and the optimizer's count
stay host counters, which the wrapper advances. The weights, the
optimizer's moments and the model's buffers are updated in place, at the
addresses the graphs hold.

Memory: every graph captures into one pool, and every eager step allocates
from it too, so the card holds about one step's activations for the
largest key, as the eager trainer does, and not a pool beside an eager
step's own. Replays never overlap, and the same stream runs the eager
steps, the captures and the replays, so a block that one of them frees is
free for the next. What must outlive a step may not sit in the pool, where
the next replay of any graph may write: the metrics are copied out on the
caller's stream, and an eager step after the first capture must leave the
pool's live bytes as it found them (checked; the step keeps no per-shape
cache on the card). The eager step before the first capture may leave its
libraries' workspaces and the model's caches there, since a capture never
hands out a live block.

``graphs_engage`` says where this runs: a CUDA device, no mesh (a
collective under capture is another problem), first order (a double
backward under capture is one too), no discriminator head, and no
``--remat`` or ``--remat-conv`` (the recompute rewinds the dropout
generator through its host state, which a capture does not advance).
Everywhere else the trainers run the eager step unchanged.

The spans ``meta.graph_capture`` and ``meta.graph_replay``
(``utils/trace.py``) cover each capture and each replay; the eager step's
own spans (``meta.step`` and its phases) open in the eager steps and the
captures only. ``ops/native.py:launch_counts`` counts what runs on the
host: the hand-written kernels of the eager steps and of the captures (each
capture records its step's launches once), ``meta_graph_captures`` and
``meta_graph_replays``. Each capture logs one line with its key, the
kernel launches it recorded (one replay launches them again) and the bytes
the pool holds.

The stand-in graph of the CPU tests (``tests/test_torch_port_graphs.py``)
drives the policy where no pool, stream or pinned memory exists; the
branches on ``self.cuda`` serve those tests alone.
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops import native
from ..utils.logger import log_print
from ..utils.trace import span
from .optim import DeviceBiasCorrection
from .steps import batch_to_device, make_meta_step


class StepKey(NamedTuple):
    """What fixes every input shape of one meta step."""
    tasks: int
    support_batch: int
    query_batch: int
    time: int  # the support's audio samples (features: frames)
    labels: int


def step_key(support: Dict[str, np.ndarray],
             query: Dict[str, np.ndarray]) -> StepKey:
    """The key of a host batch: ``support`` [K, B, ...] and ``query``
    [B, ...] (a per-task query [K, B, ...]), all in one time and one
    label bucket."""
    k, b, labels = support["targets"].shape
    x = support["audio"] if "audio" in support else support["features"]
    return StepKey(k, b, query["targets"].shape[-2], x.shape[2], labels)


def graphs_engage(device: torch.device, cfg: Config, mesh=None,
                  discriminator=None) -> bool:
    """Whether a meta trainer replays its step as graphs (the module
    docstring says why each condition holds)."""
    return (device.type == "cuda" and mesh is None and discriminator is None
            and not cfg.train.second_order and not cfg.model.remat
            and not cfg.model.remat_conv)


class CudaStepGraph:
    """One ``torch.cuda.CUDAGraph`` of the step: captured on the current
    stream into ``pool``, with the dropout ``generator`` registered so that
    each replay draws from its current offset and advances it."""

    def __init__(self, pool, generator: Optional[torch.Generator]):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        if generator is not None and generator.device.type == "cuda":
            self.graph.register_generator_state(generator)

    def capture(self, fn: Callable):
        """Records ``fn()``'s work without running it; returns what ``fn``
        returned, the tensors that each replay writes."""
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")
        try:
            return fn()
        finally:
            self.graph.capture_end()

    def replay(self) -> None:
        self.graph.replay()


class GraphPool:
    """The memory pool that a step's graphs and eager steps share
    (``graph_pool_handle``), held for the life of this object by an empty
    graph captured into it: the allocator frees a pool that no graph
    holds, and an eager step's use of it (``allocating``) holds it only
    while it runs."""

    def __init__(self, device: torch.device, stream: torch.cuda.Stream):
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        self.handle = torch.cuda.graph_pool_handle()
        self._holder = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the holder graph is empty
            self._holder.capture_begin(pool=self.handle)
            self._holder.capture_end()

    @contextlib.contextmanager
    def allocating(self):
        """Allocations on the current stream, from any thread (autograd
        runs the backward on its own), come from the pool."""
        torch._C._cuda_beginAllocateCurrentStreamToPool(self.index,
                                                        self.handle)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(self.index, self.handle)
            torch._C._cuda_releasePool(self.index, self.handle)

    def _segments(self) -> list:
        return [s for s in torch.cuda.memory_snapshot()
                if tuple(s["segment_pool_id"]) == tuple(self.handle)]

    def reserved_bytes(self) -> int:
        """Bytes of the card's memory that the pool holds."""
        return sum(s["total_size"] for s in self._segments())

    def live_bytes(self) -> int:
        """Bytes of the pool that live tensors hold."""
        return sum(s["allocated_size"] for s in self._segments())


class _Entry:
    """A key's static inputs (on the device, each with a host buffer to
    stage it in, pinned on CUDA), its graph, the outputs it writes, the
    kernel launches its capture recorded and its replays."""

    def __init__(self, batches, device: torch.device):
        cuda = device.type == "cuda"
        self.host = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                     for b in batches]
        if cuda:
            self.host = [{k: v.pin_memory() for k, v in b.items()}
                         for b in self.host]
        self.static = [{k: v.to(device) for k, v in b.items()}
                       for b in self.host]
        # the last copies out of the host buffers, which the next load waits
        # for before it writes them
        self.copied = torch.cuda.Event() if cuda else None
        self.graph = None
        self.outputs: Optional[dict] = None
        self.generator: Optional[torch.Generator] = None
        self.state_ptrs: tuple = ()
        self.launches: Dict[str, int] = {}
        self.replays = 0

    def load(self, batches, stream) -> None:
        if self.copied is not None:
            self.copied.synchronize()
        for batch, host, static in zip(batches, self.host, self.static):
            if set(batch) != set(host):
                raise ValueError(f"batch fields {sorted(batch)} differ from "
                                 f"the key's {sorted(host)}")
            for k, buf in host.items():
                if tuple(batch[k].shape) != tuple(buf.shape):
                    raise ValueError(f"{k}: shape {batch[k].shape} under a "
                                     f"key of shape {tuple(buf.shape)}")
                buf.numpy()[...] = batch[k]
                static[k].copy_(buf, non_blocking=True)
        if self.copied is not None:
            self.copied.record(stream)


def _state_ptrs(state) -> tuple:
    """The addresses of the tensors a graph updates in place."""
    opt = state.opt_state
    return tuple(t.data_ptr() for group in (state.params, opt.mu, opt.nu)
                 for t in group.values())


class GraphedMetaStep:
    """``make_meta_step``'s first-order step of ``model`` (no head) on host
    batches, replayed per shape key as the module docstring sets out.
    ``optimizer`` is its outer Adam, to which the step passes the bias
    corrections this object writes on the card. ``new_graph(pool,
    generator)`` makes a graph object (``CudaStepGraph``; a stand-in on the
    CPU)."""

    def __init__(self, model: torch.nn.Module, cfg: Config, optimizer,
                 device: torch.device, per_task_query: bool = False,
                 space_id: Optional[int] = None,
                 new_graph: Callable = CudaStepGraph):
        self.corrections = DeviceBiasCorrection(device)
        self.step = make_meta_step(model, cfg, optimizer, per_task_query,
                                   space_id=space_id,
                                   bias_corrections=self.corrections)
        self.optimizer = optimizer
        self.device = device
        self.new_graph = new_graph
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.pool = GraphPool(device, self.stream) if self.cuda else None
        self.sightings: Dict[StepKey, int] = {}
        self.entries: Dict[StepKey, _Entry] = {}

    def __call__(self, state, support: Dict[str, np.ndarray],
                 query: Dict[str, np.ndarray],
                 generator: Optional[torch.Generator] = None,
                 beta: float = 0.5):
        """One step on a host batch; returns (state, metrics) as the eager
        step does."""
        key = step_key(support, query)
        seen = self.sightings[key] = self.sightings.get(key, 0) + 1
        step, count = state.step + 1, state.opt_state.count + 1
        held = None
        if seen == 1 and self.pool is not None and self.entries:
            held = self.pool.live_bytes()
        with self._on_stream():
            self.corrections.write(*self.optimizer.bias_corrections(count))
            if seen == 1:
                with span("train.to_device"):
                    batches = [batch_to_device(b, self.device)
                               for b in (support, query)]
                with self._in_pool():
                    _, out = self.step(state, *batches, generator, beta)
                del batches
            else:
                out = self._replay(key, state, (support, query), generator,
                                   beta)
        # out of the pool, on the caller's stream: the next step, of any
        # key, waits for it before it writes the pool again
        out = {k: v.clone() for k, v in out.items()}
        if held is not None and self.pool.live_bytes() > held:
            gc.collect()  # a reference cycle's tensors are read by no one
            left = self.pool.live_bytes() - held
            if left > 0:
                raise RuntimeError(
                    f"the eager step of {key._asdict()} left {left} bytes "
                    f"live in the graphs' pool, where a replay may write")
        # a replay runs none of the step's host code, which counts these
        state.step, state.opt_state.count = step, count
        return state, out

    @contextlib.contextmanager
    def _on_stream(self):
        """The body on the graphs' stream, ordered after the caller's
        stream's work and before its next."""
        if not self.cuda:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            caller.wait_stream(self.stream)

    def _in_pool(self):
        return (self.pool.allocating() if self.pool is not None
                else contextlib.nullcontext())

    def _replay(self, key: StepKey, state, batches, generator, beta) -> dict:
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = _Entry(batches, self.device)
        with span("train.to_device"):
            entry.load(batches, self.stream)
        if entry.graph is None:
            self._capture(key, entry, state, generator, beta)
        else:
            if generator is not entry.generator:
                raise ValueError("a graph replays the dropout stream of the "
                                 "generator it was captured with")
            if _state_ptrs(state) != entry.state_ptrs:
                raise ValueError("a graph updates the state it was captured "
                                 "with, in place; this state holds others")
        with span("meta.graph_replay"):
            entry.graph.replay()
        entry.replays += 1
        native.launch_counts["meta_graph_replays"] += 1
        return entry.outputs

    def _capture(self, key: StepKey, entry: _Entry, state, generator,
                 beta) -> None:
        before = dict(native.launch_counts)
        t0 = time.perf_counter()
        with span("meta.graph_capture"):
            graph = self.new_graph(self.pool.handle if self.cuda else None,
                                   generator)
            _, entry.outputs = graph.capture(
                lambda: self.step(state, *entry.static, generator, beta))
        seconds = time.perf_counter() - t0
        native.launch_counts["meta_graph_captures"] += 1
        entry.graph, entry.generator = graph, generator
        entry.state_ptrs = _state_ptrs(state)
        entry.launches = {k: n - before.get(k, 0)
                          for k, n in native.launch_counts.items()
                          if n != before.get(k, 0)
                          and not k.startswith("meta_graph_")}
        held = (f"{self.pool.reserved_bytes()} bytes"
                if self.cuda else "no card")
        log_print(f"META STEP GRAPH captured for {key._asdict()} in "
                  f"{seconds:.3f} s: launches {entry.launches} a replay, "
                  f"{len(self.entries)} graph(s), pool {held}")
