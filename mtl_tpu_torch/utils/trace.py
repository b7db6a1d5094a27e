"""The program's spans: named host ranges around the work of its layers
(an iteration, the wait for a batch, the meta step's phases, the model's
stages, a greedy decode step).

``span(name)`` is a context manager in one of three states:

* **off**, the default: a shared no-op object. No clock is read and no
  profiler range opened; a span costs a call and two flag tests.
* **a torch profiler running on the calling thread**
  (``torch.autograd._profiler_enabled()``): the span is
  ``torch.profiler.record_function(name)``, stamped on the profiler's host
  timeline, the clock that places the device kernels, so any profiler
  (``--profile-dir``, ``cli/breakdown.py``) sees the program's structure.
* **enabled** (``enable()`` ... ``disable()``): the span adds to the host
  totals by name (``time.perf_counter_ns``): its count, inclusive ns and
  self ns, the duration less the time its child spans cover. Under a
  running profiler it opens the ``record_function`` range as well.
  ``totals()`` reads them and ``reset()`` clears them.

Each thread keeps its own stack of open spans, so that a span of another
thread is never a child of the main thread's; the totals of all threads
are one table under a lock, so that threads that close spans of one name
at once lose no count. ``ops/native.py:launch_counts`` stays the port's
counter of kernel launches; a span's count is the program's count of its
work (decode steps, tasks, iterations).

Names are ``<layer>.<part>``. Tracing on or off changes no tensor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple

import torch


class Total(NamedTuple):
    count: int
    ns: int  # inclusive
    self_ns: int  # less the child spans


_enabled = False
_lock = threading.Lock()
_totals: Dict[str, Total] = {}
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "t0", "child_ns")

    def __init__(self, name: str, profiling: bool):
        self.name = name
        self.rf = (torch.profiler.record_function(name) if profiling
                   else None)
        self.child_ns = 0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        with _lock:
            c, ns, self_ns = _totals.get(self.name, (0, 0, 0))
            _totals[self.name] = Total(c + 1, ns + dur,
                                       self_ns + dur - self.child_ns)
        return False


def span(name: str):
    """A span named ``name`` in the state the module docstring gives."""
    profiling = torch.autograd._profiler_enabled()
    if _enabled:
        return _Span(name, profiling)
    if profiling:
        return torch.profiler.record_function(name)
    return _OFF


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _lock:
        _totals.clear()


def totals() -> Dict[str, Total]:
    """The totals by span name since the last ``reset()``."""
    with _lock:
        return dict(_totals)


def format_totals(tot: Dict[str, Total]) -> str:
    """One line per span, longest inclusive time first: count, inclusive
    and self ms, and ms a call."""
    rows = sorted(tot.items(), key=lambda kv: -kv[1].ns)
    return "\n".join(
        f"  {name:<20} {t.count:>6} x  {t.ns / 1e6:>10.3f} ms  self "
        f"{t.self_ns / 1e6:>10.3f} ms  {t.ns / 1e6 / t.count:>8.3f} ms each"
        for name, t in rows)
