"""What every cell shares: finding a cell's files by name, the program's
configuration from a benchmark configuration, spans, the profiler's
reduction to device time, the result line and the check of imports.

The pieces of one configuration, traffic mix, driver or per-layer metric
sit in files of their own, found by name:

* ``BENCHMARK.json``'s workload -> its ``config`` and ``traffic``;
* ``configs/<config>.json``, ``traffic/<traffic>.json``;
* ``drivers/<traffic's driver>.py`` (``run(cell) -> Outcome``);
* ``metrics/<metric>.py`` (``read(trace) -> float | None``);
* ``limits/<workload>.json``: the limits of the correctness check;
* ``reference/encoders/<config's encoder_type>.py``: the encoder's
  parameter shapes, plain reference and FLOP count, which
  ``reference/params.py``, ``reference/model.py`` and ``roofline.py``
  take from it. A configuration's own kernel counts may sit there or in
  a module beside it, for its metric readers to import.

Frozen from ``chip_smoke.py``: ``busy_ms`` (the union of the device
kernels' intervals) and ``KERNEL_GROUPS`` (a kernel's group by name).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mtl_tpu")

KERNEL_GROUPS = (  # (group, substrings of a kernel's name), first match
    ("port kernels: vgg_tc forward", ("vgg_block",)),
    ("port kernels: stft_fft", ("stft",)),
    ("cuDNN convs + layouts (VGG backward recompute)",
     ("conv", "cudnn", "fprop", "dgrad", "wgrad", "nchw", "nhwc",
      "implicit")),
    ("GEMMs (linears, attention products)", ("gemm", "cutlass", "matmul",
                                             "gemv")),
    ("multi-tensor foreach (inner SGD, clip, Adam)",
     ("multi_tensor", "foreach")),
    ("max-pool", ("pool",)),
    ("softmax / log-softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("elementwise + copies", ("elementwise", "vectorized", "copy", "fill",
                              "unrolled", "where", "cat")),
)
GEMM_GROUP = "GEMMs (linears, attention products)"
COPY_GROUP = "elementwise + copies"


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One run of one workload."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: str
    t0: float  # the process's start on the host clock
    limits: dict


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]  # name -> (value, limit)
    trace: Optional[dict] = None
    device: Dict[str, float] = field(default_factory=dict)
    breakdown: Optional[dict] = None
    readings: Dict[str, float] = field(default_factory=dict)  # all numbers

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(math.isfinite(v) and v <= lim
                        for v, lim in self.checks.values()))


def find_cell(bench: dict, workload: str, root: str = HERE):
    """(the workload's entry, its config, its traffic, its limits)."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(os.path.join(root, "configs", entry["config"] + ".json"))
    traffic = load_json(os.path.join(root, "traffic",
                                     entry["traffic"] + ".json"))
    limits = load_json(os.path.join(root, "limits", workload + ".json"))
    return entry, config, traffic, limits


def driver(traffic: dict, root: str = HERE):
    return load_module(os.path.join(root, "drivers", traffic["driver"] + ".py"),
                       "bench_driver_" + traffic["driver"])


def program_config(config: dict, **extra):
    """The program's ``Config`` with every key of the benchmark's
    configuration that one of its sections holds, then ``extra`` (section
    attribute paths such as ``train.seed``)."""
    from mtl_tpu_torch.config import Config

    cfg = Config()
    sections = (cfg.model, cfg.audio, cfg.train, cfg.decode, cfg.data)
    for key, value in config.items():
        for sec in sections:
            if key in type(sec).__dataclass_fields__:
                setattr(sec, key, value)
    for path, value in extra.items():
        sec, key = path.split(".")
        setattr(getattr(cfg, sec), key, value)
    cfg.finalize()
    return cfg


def derived_seeds(seed: int) -> Dict[str, int]:
    """The seeds of a run's parts, from ``--seed``."""
    return {"data": seed % 2 ** 32, "weights": (seed * 2 + 1) % 2 ** 63,
            "dropout": (seed * 3 + 7) % 2 ** 63,
            "sample": (seed * 5 + 3) % 2 ** 32}


# -- spans -----------------------------------------------------------------

class Spans:
    """Host-clock spans by name, kept in memory; under the profiler each
    is also a ``record_function`` range."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiling:
            import torch

            rf = torch.profiler.record_function(name)
        t = time.perf_counter()
        with rf:
            yield
        self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t
        self.count[name] = self.count.get(name, 0) + 1

    def mean_ms(self, name: str) -> Optional[float]:
        n = self.count.get(name, 0)
        return self.total[name] * 1e3 / n if n else None


class Marks:
    """Set-up's parts: the seconds since the process started at each named
    point, logged on standard error."""

    def __init__(self, t0: float):
        self.t0, self.marks = t0, []

    def __call__(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t0))

    def log(self) -> None:
        parts, last = [], 0.0
        for name, t in self.marks:
            parts.append(f"{name} {t - last:.2f}")
            last = t
        print(f"setup s: {'; '.join(parts)}", file=sys.stderr)


class HostProbe:
    """What the host did in a window: the CPU seconds of the main thread
    and of the whole process, the context switches, and the seconds the
    garbage collector took by generation."""

    def __init__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s[info["generation"]] += time.perf_counter() - self._t
            self._t = None

    @staticmethod
    def _usage():
        return (resource.getrusage(resource.RUSAGE_THREAD),
                resource.getrusage(resource.RUSAGE_SELF))

    def __enter__(self):
        self.before = self._usage()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.after = self._usage()

    def summary(self) -> str:
        (t0, p0), (t1, p1) = self.before, self.after
        cpu = (lambda a, b: b.ru_utime + b.ru_stime - a.ru_utime - a.ru_stime)
        return (f"main thread cpu s {cpu(t0, t1):.3f}, process cpu s "
                f"{cpu(p0, p1):.3f}, switches voluntary "
                f"{p1.ru_nvcsw - p0.ru_nvcsw} involuntary "
                f"{p1.ru_nivcsw - p0.ru_nivcsw}, gc ms by generation "
                f"{[round(x * 1e3, 1) for x in self.gc_s]}")


def log_window(times, spans: "Spans", probe: Optional[HostProbe] = None,
               window_s: Optional[float] = None) -> None:
    """The window's per-step (or per-batch) seconds, its spans' means and
    what the host did in it, on standard error: what a spread between runs
    comes from."""
    t = sorted(times)
    q = (lambda f: t[min(len(t) - 1, int(f * len(t)))] * 1e3)
    means = {k: round(spans.mean_ms(k), 3) for k in spans.total}
    host = (f"; window s {window_s:.3f}, {probe.summary()}"
            if probe is not None else "")
    print(f"window: {len(t)} x ms p10 {q(0.1):.1f} p50 {q(0.5):.1f} p90 "
          f"{q(0.9):.1f} max {t[-1] * 1e3:.1f}; span means ms {means}{host}",
          file=sys.stderr)


# -- the profiler's trace ----------------------------------------------------

def busy_ms(intervals) -> float:
    """Union of the device kernels' (start, end) intervals, in ms (us
    in)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def group_of(kernel: str) -> str:
    low = kernel.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)),
                "other")


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def reduce_profile(prof, spans: List[str]) -> dict:
    """From a torch.profiler run: the device kernels [(name, start_us,
    end_us)], the ATen ops on the host, the launches inside each harness
    span, the busy ms, and the host ranges of the harness spans."""
    import torch

    kernels, host_ops, launches, ranges = [], 0, [], {s: [] for s in spans}
    cpu = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's range on the device timeline is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in ranges):
                kernels.append((e.name, tr.start, tr.end))
            continue
        if e.name in ranges:
            ranges[e.name].append((tr.start, tr.end))
        elif e.name.startswith("aten::"):
            host_ops += 1
            cpu.append((tr.start, tr.end, e.name))
        elif e.name in LAUNCH_CALLS:
            launches.append(tr.start)
    return {"kernels": kernels, "host_ops": host_ops, "launches": launches,
            "ranges": ranges, "cpu_ops": cpu,
            "busy_ms": busy_ms((a, b) for _, a, b in kernels)}


def kernel_ms(red: dict, match) -> float:
    """Device ms of the kernels whose name ``match`` accepts."""
    return sum(b - a for n, a, b in red["kernels"] if match(n)) / 1e3


def group_ms(red: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n, a, b in red["kernels"]:
        g = group_of(n)
        out[g] = out.get(g, 0.0) + (b - a) / 1e3
    return out


def launches_in(red: dict, span: str) -> int:
    rs = red["ranges"].get(span, [])
    return sum(1 for t in red["launches"] if any(a <= t <= b for a, b in rs))


def breakdown(red: dict, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the harness span and the ATen op the
    host was in when the gap began."""
    by_name: Dict[str, float] = {}
    for name, a, b in red["kernels"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:n]
    iv = sorted((a, b) for _, a, b in red["kernels"])
    gaps, end = [], None
    for a, b in iv:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    cpu = red["cpu_ops"]
    named = []
    for a, b in gaps:
        span = next((s for s, rs in red["ranges"].items()
                     if any(x <= a <= y for x, y in rs)), "outside")
        op = min(((y - x, name) for x, y, name in cpu if x <= a <= y),
                 default=(0, ""))[1]
        named.append([f"{span}:{op}" if op else span, (b - a) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


# -- the card ---------------------------------------------------------------

def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def forbidden_modules() -> List[str]:
    """The JAX stack's modules this process holds, by whole top-level
    name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# -- a run ------------------------------------------------------------------

def result_line(cell: Cell, bench: dict, outcome: Outcome) -> dict:
    """The contract's last line: the cell's end-to-end metrics, or with
    ``--trace 1`` the per-layer metrics its readers find, then the
    numbers compared with their limits."""
    metrics = {}
    if cell.trace:
        for m in bench["per_layer"]:
            if cell.name not in m.get("workloads", [cell.name]):
                continue
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = (reader.read(outcome.trace)
                     if outcome.trace is not None else None)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if cell.name not in m.get("workloads", [cell.name]):
                continue
            if m["name"] in outcome.e2e:
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": dict(outcome.device)}
    if cell.trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float, tmp: str,
             root: str = HERE, config_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None,
             limits_override: Optional[dict] = None) -> Tuple[dict, Outcome]:
    """Runs one workload on ``device`` and returns (its last line, the
    driver's outcome). The overrides serve the CPU tests' tiny presets."""
    _, config, traffic, limits = find_cell(bench, workload, root)
    config = dict(config, **(config_override or {}))
    traffic = dict(traffic, **(traffic_override or {}))
    limits = limits_override or limits
    cell = Cell(workload, config, traffic, seed, seconds, trace, device, tmp,
                t0, limits)
    outcome = driver(traffic, root).run(cell)
    return result_line(cell, bench, outcome), outcome
