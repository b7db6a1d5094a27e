"""Readings that the correctness check's limits are set from, on the card
at a cell's own size, several seeds in one process:

* the program's numbers (a run's set-up and checked steps or batches, and
  a short window);
* the control's: the plain reference computed with float8 e4m3 operands
  (``reference/model.py:fp8_round``) in the program's place, judged by the
  float32 reference;
* with ``--fault``, the program's numbers with a fault planted underneath
  (``faults.py``).

Each line also says whether the numbers pass the cell's limits
(``limits/<workload>.json``) by the rule of a run's ``correct``
(``harness.Outcome.correct``): the program's have to, the control's and a
fault's must not.

    python3 benchmark/control.py --workload meta.flagship --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--fault half_batch --fault-seeds 7 8 9]

prints one JSON line a reading. Set-up and the window of each program run
are the benchmark's own (``harness.run_cell``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402
from corpus import make_corpus  # noqa: E402
from faults import FAULTS  # noqa: E402
from reference import check  # noqa: E402


def program_reading(bench, workload, seed, seconds, device, fault=None,
                    **overrides):
    tmp = tempfile.mkdtemp(prefix="mtlbench-")
    try:
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            _, outcome = harness.run_cell(bench, workload, seed, seconds,
                                          False, device, time.perf_counter(),
                                          tmp, **overrides)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
    return outcome.readings


def control_reading(bench, workload, seed, device, config_override=None,
                    traffic_override=None):
    """The control's numbers: the fp8 reference against the f32 one. A
    meta cell's three steps; a serving cell's ``checked_batches`` batches
    of the manifest, decoded greedily by the f32 reference itself so that
    the positions and tokens are the f32 model's."""
    import torch

    entry, config, traffic, _ = harness.find_cell(bench, workload)
    config = dict(config, **(config_override or {}))
    traffic = dict(traffic, **(traffic_override or {}))
    seeds = harness.derived_seeds(seed)
    tmp = tempfile.mkdtemp(prefix="mtlbench-")
    try:
        corpus = make_corpus(os.path.join(tmp, "corpus"), config, traffic,
                             seed)
        vocab = config["labels"] + 4
        if traffic["driver"] == "meta_train":
            f32 = check.reference_meta(config, corpus, seeds, traffic, device,
                                       vocab)
            low = check.reference_meta(config, corpus, seeds, traffic, device,
                                       vocab, quant="fp8")
            return check.meta_numbers(low, f32)
        served = [{"index": i, "batch": traffic["batch"],
                   "tokens": check.reference_greedy(
                       config, corpus, seeds, device, vocab, i,
                       traffic["batch"])}
                  for i in range(traffic["checked_batches"])]
        out = check.served_gaps(config, corpus, seeds, device, vocab, served,
                                quant="fp8")
        return {"logit_gap": out["logit_gap"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()


def judged(numbers: dict, limits: dict) -> bool:
    """Whether ``numbers`` pass ``limits``, as a run's ``correct`` judges
    its checks."""
    return harness.Outcome(0, 0, {}, {k: (numbers[k], lim)
                                      for k, lim in limits.items()}).correct


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py reads the card; torch finds none", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    limits = harness.find_cell(bench, args.workload)[3]
    runs = ([("program", s, None) for s in args.seeds]
            + [("control", s, None) for s in args.control_seeds]
            + [("fault", s, args.fault) for s in args.fault_seeds])
    for kind, seed, fault in runs:
        t = time.perf_counter()
        if kind == "control":
            numbers = control_reading(bench, args.workload, seed, "cuda")
        else:
            numbers = program_reading(bench, args.workload, seed,
                                      args.seconds, "cuda", fault)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "fault": fault, "seed": seed,
                          "correct": judged(numbers, limits),
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
