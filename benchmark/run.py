"""The benchmark of the PyTorch and CUDA port (``mtl_tpu_torch``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

runs one workload of ``BENCHMARK.json`` on the card this process finds
and prints, as its last line of standard output, one JSON object: whether
what the timed path produced is correct, the requests attempted and
failed, the workload's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``), the device, and last the numbers compared with
their limits (also the last lines of standard error). It fails, printing
no result, without a CUDA card, or when the JAX stack is loaded once the
window has closed.

Caches (the kernels' nvcc builds under ``build/kernels``, Triton's and
CUDA's) live at fixed paths inside the checkout; the corpus is written
under ``$TMPDIR`` and removed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _env():
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = harness.find_cell(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="mtlbench-")
    try:
        line, _ = harness.run_cell(bench, args.workload, args.seed,
                                   args.seconds, bool(args.trace), "cuda",
                                   T0, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the JAX stack is loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
