"""Settings of the benchmark's own tests: the harness's folder on the
import path, the ``cuda`` marker (tests that need the card decide inside
the ``card`` fixture, never at import), and the tiny preset the CPU runs
use."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_CONFIG = {"num_enc_layers": 1, "num_dec_layers": 1, "dim_model": 32,
               "num_heads": 2, "dim_key": 16, "dim_value": 16,
               "dim_inner": 32, "dim_emb": 32, "r": 8, "labels": 60,
               }
SHORT = {"median": 1.0, "sigma": 0.35, "min": 0.5, "max": 1.9}
TINY_TRAFFIC = {
    "meta_train": {"utterances_per_task": 6, "duration_s": SHORT,
                   "k_train": 2, "k_valid": 2, "profiled_steps": 1},
    "greedy_serve": {"utterances_per_task": 8, "duration_s": SHORT,
                     "batch": 2, "checked_batches": 2,
                     "profiled_batches": 1},
}
# the tiny preset's limits, for its tests on the CPU: above its sound bf16
# readings (loss1 2e-5-2.9e-4, grad1 median 0.0015-0.0059, change3 median
# 0.0007-0.0032, logit 0-0.009) and below its control's loss1 (1.8e-3) and
# logit (0.11) and its faults' readings
TINY_LIMITS = {
    "meta_train": {"loss1_gap": 8e-4, "grad1_median": 0.012,
                   "change3_median": 0.006},
    "greedy_serve": {"logit_gap": 0.04},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips on a host without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python3 -m pytest "
                    "benchmark/tests -m cuda` on the H100")
    return "cuda"


@pytest.fixture(scope="session")
def bench():
    import harness

    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_run(bench, workload, seed, tmp_path, trace=False, seconds=0.5,
             device="cpu"):
    """(last line, outcome) of a run of ``workload`` at the tiny preset."""
    import time

    import harness

    traffic = harness.find_cell(bench, workload)[2]
    return harness.run_cell(
        bench, workload, seed, seconds, trace, device, time.perf_counter(),
        str(tmp_path), config_override=TINY_CONFIG,
        traffic_override=TINY_TRAFFIC[traffic["driver"]],
        limits_override=TINY_LIMITS[traffic["driver"]])
