"""A short run of each driver on the CPU at the tiny preset: the shape of
the contract's last line, and the refusals of ``run.py``."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_run

# on the CPU: no device reading (train_peak_gib, serve_peak_gib) is written
E2E = {"meta.flagship": {"train_utt_per_s", "setup_s"},
       "meta.conformer17": {"train_utt_per_s", "setup_s"},
       "greedy.flagship": {"setup_s"}}


@pytest.mark.parametrize("workload", sorted(E2E))
def test_last_line_shape(workload, bench, tmp_path):
    line, outcome = tiny_run(bench, workload, 2 ** 31 + 5, tmp_path,
                             seconds=1.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == E2E[workload]
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert line["device"]["platform"] == "cpu"  # never named a device's
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)
    assert not os.listdir(tmp_path)  # the corpus is gone


@pytest.mark.parametrize("workload", ["meta.flagship", "greedy.flagship"])
def test_traced_line(workload, bench, tmp_path):
    line, outcome = tiny_run(bench, workload, 3, tmp_path, trace=True)
    assert line["correct"] is True
    names = {m["name"] for m in bench["per_layer"]
             if workload in m["workloads"]}
    # on the CPU only host-side readings exist: no device metric is named
    assert set(line["metrics"]) <= names
    assert not any(k in line["metrics"] for k in names
                   if "roofline" in k or "mfu" in k or "idle" in k)
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def _run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_refuses_without_a_card():
    out = _run_py(["--workload", "meta.flagship", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], ROOT,
                  env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(["--workload", "greedy.flagship", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_workload(bench):
    import harness

    with pytest.raises(KeyError):
        harness.find_cell(bench, "no.such")
