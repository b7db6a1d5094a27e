"""Every cell of ``BENCHMARK.json`` finds its files by name, and the file
keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


WORKLOADS = [w["name"] for w in _bench()["workloads"]]
CONFIGS = [c["file"] for c in _bench()["configs"]]
PER_LAYER = [m["name"] for m in _bench()["per_layer"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_lookup(workload, bench):
    import harness

    entry, config, traffic, limits = harness.find_cell(bench, workload)
    assert config["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    assert hasattr(harness.driver(traffic), "run")
    # every compared number is one the check computes
    leaf = [f"{n}_{s}" for n in ("grad1", "change3")
            for s in ("gap", "median", "p75", "p90", "mean")]
    check_names = {"meta_train": ["loss_gap", "loss1_gap"] + leaf,
                   "greedy_serve": ["logit_gap"]}[traffic["driver"]]
    assert limits and set(limits) <= set(check_names)
    assert all(0 < v < 1 for v in limits.values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(workload in m.get("workloads", [workload])
               for m in bench["per_layer"])


@pytest.mark.parametrize("file", CONFIGS)
def test_config_finds_its_encoder(file):
    from reference import encoders

    with open(os.path.join(ROOT, file), encoding="utf-8") as f:
        encoder_type = json.load(f)["encoder_type"]
    assert os.path.isfile(os.path.join(BENCH, "reference", "encoders",
                                       encoder_type + ".py"))
    enc = encoders.load(encoder_type)
    assert all(callable(getattr(enc, fn, None))
               for fn in ("param_shapes", "forward", "flops"))


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader_finds_nothing_in_an_empty_trace(metric):
    import harness

    reader = harness.load_module(os.path.join(BENCH, "metrics",
                                              metric + ".py"), "m")
    assert reader.read({}) is None


def test_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = {m["layer"] for m in b["per_layer"]}
    assert layers == {"serving loop", "host data", "meta step", "model",
                      "greedy decode", "kernels", "device"}
    assert all(m["moves"] in {e["name"] for e in b["end_to_end"]}
               for m in b["per_layer"])
