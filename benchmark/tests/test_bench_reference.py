"""The plain reference against the program on the CPU at the tiny
preset in float32: the same batches, weights and dropout masks give the
same losses, gradients and weights, and the same served logits."""

import pytest

from conftest import TINY_CONFIG, TINY_LIMITS, TINY_TRAFFIC


def _run(bench, workload, seed, tmp_path, dtype):
    import time

    import harness

    traffic = harness.find_cell(bench, workload)[2]
    return harness.run_cell(
        bench, workload, seed, 0.3, False, "cpu", time.perf_counter(),
        str(tmp_path), config_override=dict(TINY_CONFIG, dtype=dtype),
        traffic_override=TINY_TRAFFIC[traffic["driver"]],
        limits_override=TINY_LIMITS[traffic["driver"]])


@pytest.mark.parametrize("workload", ["meta.flagship", "meta.conformer17"])
def test_meta_step_in_f32_matches(workload, bench, tmp_path):
    _, outcome = _run(bench, workload, 21, tmp_path, "float32")
    c = outcome.readings
    # f32 on both sides: rounding in other orders only
    assert c["loss_gap"] < 1e-5
    assert c["grad1_gap"] < 1e-3
    assert c["change3_gap"] < 1e-3


def test_served_logits_in_f32_match(bench, tmp_path):
    line, _ = _run(bench, "greedy.flagship", 22, tmp_path, "float32")
    assert line["checks"]["logit_gap"]["value"] < 1e-5


def test_quiet_leaves_are_left_out_of_the_change():
    from reference import check

    ref = {"losses": [1.0], "g1": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "delta": {"a": 1.0, "b": 1.0, "c": 1e-6}}
    mine = {"losses": [1.0], "g1": dict(ref["g1"]),
            "delta": {"a": 1.0, "b": 1.0, "c": 5e-6}}
    out = check.meta_numbers(mine, ref)
    assert out["change3_gap"] == 0.0  # c moves by round-off alone
    mine["delta"]["a"] = 1.1
    out = check.meta_numbers(mine, ref)
    assert out["change3_gap"] == pytest.approx(0.1)
    assert out["change3_median"] == pytest.approx(0.05)  # of a and b
