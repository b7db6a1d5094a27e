"""Runs with the timed path broken underneath come out not correct: a
step that returns its state unchanged, half the batch left out (the mean
over the rest), a served token altered where it is produced. (A one-card
cell has no exchange between chips to leave out.) And the control, the
reference in float8 in the program's place, fails a limit."""

import pytest

from conftest import TINY_CONFIG, TINY_LIMITS, TINY_TRAFFIC, tiny_run


@pytest.mark.parametrize("workload,fault", [
    ("meta.flagship", "state_unchanged"), ("meta.flagship", "half_batch"),
    ("greedy.flagship", "token_altered")])
def test_fault_is_not_correct(workload, fault, bench, tmp_path):
    from faults import FAULTS

    with FAULTS[fault]():
        line, _ = tiny_run(bench, workload, 31, tmp_path)
    assert line["correct"] is False


@pytest.mark.parametrize("workload", ["meta.flagship", "greedy.flagship"])
def test_sound_run_is_correct(workload, bench, tmp_path):
    line, _ = tiny_run(bench, workload, 31, tmp_path)
    assert line["correct"] is True


@pytest.mark.parametrize("workload", ["meta.flagship", "greedy.flagship"])
def test_control_fails_a_limit(workload, bench):
    import control
    import harness

    driver = harness.find_cell(bench, workload)[2]["driver"]
    numbers = control.control_reading(bench, workload, 31, "cpu",
                                      TINY_CONFIG, TINY_TRAFFIC[driver])
    assert control.judged(numbers, TINY_LIMITS[driver]) is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["meta.flagship", "meta.conformer17",
                                      "greedy.flagship"])
def test_control_fails_on_the_card(workload, bench, card):
    """The control at the cell's own size fails the cell's limits: a run
    with its numbers would print ``correct`` false."""
    import control
    import harness

    limits = harness.find_cell(bench, workload)[3]
    numbers = control.control_reading(bench, workload, 41, card)
    assert control.judged(numbers, limits) is False
