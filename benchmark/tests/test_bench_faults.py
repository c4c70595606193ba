"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; and so does the control, the reference
in float32 put in the program's place, at the cell's own size."""

import time

import pytest

from benchmark import faults, harness

CELL_FAULTS = [("ising12.train", "unchanged"), ("ising12.train", "altered"),
               ("ising12.train", "late_altered"),
               ("ising12.population", "unchanged"), ("ising12.population", "half_batch"),
               ("ising12.population", "altered"), ("ising12.population", "late_altered")]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_bench_fault_is_not_correct(tiny, workload, fault):
    def broken(session):
        faults.plant(session.loop, fault, int(session.cell.traffic["setup_epochs"]))

    res = harness.run_cell(workload, 5, 0.2, False, time.perf_counter(), root=tiny,
                           device="cpu", log=lambda s: None, session_hook=broken)
    assert res["correct"] is False
    if fault == "late_altered":
        # the set-up epochs saw nothing: the window's epoch caught it
        assert {k for k, v in res["checks"].items() if v["value"] > v["limit"]} == {
            "window_loss_gap"}


def test_bench_sound_run_is_correct(tiny):
    res = harness.run_cell("ising12.train", 5, 0.2, False, time.perf_counter(), root=tiny,
                           device="cpu", log=lambda s: None)
    assert res["correct"] is True


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_bench_control_is_not_correct(seed):
    # the 12-atom cell's own configuration, on the CPU
    import torch

    from benchmark.calibrate import readings

    torch.set_num_threads(2)
    cell = harness.resolve(harness.ROOT, "ising12.train")
    got = readings(cell, seed, "control", None, "cpu", 0)["readings"]
    ok, _ = harness.judge(got, cell.limits)
    assert not ok, got
