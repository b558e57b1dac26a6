"""A whole run of ``kgmm-np-online.paths1m`` on the CPU at a small size (16
trajectories of 10 steps, the configuration's published widths), the look
for a card skipped: sound, its ``correct`` flag is set; with each fault of
``benchmark/faults.py`` planted in the program, it is not.  And the cell's
per-layer metrics are those its configuration's work counter can feed.
The gaps themselves, against tolerances of their own, are held in
``tests/test_torch_kgmm_reference.py``."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.faults import FAULTS

CELL = "kgmm-np-online.paths1m"
SMALL = ["solver.train.batch_size_0T=16", "pde_instance.n_steps=10", "train.steps_per_chunk=5",
         "test.frequency=5"]


def small_run(seed: int = 2**31 + 13):
    torch.set_num_threads(1)
    cell = harness.find_cell(CELL)
    cell.workload.update(calibration_steps=2, trace_steps=3)
    return harness.run_cell(cell, seed, 0.2, False, time.perf_counter(), device="cpu",
                            extra_overrides=SMALL)


def test_sound_run_is_correct():
    out = small_run()
    assert out.correct, out.check
    assert out.attempted >= 10 and out.failed == 0
    assert set(out.metrics) == {"steps_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = small_run()
    assert not out.correct, out.check


def test_cell_metrics_have_their_work():
    cell = harness.find_cell(CELL)
    work = cell.module("work").cell_work(cell.settings, cell.config["problem"])
    listed = [m["name"] for m in cell.spec["per_layer"] if CELL in m.get("workloads", [CELL])]
    assert {"pointwise_roofline", "langevin_roofline", "step_mfu"} <= set(listed)
    # 10,000 trajectories x 100 strided states; 300,000 terminal particles
    # simulated 201 BAOAB steps besides the path's 10,000
    assert work["pointwise"]["flops"] == 2.0 * 1_000_000 * 14 * (64 * 64 + 64 * 256)
    assert work["langevin"]["flops"] == 310_000 * 201 * (6 * 4 + 3 * (8 * 4 + 5) + 4 + 1 + 10 * 4 + 3)
    assert all(harness.load_metric(m).KERNELS for m in ("langevin_ms_per_step", "pointwise_ms_per_step"))
