"""A whole run of ``kgmm-np-offline-xl.stream655k`` on the CPU at a small
size (a run-private store of 300 trajectories of 40 steps, 16 a step, the
configuration's published widths), the look for a card skipped: sound, its
``correct`` flag is set; with each fault of ``benchmark/faults.py`` planted
in the program, it is not.  The cell's work counter and the streaming
loader's two readers, on a synthetic trace.  The gaps themselves are held
in ``tests/test_torch_kgmm_offline_reference.py``."""

import time

import pytest
import torch

from benchmark import harness, trace
from benchmark.faults import FAULTS
from benchmark.work.kfp_pointwise import langevin_work

CELL = "kgmm-np-offline-xl.stream655k"
SMALL = ["pde_instance.sample_0T_size=300", "pde_instance.n_steps_0T=40",
         "solver.train.offline_traj_batch=16", "pde_instance.sample_initial_size=600",
         "pde_instance.sample_terminal_size=300", "pde_instance.n_steps_terminal=40",
         "train.steps_per_chunk=5", "test.frequency=5"]


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


def test_cell_work_at_the_cells_size():
    cell = harness.find_cell(CELL)
    work = cell.module("work").cell_work(cell.settings, cell.config["problem"])
    # 8,192 trajectories x 80 stamps; K3's 4 F and K4's 10 F over 64 -> 64 -> 256
    assert work["pointwise"]["flops"] == 2.0 * 655_360 * 14 * (64 * 64 + 64 * 256)
    # the test's K1 every 100 steps: 1,024 trajectories of 100 BAOAB steps
    # kept whole, 30,720 particles to T, over the 100 steps
    path, term = langevin_work(1024, 100, 4, 3, True), langevin_work(30_720, 100, 4, 3, False)
    assert work["langevin"] == {"flops": (path[1] + term[1]) / 100, "bytes": (path[0] + term[0]) / 100}
    head = 2.0 * (655_360 + 700_000) * 6 * 16
    whole = 132 * 64 + 64 * 64 + 64 * 256
    assert work["step"]["flops"] == (work["pointwise"]["flops"] + 2.0 * 655_360 * 6 * 132 * 64
                                     + 2.0 * 700_000 * 6 * whole + head)


def _context(gaps, device_us, counts, steps=100):
    summary = trace.Summary(device_us, counts, 1.0, [], gaps)
    return trace.Context(summary=summary, steps=steps, window_s=2.0, step_s=0.1, work={}, peak=None)


def test_loader_readers_read_the_gather_gap_and_the_uploads():
    gather = harness.load_metric("gather_idle_ms_per_step")
    upload = harness.load_metric("upload_ms_per_step")
    ctx = _context([("pde.gather", 5.0), ("pde.step > aten::view", 0.01), ("pde.test", 0.02)],
                   {"Memcpy HtoD (Pageable -> Device)": 400_000.0, "k4_kernel": 9.0e5},
                   {"Memcpy HtoD (Pageable -> Device)": 3, "k4_kernel": 100})
    assert gather.read(ctx) == pytest.approx(50.0)
    assert upload.read(ctx) == pytest.approx(4.0)
    # a cell with no streaming gather and no copy to the device reads nothing
    none = _context([("pde.step > aten::view", 0.01)], {"k4_kernel": 9.0e5}, {"k4_kernel": 100})
    assert gather.read(none) is None and upload.read(none) is None
