"""The port's streamed offline non-parametric KGMM training steps held
against the plain float64 reference (``benchmark/reference/kgmm_offline.py``:
plain PyTorch, importing neither the port nor JAX), on the CPU at a small
size.

The job is the benchmark's configuration ``kgmm-np-offline-xl`` (the preset
``KGMM-nonparametric-offline-XL`` at its published widths: Fourier
PotentialMLP 4 + 2 * 64 -> 64 -> 64 -> 256 tanh with the quadratic head,
BAOAB, clipping, weight decay, the tracked EMA from the first step) on a
run-private store of 300 trajectories of 40 steps, 600 initial and 300
terminal points, 16 trajectories a step, from seeded random weights drawn
by the configuration's initialiser.  The port's first 3 steps run through
``Trainer.fit`` in float32, their batches gathered from the host store;
the reference simulates the gathered trajectories and the boundary sets
again in float64 from the store's key layout (on the CPU the plain
simulator's ``torch.Generator`` stream) and follows the steps from the
same weights.  The numbers are ``benchmark/check.py``'s, held to the
cell's own limits.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, harness  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402

torch.set_num_threads(1)

CELL = "kgmm-np-offline-xl.stream655k"
SMALL = ["pde_instance.sample_0T_size=300", "pde_instance.n_steps_0T=40",
         "solver.train.offline_traj_batch=16", "pde_instance.sample_initial_size=600",
         "pde_instance.sample_terminal_size=300", "pde_instance.n_steps_terminal=40"]
N_CHECK = 3
# the cell's limits (PERF.md, section 2): a sound gap here is float32
# rounding through 40 BAOAB steps, the network's jets and the loss's sums
# over 128 path and 900 boundary points, ~1e-6 at most
LIMITS = harness.find_cell(CELL).workload["limits"]


def _gaps(seed: int) -> dict:
    cell = harness.find_cell(CELL)
    cfg, trainer, params0, rec, ran = harness.build(cell, seed, "cpu", SMALL)
    program = harness.check_steps(cfg, trainer, rec, params0, N_CHECK)
    changed = {o.partition("=")[0]: ran[o.partition("=")[0]] for o in SMALL}
    ref_cfg = {"settings": {**cell.settings, **changed, "seed": seed},
               "problem": cell.config["problem"]}
    ref = cell.module("reference").follow_cell(ref_cfg, seed, params0, "cpu", n_steps=N_CHECK)
    return check.gaps(program, ref)


@pytest.mark.parametrize("seed", [5, 2**31 + 2, 2**32 + 5])
def test_port_steps_follow_the_reference(seed):
    gaps = _gaps(seed)
    assert all(gaps[k] <= LIMITS[k] for k in LIMITS), gaps


# each fault of ``benchmark/faults.py`` and the numbers it must fail
FAILS = {
    "unchanged_state": ["change_gap"],
    "half_batch": ["loss_gap", "grad_gap", "change_gap"],
    "altered_answer": ["grad_gap", "change_gap"],
}


@pytest.mark.parametrize("fault", sorted(FAILS))
def test_planted_fault_fails_the_limits(fault, monkeypatch):
    fails = FAILS[fault]
    FAULTS[fault](monkeypatch)
    gaps = _gaps(2**31 + 2)
    assert all(gaps[k] > LIMITS[k] for k in fails), gaps
