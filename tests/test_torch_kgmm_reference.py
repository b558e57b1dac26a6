"""The port's online non-parametric KGMM training steps held against the
plain float64 reference (``benchmark/reference/kgmm.py``: plain PyTorch,
importing neither the port nor JAX), on the CPU at a small size.

The job is the benchmark's configuration ``kgmm-np-online`` (the preset
``KGMM-nonparametric-online`` at its published widths: Fourier
PotentialMLP 4 + 2 * 64 -> 64 -> 64 -> 256 tanh, BAOAB, clipping, weight
decay, EMA from the first step) with 16 trajectories of 10 steps, from
seeded random weights drawn by the configuration's initialiser.  The
port's first 3 steps run through ``Trainer.fit`` in float32; the reference
follows them in float64 from the same weights and the same random stream
(on the CPU the plain simulator's ``torch.Generator``).  The numbers are
``benchmark/check.py``'s: ``loss_gap``, ``grad_gap`` and ``change_gap``.
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

CELL = "kgmm-np-online.paths1m"
SMALL = ["solver.train.batch_size_0T=16", "pde_instance.n_steps=10"]
N_CHECK = 3

# Each tolerance sits about 10x above the largest gap of 25 sound seeds
# (1-12, 2**31 + 0-11, 2**32 + 5) and far below what a planted fault reads.
# A sound gap is float32 rounding: the sampled states carry it through 10
# BAOAB steps, the network's jets and the loss's sums over 80 path and 960
# boundary points add theirs.
TOLERANCE = {
    # the loss over the sum of its terms' magnitudes: sound <= 2.9e-6
    # (2**31 + 2); half the batch reads >= 0.067
    "loss_gap": 3e-5,
    # the worst leaf's first-gradient norm: sound <= 6.2e-7; one leaf's
    # gradient 10 % off reads 0.1, half the batch >= 0.33
    "grad_gap": 1e-5,
    # the worst leaf's change after 3 steps: sound <= 2.0e-6; one leaf's
    # gradient 10 % off reads >= 7.2e-4 (through Adam's normalisation), half
    # the batch >= 4e-3, a state left unchanged 1
    "change_gap": 3e-5,
}


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
    assert all(gaps[k] <= TOLERANCE[k] for k in TOLERANCE), gaps


# each fault of ``benchmark/faults.py`` and the numbers it must fail
FAILS = {
    "unchanged_state": ["change_gap"],
    "half_batch": ["loss_gap", "grad_gap", "change_gap"],
    "altered_answer": ["grad_gap", "change_gap"],
}


@pytest.mark.parametrize("fault", sorted(FAILS))
def test_planted_fault_fails_the_tolerances(fault, monkeypatch):
    fails = FAILS[fault]
    FAULTS[fault](monkeypatch)
    gaps = _gaps(2**31 + 2)
    assert all(gaps[k] > TOLERANCE[k] for k in fails), gaps
