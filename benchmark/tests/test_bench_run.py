"""A whole run of each cell at a small size on the CPU, the look for a card
skipped: sound, it is correct; with the timed path broken underneath, it is
not.  And what the run and the references import."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.held_out import SPEC

SMALL = {
    "kmv-mlp.pairs28m": ["solver.train.n_time_stamps=3", "solver.train.sample_per_time=40",
                         "neural_network.hidden_dim=8", "neural_network.layers=2",
                         "neural_network.feature_dim=8", "train.steps_per_chunk=5", "test.frequency=5"],
    "kgmm-np-online.paths250k": ["solver.train.batch_size_0T=16", "pde_instance.n_steps=10",
                                 "neural_network.hidden_dim=16", "neural_network.feature_dim=8",
                                 "neural_network.fourier_features=4", "train.steps_per_chunk=5",
                                 "test.frequency=5"],
}
CELLS = sorted(SMALL)


def small_run(cell_name: str, seed: int = 2**31 + 11):
    torch.set_num_threads(1)
    cell = harness.find_cell(cell_name, spec=SPEC)
    cell.workload.update(calibration_steps=2, trace_steps=3)
    return harness.run_cell(cell, seed, 0.2, False, time.perf_counter(), device="cpu",
                            extra_overrides=SMALL[cell_name])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = small_run(cell)
    assert out.correct, out.check
    assert out.attempted >= 10 and out.failed == 0
    assert set(out.metrics) == {"steps_per_s", "setup_s"}


def _unchanged_state(monkeypatch):
    from pde_inverse_torch.training import optimizers
    update = optimizers.Optimizer.update

    def no_step(self, grads, state, params):
        updates, new_state = update(self, grads, state, params)
        return {k: torch.zeros_like(u) for k, u in updates.items()}, new_state

    monkeypatch.setattr(optimizers.Optimizer, "update", no_step)


def _half_batch(monkeypatch):
    from pde_inverse_torch import methods
    sample = methods.ConsistencyBased.sample_data

    def half(self, key, *a, **kw):
        out = sample(self, key, *a, **kw)
        return {k: (v if k.startswith("tau") else v[: v.shape[0] // 2]) for k, v in out.items()}

    monkeypatch.setattr(methods.ConsistencyBased, "sample_data", half)


def _altered_answer(monkeypatch):
    from pde_inverse_torch import methods
    step = methods.ConsistencyBased.value_and_grad_fn

    def altered(self, *a, **kw):
        out = step(self, *a, **kw)
        first = next(iter(out["grad"]))
        out["grad"][first] = out["grad"][first] * 1.1
        return out

    monkeypatch.setattr(methods.ConsistencyBased, "value_and_grad_fn", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer],
                         ids=["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = small_run(cell)
    assert not out.correct, out.check


def test_run_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_run import small_run, CELLS\n"
        "for c in CELLS: assert small_run(c).correct\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'pde_inverse_tpu'}))\n"
    ) % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []


def test_references_import_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.kmv, benchmark.reference.kgmm, benchmark.check\n"
        "import benchmark.work.kmv_pairwise, benchmark.work.kfp_pointwise, benchmark.inits.potential_mlp\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'pde_inverse_torch', 'jax', 'pde_inverse_tpu'}))\n"
    ) % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
