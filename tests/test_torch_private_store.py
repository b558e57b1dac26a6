"""The streamed offline store of a run's own, on the CPU at a small size:
with no ``pde_instance.dataset_path`` the KGMM problem generates its store
in a fresh directory under ``tempfile.gettempdir()`` and removes it when the
instance is collected, when the process exits or when set-up raises; two
instances never share one; a given ``dataset_path`` keeps its store."""

import gc
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_inverse_torch import config as config_lib
from pde_inverse_torch import main as tmain
from pde_inverse_torch.methods import ConsistencyBased, functional_forward
from pde_inverse_torch.problems.kfp_gmm import GROUND_TRUTH_FILE, KineticFokkerPlanckGMM
from pde_inverse_torch.training.trainer import Trainer

torch.set_num_threads(1)

SMALL = ["pde_instance.sample_initial_size=240", "pde_instance.sample_terminal_size=120",
         "pde_instance.sample_0T_size=30", "pde_instance.n_steps_0T=20",
         "pde_instance.n_steps_terminal=20", "pde_instance.n_steps=10", "logging.writer=none",
         "neural_network.hidden_dim=16", "neural_network.feature_dim=8",
         "neural_network.fourier_features=4", "solver.train.offline_traj_batch=8",
         "train.number_of_iterations=6", "train.steps_per_chunk=3", "test.frequency=0",
         "train.optimizer.ema_switch_step=2"]


@pytest.fixture
def tmp(tmp_path, monkeypatch):
    """tempfile's directory pointed at an empty one of the test's own."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _cfg(path="", extra=()):
    return config_lib.preset("KGMM-nonparametric-offline-XL",
                             SMALL + [f"pde_instance.dataset_path={path}", *extra])


def _stores(tmp):
    """The stores under tempfile's directory (PyTorch keeps caches of its own there)."""
    return sorted(p.name for p in tmp.iterdir() if p.name.startswith("kgmm_store_"))


def test_an_empty_dataset_path_streams_from_a_store_of_its_own(tmp):
    cfg = _cfg()
    inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
    (store,) = _stores(tmp)
    where = tmp / store
    assert os.path.dirname(str(where)) == tempfile.gettempdir()
    assert isinstance(inst.dataset_stream["0T"], np.memmap) and "0T" not in inst.dataset
    assert (where / "manifest.json").exists() and (where / GROUND_TRUTH_FILE).exists()
    assert inst.data_timing["bytes"] > 0
    method = ConsistencyBased(inst, cfg, 1, "cpu")
    model, params = method.create_model_fn()
    trainer = Trainer(cfg, method, 2, functional_forward(model), params)
    trainer.fit()
    assert np.isfinite(trainer.losses).all() and trainer.losses.shape == (6,)
    # each chunk of 3 steps stages 8 trajectories x 4 stamps of [x | v] and
    # their stamps a step
    assert trainer.gather_bytes == [3 * 8 * 4 * (8 + 1) * 4] * 2
    del inst, method, trainer
    gc.collect()
    assert _stores(tmp) == []


def test_two_instances_with_other_seeds_keep_stores_apart(tmp):
    cfg = _cfg()
    a, b = KineticFokkerPlanckGMM(cfg, 0, "cpu"), KineticFokkerPlanckGMM(cfg, 1, "cpu")
    assert len(_stores(tmp)) == 2
    assert not torch.equal(a.configuration["mus"], b.configuration["mus"])
    assert not np.array_equal(a.dataset_stream["0T"], b.dataset_stream["0T"])
    del a
    gc.collect()
    assert len(_stores(tmp)) == 1 and np.isfinite(b.dataset_stream["0T"]).all()
    b.store_cleanup()
    assert _stores(tmp) == []


def test_a_store_is_removed_when_its_set_up_raises(tmp, monkeypatch):
    def refuse(self, path, record, key):
        raise ValueError("refused")

    monkeypatch.setattr(KineticFokkerPlanckGMM, "_check_record", refuse)
    with pytest.raises(ValueError, match="refused"):
        KineticFokkerPlanckGMM(_cfg(), 0, "cpu")
    assert _stores(tmp) == []


def test_a_run_through_main_leaves_nothing_behind(tmp):
    out = tmain.run(_cfg(), "cpu")
    gc.collect()
    assert np.isfinite(out.losses).all() and out.data_timing["bytes"] > 0
    assert len(out.gather_seconds) == 2 and _stores(tmp) == []


def test_a_given_dataset_path_keeps_its_store(tmp, tmp_path_factory, monkeypatch):
    path = tmp_path_factory.mktemp("given") / "store"
    inst = KineticFokkerPlanckGMM(_cfg(path), 0, "cpu")
    first = np.array(inst.dataset_stream["0T"])
    assert inst.store_cleanup is None
    del inst
    gc.collect()
    assert (path / "manifest.json").exists() and _stores(tmp) == []

    def regenerate(self, path, key):
        raise AssertionError("a store at a given path is generated once")

    monkeypatch.setattr(KineticFokkerPlanckGMM, "_generate_dataset_to_store", regenerate)
    again = KineticFokkerPlanckGMM(_cfg(path), 0, "cpu")
    np.testing.assert_array_equal(again.dataset_stream["0T"], first)


def test_a_process_that_ends_by_an_exception_leaves_nothing_behind(tmp_path):
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from pde_inverse_torch import config as config_lib\n"
        "from pde_inverse_torch.problems.kfp_gmm import KineticFokkerPlanckGMM\n"
        "inst = KineticFokkerPlanckGMM(config_lib.preset('KGMM-nonparametric-offline-XL', %r), 0, 'cpu')\n"
        "print(inst.store_cleanup.peek()[2][0], flush=True)\n"
        "raise RuntimeError('the run fails after set-up')\n"
    ) % (str(Path(__file__).resolve().parents[1]), SMALL + ["pde_instance.dataset_path="])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 1 and "the run fails after set-up" in out.stderr
    store = out.stdout.strip().splitlines()[-1]
    assert os.path.dirname(store) == str(tmp_path) and not os.path.exists(store)
