"""Offline KGMM in the port against the JAX package, on the CPU: the raw
array store in both directions, the offline subsample policy, whole offline
steps on a dataset the JAX package generated, the streaming loader and
trainer, sharded store generation and the refusal of a store made for
another ground truth or with other settings."""

import json

import jax
import numpy as np
import pytest
import torch

from pde_inverse_tpu import config as jax_config
from pde_inverse_tpu.methods import ConsistencyBased as JaxMethod
from pde_inverse_tpu.problems.kfp_gmm import KineticFokkerPlanckGMM as JaxKGMM
from pde_inverse_tpu.utils import data as jax_data
from pde_inverse_torch import config as config_lib
from pde_inverse_torch.convert import from_flax_params
from pde_inverse_torch.methods import ConsistencyBased, functional_forward, offline_batch
from pde_inverse_torch.problems import kfp_gmm
from pde_inverse_torch.problems.kfp_gmm import GROUND_TRUTH_FILE, KineticFokkerPlanckGMM
from pde_inverse_torch.training.trainer import Trainer
from pde_inverse_torch.utils import data as torch_data

torch.set_num_threads(1)

SMALL = ["pde_instance.sample_initial_size=240", "pde_instance.sample_terminal_size=120",
         "pde_instance.sample_0T_size=30", "pde_instance.n_steps_0T=20",
         "pde_instance.n_steps_terminal=20", "pde_instance.n_steps=10", "logging.writer=none"]
NP_SMALL = ["neural_network.hidden_dim=16", "neural_network.feature_dim=8"]
# one offline step against JAX on the same dataset and subsample: the same
# f32 arithmetic in another order (sums over 240 + 120 + 120 points)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _arrays(seed=0):
    rs = np.random.default_rng(seed)
    return {"initial": rs.normal(size=(50, 8)).astype(np.float32),
            "0T": rs.normal(size=(7, 11, 8)).astype(np.float32),
            "tau_0T": rs.uniform(size=(7, 11)).astype(np.float32),
            "count": np.arange(5, dtype=np.int64)}


@pytest.mark.parametrize("writer,reader", [(torch_data, jax_data), (jax_data, torch_data)])
def test_store_loads_in_the_other_package_bit_for_bit(writer, reader, tmp_path):
    arrays = _arrays()
    writer.save_array_store(str(tmp_path / "a"), arrays)
    inc = writer.ArrayStoreWriter(str(tmp_path / "b"))
    mm = inc.create("0T", (7, 11, 8), np.float32)
    mm[:4], mm[4:] = arrays["0T"][:4], arrays["0T"][4:]
    mm.flush()
    inc.finalize()
    for path, want in ((tmp_path / "a", arrays), (tmp_path / "b", {"0T": arrays["0T"]})):
        got = reader.load_array_store(str(path))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert isinstance(got[k], np.memmap) and got[k].dtype == v.dtype
            np.testing.assert_array_equal(np.asarray(got[k]), v)
    jax_data.save_array_store(str(tmp_path / "c"), arrays)
    assert (tmp_path / "a" / "manifest.json").read_text() == (tmp_path / "c" / "manifest.json").read_text()
    assert torch_data.store_bytes(str(tmp_path / "a")) == sum(v.nbytes for v in arrays.values())


def test_save_config_matches_jax(tmp_path):
    cfg_t = config_lib.preset("KGMM-offline")
    cfg_j = jax_config.preset("KGMM-offline")
    a = torch_data.save_config(cfg_t, str(tmp_path / "t"))
    b = jax_data.save_config(cfg_j, str(tmp_path / "j"))
    assert json.loads(open(a).read()) == json.loads(open(b).read())


def _jax_pair(preset, extra=()):
    """(cfg, JAX instance with its generated dataset, JAX method, port
    instance on that very dataset and ground truth, port method)."""
    cfg = config_lib.preset(preset, SMALL + list(extra))
    jcfg = jax_config.preset(preset, SMALL + list(extra))
    jinst = JaxKGMM(jcfg, jax.random.PRNGKey(0))
    jmethod = JaxMethod(pde_instance=jinst, cfg=jcfg, rng=jax.random.PRNGKey(1))
    dataset = {k: np.asarray(v) for k, v in jinst.dataset.items()}
    tinst = KineticFokkerPlanckGMM(cfg, 0, "cpu", configuration={
        "mus": np.asarray(jinst.configuration["mus"]), "dataset": dataset})
    tmethod = ConsistencyBased(tinst, cfg, 1, "cpu")
    return cfg, jinst, jmethod, tinst, tmethod


def _jax_draw(key, n_traj, n_time):
    """The JAX offline branch's (shift, traj_idx) for `key`
    (pde_inverse_tpu/methods.py:519-547)."""
    k_time, k_sample = jax.random.split(key)
    shift = int(jax.random.randint(k_time, [], 0, 5))
    idx = np.asarray(jax.random.permutation(k_sample, n_traj)[: n_traj // 5])
    return shift, torch.from_numpy(idx.astype(np.int64))


def test_offline_policy_matches_the_jax_branch():
    _, jinst, jmethod, tinst, tmethod = _jax_pair("KGMM-offline")
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jmethod._sample_data_unsharded(key, jinst.dataset)
        got = offline_batch(tinst.dataset, *_jax_draw(key, 30, 20))
        assert sorted(got) == sorted(want) == ["0T", "initial", "tau_0T_per_traj", "terminal"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["0T"].shape == (6 * 4, 8) and got["tau_0T_per_traj"].shape == (6, 4)


def test_offline_draw_shapes_and_determinism():
    cfg = config_lib.preset("KGMM-offline", SMALL)
    inst = KineticFokkerPlanckGMM(cfg, 3, "cpu")
    method = ConsistencyBased(inst, cfg, 4, "cpu")
    shift, idx = method.offline_draw(7, 30, 20)
    assert 0 <= shift < 5 and idx.shape == (6,) and len(set(idx.tolist())) == 6
    a, b = method.sample_data(7), method.sample_data(7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["initial"].shape == (240, 8) and a["terminal"].shape == (120, 8)
    assert a["0T"].shape == (24, 8)


@pytest.mark.parametrize("preset,extra", [("KGMM-offline", []),
                                          ("KGMM-nonparametric", NP_SMALL)])
def test_offline_step_matches_jax_on_its_dataset(preset, extra):
    """One whole offline step (subsample -> loss -> gradient) of the port,
    on the dataset the JAX package generated and the same subsample, against
    the JAX method's step."""
    _, jinst, jmethod, tinst, tmethod = _jax_pair(preset, extra)
    jnet, jparams = jmethod.create_model_fn()
    model, _ = tmethod.create_model_fn()
    tparams = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(tparams) == set(dict(model.named_parameters()))
    fwd = functional_forward(model)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        jout = jmethod.value_and_grad_fn(jnet.apply, jparams, key, dataset=jinst.dataset)
        k_sample, _ = jax.random.split(key)
        tmethod.offline_draw = lambda _k, n_traj, n_time: _jax_draw(k_sample, n_traj, n_time)
        tout = tmethod.value_and_grad_fn(fwd, tparams, seed, step=seed)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
        want = from_flax_params(jax.tree_util.tree_map(np.asarray, jout["grad"]))
        for k, g in want.items():
            err = float((tout["grad"][k] - g).abs().max()) / float(g.abs().max())
            assert err <= GRAD_RTOL, (k, err)


def _stream_cfg(store, extra=()):
    return config_lib.preset("KGMM-nonparametric-offline-XL", SMALL + NP_SMALL + [
        f"pde_instance.dataset_path={store}", "neural_network.fourier_features=4",
        "solver.train.offline_traj_batch=8", "train.number_of_iterations=6",
        "train.steps_per_chunk=3", "test.frequency=0", "train.optimizer.ema_switch_step=2",
        *extra])


def test_stream_gather_is_deterministic_and_shaped_as_jax(tmp_path):
    store = str(tmp_path / "store")
    cfg = _stream_cfg(store)
    inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
    assert "0T" not in inst.dataset and isinstance(inst.dataset_stream["0T"], np.memmap)
    method = ConsistencyBased(inst, cfg, 1, "cpu")
    a = method.gather_stream_chunk(inst.dataset_stream, [11, 12, 13])
    b = method.gather_stream_chunk(inst.dataset_stream, [11, 12, 13])
    c = method.gather_stream_chunk(inst.dataset_stream, [11, 12, 14])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k][:2], c[k][:2])
    assert not np.array_equal(a["0T"][2], c["0T"][2])
    jcfg = jax_config.preset("KGMM-nonparametric-offline-XL", SMALL + [f"pde_instance.dataset_path={store}",
                                                                      "solver.train.offline_traj_batch=8"])
    jmethod = JaxMethod.__new__(JaxMethod)
    jmethod.cfg = jcfg
    want = jmethod.gather_stream_chunk(inst.dataset_stream, jax.random.split(jax.random.PRNGKey(0), 3))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in want.items()}
    assert a["0T"].shape == (3, 8 * 4, 8) and a["tau_0T_per_traj"].shape == (3, 8, 4)
    # every gathered state is a stored state at a stamp of stride 5
    stamps = inst.dataset_stream["tau_0T"]
    assert np.isin(a["tau_0T_per_traj"], stamps).all()


def test_stream_gather_is_every_fifth_stamp_of_each_drawn_trajectory(tmp_path):
    """The gather against its definition, state by state: the step's
    Philox draw of a shift and sorted trajectories."""
    cfg = _stream_cfg(str(tmp_path / "store"))
    inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
    out = ConsistencyBased(inst, cfg, 1, "cpu").gather_stream_chunk(inst.dataset_stream, [21, 22])
    traj, stamps = inst.dataset_stream["0T"], inst.dataset_stream["tau_0T"]
    n_traj, n_time, d2 = traj.shape
    for i, key in enumerate([21, 22]):
        gen = np.random.Generator(np.random.Philox(key=key))
        shift = int(gen.integers(n_time - 3 * 5))
        rows = np.sort(gen.permutation(n_traj)[:8])
        want = [traj[r, shift + 5 * j] for r in rows for j in range(4)]
        np.testing.assert_array_equal(out["0T"][i], np.stack(want))
        np.testing.assert_array_equal(out["tau_0T_per_traj"][i],
                                      [[stamps[r, shift + 5 * j] for j in range(4)] for r in rows])


def test_streamed_trainer_runs_from_the_host_store(tmp_path):
    cfg = _stream_cfg(str(tmp_path / "store"))
    inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
    method = ConsistencyBased(inst, cfg, 1, "cpu")
    model, params = method.create_model_fn()
    seen = []
    real = method.value_and_grad_fn

    def spy(forward_fn, params, key, step=None, **kw):
        seen.append(kw["stream_batch"]["0T"].shape)
        return real(forward_fn, params, key, step=step, **kw)

    method.value_and_grad_fn = spy
    trainer = Trainer(cfg, method, 2, functional_forward(model), params)
    out = trainer.fit()
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert trainer.losses.shape == (6,) and np.isfinite(trainer.losses).all()
    assert seen == [(32, 8)] * 6 and len(trainer.gather_seconds) == 2


def test_streamed_chunks_of_two_train_as_one_chunk_of_six(tmp_path):
    """Each chunk's batches gathered and uploaded at its start: chunks of 2
    and one chunk of 6 train alike, the same losses bit for bit."""
    losses, gathered = [], []
    for chunk in (2, 6):
        cfg = _stream_cfg(str(tmp_path / "store"), [f"train.steps_per_chunk={chunk}"])
        inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
        method = ConsistencyBased(inst, cfg, 1, "cpu")
        real = method.gather_stream_chunk
        method.gather_stream_chunk = lambda *a, **kw: gathered.append(real(*a, **kw)) or gathered[-1]
        model, params = method.create_model_fn()
        trainer = Trainer(cfg, method, 2, functional_forward(model), params)
        trainer.fit()
        losses.append(trainer.losses)
    np.testing.assert_array_equal(*losses)
    assert [g["0T"].shape for g in gathered] == [(2, 32, 8)] * 3 + [(6, 32, 8)]
    assert trainer.gather_bytes == [gathered[-1]["0T"].nbytes + gathered[-1]["tau_0T_per_traj"].nbytes]

def test_sharded_store_has_the_shapes_of_in_memory_generation(tmp_path):
    cfg = config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={tmp_path / 's'}",
                                                     "pde_instance.integrator=baoab",
                                                     "pde_instance.langevin_pack=2"])
    inst = KineticFokkerPlanckGMM.__new__(KineticFokkerPlanckGMM)
    inst._STORE_SHARD_ELEMENTS = 1000  # several shards of every array
    KineticFokkerPlanckGMM.__init__(inst, cfg, 5, "cpu")
    timing = inst.data_timing
    assert set(timing) == {"generate_s", "to_host_s", "write_s", "bytes"}
    store = torch_data.load_array_store(str(tmp_path / "s"))
    memory = inst.generate_ground_truth_dataset(9)
    assert set(inst.data_timing) == {"initial_s", "terminal_s", "0T_s", "bytes"}
    assert {k: v.shape for k, v in store.items()} == {k: tuple(v.shape) for k, v in memory.items()}
    assert timing["bytes"] == torch_data.store_bytes(str(tmp_path / "s")) == \
        sum(v.numel() * 4 for v in memory.values())
    assert all(np.isfinite(np.asarray(v)).all() for v in store.values())
    dt = cfg.pde_instance.total_evolving_time / cfg.pde_instance.n_steps_0T
    np.testing.assert_allclose(np.diff(store["tau_0T"], axis=1), dt, rtol=1e-5)
    assert len(np.unique(store["tau_0T"][:, 0])) > 20  # a phase per trajectory, across shards
    # the dataset the instance trains on is the store's
    assert torch.equal(inst.dataset["0T"], torch.from_numpy(np.array(store["0T"])))


def test_store_of_another_ground_truth_is_refused(tmp_path):
    path = str(tmp_path / "s")
    cfg = config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={path}"])
    KineticFokkerPlanckGMM(cfg, 0, "cpu")
    KineticFokkerPlanckGMM(cfg, 0, "cpu")  # the same ground truth reloads
    with pytest.raises(ValueError, match="other GMM means"):
        KineticFokkerPlanckGMM(cfg, 1, "cpu")
    (tmp_path / "s" / GROUND_TRUTH_FILE).unlink()  # as a store of the JAX package
    with pytest.raises(ValueError, match="no record"):
        KineticFokkerPlanckGMM(cfg, 0, "cpu")
    jpath = str(tmp_path / "j")
    jax_data.save_array_store(jpath, {k: v.numpy() for k, v in KineticFokkerPlanckGMM(
        config_lib.preset("KGMM-offline", SMALL), 0, "cpu").dataset.items()})
    with pytest.raises(ValueError, match="no record"):
        KineticFokkerPlanckGMM(config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={jpath}"]),
                               0, "cpu")
    npz = str(tmp_path / "d.npz")
    cfg_npz = config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={npz}"])
    first = KineticFokkerPlanckGMM(cfg_npz, 0, "cpu").dataset
    again = KineticFokkerPlanckGMM(cfg_npz, 0, "cpu").dataset
    assert all(torch.equal(first[k], again[k]) for k in first)
    with pytest.raises(ValueError, match="other GMM means"):
        KineticFokkerPlanckGMM(cfg_npz, 2, "cpu")


@pytest.mark.parametrize("kind", ["store", "npz"])
@pytest.mark.parametrize("override", ["pde_instance.integrator=baoab", "pde_instance.total_evolving_time=5.0",
                                      "pde_instance.n_steps_terminal=30", "pde_instance.n_steps_0T=30",
                                      "pde_instance.sample_initial_size=200",
                                      "pde_instance.sample_terminal_size=100",
                                      "pde_instance.sample_0T_size=20"])
def test_dataset_made_with_other_settings_is_refused(tmp_path, kind, override):
    """A persisted dataset records every setting it was generated with
    beside the means; loading it under another one raises, naming it."""
    path = str(tmp_path / ("d.npz" if kind == "npz" else "s"))
    cfg = config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={path}"])
    first = KineticFokkerPlanckGMM(cfg, 0, "cpu").dataset
    again = KineticFokkerPlanckGMM(cfg, 0, "cpu").dataset  # the same settings reload
    assert all(torch.equal(first[k], again[k]) for k in first)
    field = override.split("=")[0].split(".")[1]
    with pytest.raises(ValueError, match=f"other settings: {field}="):
        KineticFokkerPlanckGMM(config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={path}",
                                                                          override]), 0, "cpu")


def test_dataset_without_the_settings_record_is_refused(tmp_path):
    """A store that records its means alone (as older versions of the port
    wrote them) or an .npz without ``generated_with`` may hold another
    simulation: refused."""
    path = str(tmp_path / "s")
    cfg = config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={path}"])
    KineticFokkerPlanckGMM(cfg, 0, "cpu")
    record = tmp_path / "s" / GROUND_TRUTH_FILE
    full = json.loads(record.read_text())
    assert set(full) == {"mus", "key", *kfp_gmm.RECORD_FIELDS}
    record.write_text(json.dumps({"mus": full["mus"]}))
    with pytest.raises(ValueError, match="does not record"):
        KineticFokkerPlanckGMM(cfg, 0, "cpu")
    record.write_text(json.dumps({**full, "key": full["key"] + 1}))
    with pytest.raises(ValueError, match="other settings: key="):
        KineticFokkerPlanckGMM(cfg, 0, "cpu")
    npz = str(tmp_path / "d.npz")
    cfg_npz = config_lib.preset("KGMM-offline", SMALL + [f"pde_instance.dataset_path={npz}"])
    KineticFokkerPlanckGMM(cfg_npz, 0, "cpu")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files if k != "generated_with"}
    np.savez(npz, **arrays)
    with pytest.raises(ValueError, match="does not record"):
        KineticFokkerPlanckGMM(cfg_npz, 0, "cpu")


def test_offline_refusals():
    # streaming gathers from a raw array store: an .npz dataset is refused
    # (with no dataset_path the run streams from a store of its own,
    # tests/test_torch_private_store.py)
    with pytest.raises(ValueError, match="array-store"):
        KineticFokkerPlanckGMM(config_lib.preset("KGMM-offline", SMALL + ["pde_instance.offline_streaming=True",
                                                                          "pde_instance.dataset_path=d.npz"]),
                               0, "cpu")
    with pytest.raises(ValueError, match="ONLINE"):
        KineticFokkerPlanckGMM(config_lib.preset("KGMM-offline", SMALL + ["pde_instance.init_broaden=1.3"]),
                               0, "cpu")
    with pytest.raises(ValueError, match="means it was generated with"):
        KineticFokkerPlanckGMM(config_lib.preset("KGMM-offline", SMALL), 0, "cpu",
                               configuration={"dataset": {}})
    cfg = config_lib.preset("KGMM-offline", SMALL)
    inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
    inst.dataset["tau_groups"] = torch.zeros((2, 20))
    with pytest.raises(NotImplementedError, match="item 17"):
        ConsistencyBased(inst, cfg, 1, "cpu").sample_data(3)
