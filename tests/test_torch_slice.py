"""The port's slices (online KGMM, online non-parametric KGMM, online KMV)
as a whole, on the CPU.

* training steps of the port against those of the JAX package on the
  same injected batches and the same starting parameters;
* the CLI, ``run`` and ``entry`` end to end at a small size;
* the trainer's chunking, NaN guard and writers;
* every configuration outside the slice raising NotImplementedError.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.methods import ConsistencyBased as JaxMethod
from pde_inverse_tpu.problems.kfp_gmm import KineticFokkerPlanckGMM as JaxKGMM
from pde_inverse_tpu.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic as JaxKMV
from pde_inverse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from pde_inverse_tpu.training.trainer import cadence_fires as jax_cadence_fires
from pde_inverse_torch import main as tmain
from pde_inverse_torch import rng
from pde_inverse_torch.convert import from_flax_params
from pde_inverse_torch.device import resolve_device
from pde_inverse_torch.entry import entry
from pde_inverse_torch.methods import ConsistencyBased, functional_forward
from pde_inverse_torch.problems.kfp_gmm import KineticFokkerPlanckGMM
from pde_inverse_torch.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic
from pde_inverse_torch.training import metrics, trainer

torch.set_num_threads(1)

SMALL = ["solver.train.batch_size_0T=16", "pde_instance.n_steps=10", "logging.writer=none"]
# Parameters after 5 steps of loss/gradient + Adam at lr 1e-2: f32 op-order
# differences of ~1e-7 per step, amplified by Adam's normalisation.
PARAM_ATOL = 1e-5


def _batch(rs, n_init=120, n_term=120, n_path=160, d=4):
    sd = np.array([2.0] * d + [np.sqrt(0.1)] * d, np.float32)
    make = lambda n: (rs.normal(size=(n, 2 * d)) * sd).astype(np.float32)
    return {"initial": make(n_init), "terminal": make(n_term) * 1.3, "0T": make(n_path)}


def test_five_steps_match_jax_on_injected_batches():
    cfg = config_lib.preset("KGMM", SMALL + ["train.optimizer.grad_clip_norm=5.0"])
    jinst = JaxKGMM(cfg, jax.random.PRNGKey(0))
    jmethod = JaxMethod(pde_instance=jinst, cfg=cfg, rng=jax.random.PRNGKey(1))
    jnet, jparams = jmethod.create_model_fn()
    tinst = KineticFokkerPlanckGMM(cfg, 0, "cpu",
                                   configuration={"mus": np.asarray(jinst.configuration["mus"])})
    tmethod = ConsistencyBased(tinst, cfg, 1, "cpu")
    model, _ = tmethod.create_model_fn()
    tparams = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
    jopt, topt = jax_get_optimizer(cfg.train.optimizer), tmain.get_optimizer(cfg.train.optimizer)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)

    # the JAX step through its method, compiled once; the batch is injected
    # in place of the method's sampler on both sides
    def jax_step(params, batch, key):
        jmethod.sample_data = lambda *a, **k: batch
        return jmethod.value_and_grad_fn(jnet.apply, params, key)

    jax_step = jax.jit(jax_step)
    rs = np.random.default_rng(0)
    fwd = functional_forward(model)
    for step in range(5):
        batch = _batch(rs)
        tmethod.sample_data = lambda key: {n: torch.from_numpy(v) for n, v in batch.items()}
        jout = jax_step(jparams, {n: jnp.asarray(v) for n, v in batch.items()},
                        jax.random.PRNGKey(step))
        tout = tmethod.value_and_grad_fn(fwd, tparams, step, step=step)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=1e-5)
        updates, jstate = jopt.update(jout["grad"], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = topt.update(tout["grad"], tstate, tparams)
        tparams = {k: p + tupdates[k] for k, p in tparams.items()}
        np.testing.assert_allclose(tparams["mus"].numpy(), np.asarray(jparams["params"]["mus"]),
                                   rtol=0, atol=PARAM_ATOL)


NP_SMALL = ["solver.train.batch_size_0T=16", "pde_instance.n_steps=10", "logging.writer=none",
            "neural_network.hidden_dim=16", "neural_network.feature_dim=8",
            "neural_network.fourier_features=4"]


@pytest.mark.parametrize("mode", ["switch", "track"])
def test_np_steps_match_jax_on_injected_batches(mode):
    """Three full non-parametric training steps (loss -> gradient -> clip ->
    Adam -> EMA, switch at step 1) of the port, with the fused provider's
    plain versions (kfp_fused=on), against the JAX package's (autodiff on
    the CPU), on the same injected batches from the same flax weights."""
    cfg = config_lib.preset("KGMM-nonparametric-online", NP_SMALL + [
        "train.optimizer.ema_switch_step=1", "train.optimizer.ema_decay=0.5",
        f"train.optimizer.ema_mode={mode}", "solver.train.kfp_fused=on",
    ])
    jcfg = config_lib.preset("KGMM-nonparametric-online", NP_SMALL)  # JAX: auto = autodiff here
    jinst = JaxKGMM(jcfg, jax.random.PRNGKey(0))
    jmethod = JaxMethod(pde_instance=jinst, cfg=jcfg, rng=jax.random.PRNGKey(1))
    jnet, jparams = jmethod.create_model_fn()
    tinst = KineticFokkerPlanckGMM(cfg, 0, "cpu",
                                   configuration={"mus": np.asarray(jinst.configuration["mus"])})
    tmethod = ConsistencyBased(tinst, cfg, 1, "cpu")
    model, _ = tmethod.create_model_fn()
    tparams = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(tparams) == set(dict(model.named_parameters()))
    ocfg = cfg.train.optimizer
    jopt, topt = jax_get_optimizer(ocfg), tmain.get_optimizer(ocfg)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jema = optax.ema(ocfg.ema_decay)
    jes = jema.init(jparams)
    tema = {k: torch.zeros_like(v) for k, v in tparams.items()}

    def jax_step(params, batch, key):
        jmethod.sample_data = lambda *a, **k: batch
        return jmethod.value_and_grad_fn(jnet.apply, params, key)

    jax_step = jax.jit(jax_step)
    rs = np.random.default_rng(3)
    fwd = functional_forward(model)
    for step in range(3):
        batch = _batch(rs, n_init=48, n_term=48, n_path=64)
        tmethod.sample_data = lambda key: {n: torch.from_numpy(v) for n, v in batch.items()}
        jout = jax_step(jparams, {n: jnp.asarray(v) for n, v in batch.items()}, jax.random.PRNGKey(step))
        tout = tmethod.value_and_grad_fn(fwd, tparams, step, step=step)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=1e-5)
        updates, jstate = jopt.update(jout["grad"], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if step >= ocfg.ema_switch_step:  # pde_inverse_tpu/training/trainer.py:114-140
            if step == ocfg.ema_switch_step:
                jes = optax.EmaState(count=jnp.zeros([], jnp.int32), ema=jparams)
            _, jes = jema.update(jparams, jes)
            jparams = jparams if mode == "track" else jes.ema
        tupdates, tstate = topt.update(tout["grad"], tstate, tparams)
        tparams, tema = trainer.ema_step(ocfg, {k: p + tupdates[k] for k, p in tparams.items()},
                                         tema, step)
        want = from_flax_params(jax.tree_util.tree_map(
            np.asarray, trainer.eval_params(ocfg, jparams, jes.ema, step + 1)))
        got = trainer.eval_params(ocfg, tparams, tema, step + 1)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL)


def test_np_cli_runs_on_cpu_and_reports_test_metrics(monkeypatch, capsys):
    argv = ["preset=KGMM-nonparametric-online", "device=cpu", "train.number_of_iterations=4",
            "train.steps_per_chunk=2", "test.frequency=2", "test.verbose=True",
            "train.optimizer.ema_switch_step=2", *NP_SMALL]
    monkeypatch.setattr("sys.argv", ["pde_inverse_torch.main", *argv])
    tmain.main()
    out = capsys.readouterr().out
    assert out.count("steps/s]") == 2
    (line,) = [ln for ln in out.splitlines() if ln.startswith("[result] ")]
    for where in ("initial", "path", "terminal"):
        assert f"relative error of gradient estimation {where}=" in line
    values = [float(v) for v in re.findall(r"=(\S+)", line)]
    assert len(values) == 3 and np.isfinite(values).all()


def test_np_entry_one_step_is_finite():
    out = entry(NP_SMALL, device="cpu", preset="KGMM-nonparametric-online")
    assert np.isfinite(float(out["loss"])) and out["grad"]["Dense_0.weight"].shape == (16, 12)


def test_cli_runs_on_cpu_and_reports_rel_l2(monkeypatch, capsys):
    argv = ["preset=KGMM", "device=cpu", "train.number_of_iterations=10",
            "train.steps_per_chunk=5", "test.frequency=5", "test.verbose=True", *SMALL]
    monkeypatch.setattr("sys.argv", ["pde_inverse_torch.main", *argv])
    tmain.main()
    out = capsys.readouterr().out
    assert "[result] recovered-parameter rel-L2: " in out
    rel = float(out.split("recovered-parameter rel-L2: ")[1].split()[0])
    assert np.isfinite(rel)
    assert out.count("steps/s]") == 2  # test cadence at steps 5 and 10


def test_run_writes_metrics_and_finishes_finite(tmp_path):
    cfg, device = tmain.parse_args(
        ["preset=KGMM", "device=cpu", "train.number_of_iterations=6", "train.steps_per_chunk=4",
         "test.frequency=100", *SMALL, "logging.writer=jsonl", f"logging.run_dir={tmp_path}"]
    )
    assert device == "cpu"
    result = tmain.run(cfg, device)
    assert result.losses.shape == (6,) and np.isfinite(result.losses).all()
    assert np.isfinite(result.rel_l2)
    assert result.test_metrics["steps_per_sec"] > 0  # the final chunk always tests
    (run_dir,) = tmp_path.iterdir()
    lines = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines[:6]] == list(range(6))
    assert {"loss", "grad_norm", "loss ground truth", "params_norm"} <= set(lines[0])
    assert lines[-1]["step"] == 6 and "relative error of gradient estimation path" in lines[-1]
    assert json.loads((run_dir / "config.json").read_text())["seed"] == cfg.seed


def test_data_seed_rekeys_only_the_data():
    base = ["train.number_of_iterations=2", "train.steps_per_chunk=2", *SMALL]
    a = tmain.run(config_lib.preset("KGMM", base), "cpu")
    b = tmain.run(config_lib.preset("KGMM", base + ["train.data_seed=5"]), "cpu")
    c = tmain.run(config_lib.preset("KGMM", base), "cpu")
    np.testing.assert_array_equal(a.losses, c.losses)  # (seed, step) fixes every stream
    assert not np.array_equal(a.losses, b.losses)


def test_entry_one_step_is_finite():
    out = entry(SMALL, device="cpu")
    assert np.isfinite(float(out["loss"])) and out["grad"]["mus"].shape == (3, 4)


@pytest.mark.parametrize("antithetic", [False, True])
def test_online_batch_shapes(antithetic):
    cfg = config_lib.preset("KGMM", SMALL + [f"pde_instance.antithetic={antithetic}",
                                             "solver.train.path_stride=2"])
    inst = KineticFokkerPlanckGMM(cfg, 3, "cpu")
    method = ConsistencyBased(inst, cfg, 4, "cpu")
    data = method.sample_data(9)
    assert data["initial"].shape == (16 * 30, 8) and data["terminal"].shape == (16 * 30, 8)
    assert data["0T"].shape == (16 * 5, 8)  # 16 trajectories, 10 states, stride 2
    if antithetic:  # the exact-Gaussian mirror 2 m0 - z, m0 = 0
        torch.testing.assert_close(data["initial"][240:], -data["initial"][:240])
    again = method.sample_data(9)
    assert all(torch.equal(again[k], v) for k, v in data.items())


def test_own_ground_truth_is_drawn_from_the_seed():
    cfg = config_lib.preset("KGMM", SMALL)
    a = KineticFokkerPlanckGMM(cfg, 1, "cpu").configuration["mus"]
    b = KineticFokkerPlanckGMM(cfg, 1, "cpu").configuration["mus"]
    assert torch.equal(a, b) and a.shape == (3, 4)
    assert float(a.min()) >= -4.0 and float(a.max()) <= 4.0


def test_nan_guard_reports_the_failing_step():
    cfg = config_lib.preset("KGMM", SMALL + ["train.number_of_iterations=8", "train.steps_per_chunk=4"])
    inst = KineticFokkerPlanckGMM(cfg, 0, "cpu")
    method = ConsistencyBased(inst, cfg, 1, "cpu")
    model, params = method.create_model_fn()
    real = method.value_and_grad_fn

    def poisoned(forward_fn, params, key, step=None):
        out = real(forward_fn, params, key, step=step)
        if step == 6:
            out["loss"] = out["loss"] * float("nan")
        return out

    method.value_and_grad_fn = poisoned
    t = trainer.Trainer(cfg, method, 2, functional_forward(model), params)
    with pytest.raises(FloatingPointError, match="step 6"):
        t.fit()
    assert t.losses.shape == (8,) and np.isfinite(t.losses[:6]).all() and np.isnan(t.losses[6])


def test_cadence_fires_matches_jax():
    for prev in range(0, 30, 3):
        for k in (1, 3, 7):
            for freq in (0, 1, 4, 5, 10):
                assert trainer.cadence_fires(prev, prev + k, freq) == jax_cadence_fires(prev, prev + k, freq)


@pytest.mark.parametrize("kind", ["jsonl", "csv"])
def test_writers_log_chunks(kind, tmp_path):
    w = metrics.make_writer(kind, str(tmp_path))
    w.log_chunk({"loss": np.array([1.0, 2.0]), "grad_norm": np.array([3.0, 4.0])}, first_step=10)
    w.close()
    text = (tmp_path / f"metrics.{kind}").read_text()
    assert "12" not in text and text.count("\n") == (2 if kind == "jsonl" else 3)
    assert isinstance(metrics.make_writer("none", str(tmp_path)), metrics.NullWriter)
    with pytest.raises(ValueError):
        metrics.make_writer("tensorboard", str(tmp_path))


def test_rng_is_derivable():
    assert rng.split(7, 3) == rng.split(7, 3)
    assert len(set(rng.split(7, 3) + [rng.fold_in(7, 100)])) == 4
    assert rng.fold_in(7, 1) != rng.fold_in(8, 1)
    a = torch.rand(3, generator=rng.generator(rng.fold_in(7, 2)))
    assert torch.equal(a, torch.rand(3, generator=rng.generator(rng.fold_in(7, 2))))


def test_cuda_requested_but_absent_raises(monkeypatch):
    """No device means CUDA: without it the port raises instead of running on
    the CPU; only an explicit device=cpu does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    for implied in (None, ""):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(implied)
    assert resolve_device("cpu") == torch.device("cpu")


UNSUPPORTED = {
    "kou": ("KOU", []),
    "ou": ("OU", []),
    # KMV itself runs (online, exact law); its offline dataset does not
    "kmv": ("KMV-offline", []),
    "kmv_field_reg": ("KMV", ["solver.train.kmv_field_reg=1e-2"]),
    "kmv_init_broaden": ("KMV", ["pde_instance.init_broaden=1.3"]),
    "kmv_fourier_kernel": ("KMV-nonparametric-fourier", []),
    "kmv_ref_axis": ("KMV", ["backend.ref_axis_size=2"]),
    "kmv_pallas_blocks": ("KMV", ["solver.train.kmv_pallas_block_i=256"]),
    "offline": ("KGMM-offline", []),
    "non_parametric": ("KGMM", ["estimation_mode=non-parametric", "neural_network.model=fourier-kernel"]),
    "np_offline": ("KGMM-nonparametric", []),
    "bf16": ("KGMM-nonparametric-online", ["neural_network.dtype=bfloat16"]),
    "init_broaden": ("KGMM", ["pde_instance.init_broaden=1.5"]),
    "boundary_reservoir": ("KGMM", ["solver.train.boundary_reservoir=1000"]),
    "boundary_per_chunk": ("KGMM", ["solver.train.boundary_per_chunk=True"]),
    "boundary_rotate": ("KGMM", ["solver.train.boundary_rotate=True"]),
    "use_ema": ("KGMM", ["train.optimizer.use_ema=True", "save_and_load.save_model=True"]),
    "save_model": ("KGMM", ["save_and_load.save_model=True"]),
    "load_model": ("KGMM", ["save_and_load.load_model=True"]),
    "pinn": ("KGMM", ["solver.name=PINN"]),
    "data_axis": ("KGMM", ["backend.data_axis_size=2"]),
    "ref_axis": ("KGMM", ["backend.ref_axis_size=2"]),
    "langevin_pack": ("KGMM", ["pde_instance.langevin_pack=2"]),
    "wandb": ("KGMM", ["logging.writer=wandb"]),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_config_raises(case):
    name, overrides = UNSUPPORTED[case]
    overrides = ["train.number_of_iterations=1", *SMALL, *overrides]
    if case == "wandb":
        overrides.remove("logging.writer=none")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmain.run(config_lib.preset(name, overrides), "cpu")


# -- slice 3: online KMV -----------------------------------------------------------

KMV_MLP = ["neural_network.model=mlp", "neural_network.fourier_features=0",
           "neural_network.fourier_trainable=False", "solver.train.kmv_field_reg=0.0",
           "train.optimizer.weight_decay=1e-1"]
KMV_SMALL = ["solver.train.n_time_stamps=3", "solver.train.sample_per_time=13",
             "neural_network.hidden_dim=16", "neural_network.layers=2", "neural_network.feature_dim=8",
             "logging.writer=none"]


def _kmv_batch(rs, n=13, nt=3):
    z = (rs.normal(size=(n * nt, 4)) * 0.8).astype(np.float32)
    taus = np.sort(rs.uniform(0.05, 1.0, size=nt)).astype(np.float32)
    return {"0T": z, "tau_0T": taus, "initial": np.zeros((0, 4), np.float32),
            "terminal": np.zeros((0, 4), np.float32)}


@pytest.mark.parametrize("preset,overrides,kmv_pallas", [
    ("KMV", ["solver.train.sample_per_time=13", "solver.train.n_time_stamps=3"], "auto"),
    ("KMV-nonparametric-fourier", KMV_MLP + KMV_SMALL, "auto"),
    ("KMV-nonparametric-fourier", KMV_MLP + KMV_SMALL, "packed"),
])
def test_kmv_steps_match_jax_on_injected_batches(preset, overrides, kmv_pallas):
    """Two KMV training steps (loss -> gradient -> clip -> Adam) of the port
    (the parametric closed form; the non-parametric blockwise path, plain on
    the CPU or K7/K8's plain versions behind their Function) against the
    JAX package's, on the same injected batches from the same flax weights."""
    cfg = config_lib.preset(preset, overrides + [f"solver.train.kmv_pallas={kmv_pallas}"])
    jcfg = config_lib.preset(preset, overrides)  # JAX on the CPU: the jnp blockwise path
    jinst = JaxKMV(jcfg, jax.random.PRNGKey(0))
    jmethod = JaxMethod(pde_instance=jinst, cfg=jcfg, rng=jax.random.PRNGKey(1))
    jnet, jparams = jmethod.create_model_fn()
    tinst = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu", configuration={"tilde_F": np.asarray(jinst.tilde_F)})
    tmethod = ConsistencyBased(tinst, cfg, 1, "cpu")
    model, _ = tmethod.create_model_fn()
    tparams = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(tparams) == set(dict(model.named_parameters()))
    jopt, topt = jax_get_optimizer(cfg.train.optimizer), tmain.get_optimizer(cfg.train.optimizer)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)

    def jax_step(params, batch, key):
        jmethod.sample_data = lambda *a, **k: batch
        return jmethod.value_and_grad_fn(jnet.apply, params, key)

    rs = np.random.default_rng(5)
    fwd = functional_forward(model)
    for step in range(2):
        batch = _kmv_batch(rs)
        tmethod.sample_data = lambda key: {n: torch.from_numpy(v) for n, v in batch.items()}
        jout = jax_step(jparams, {n: jnp.asarray(v) for n, v in batch.items()}, jax.random.PRNGKey(step))
        tout = tmethod.value_and_grad_fn(fwd, tparams, step, step=step)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=1e-5)
        updates, jstate = jopt.update(jout["grad"], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = topt.update(tout["grad"], tstate, tparams)
        tparams = {k: p + tupdates[k] for k, p in tparams.items()}
        want = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
        for k, v in want.items():
            np.testing.assert_allclose(tparams[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("case", ["parametric", "mlp"])
def test_kmv_cli_runs_on_cpu_and_reports_its_result(case, monkeypatch, capsys):
    if case == "parametric":
        argv = ["preset=KMV", "solver.train.sample_per_time=200"]
        line_start = "[result] recovered-parameter rel-L2: "
    else:
        argv = ["preset=KMV-nonparametric-fourier", *KMV_MLP, *KMV_SMALL]
        line_start = "[result] relative error of interaction gradient="
    argv += ["device=cpu", "train.number_of_iterations=4", "train.steps_per_chunk=2",
             "test.frequency=2", "test.verbose=True", "logging.writer=none"]
    monkeypatch.setattr("sys.argv", ["pde_inverse_torch.main", *argv])
    tmain.main()
    out = capsys.readouterr().out
    assert out.count("steps/s]") == 2
    (line,) = [ln for ln in out.splitlines() if ln.startswith(line_start)]
    assert np.isfinite(float(line[len(line_start):].split()[0]))
    assert ("[warn] non-parametric KMV" in out) is False  # weight decay 1e-1 is the stabiliser


def test_kmv_np_without_stabiliser_warns(capsys):
    cfg = config_lib.preset("KMV-nonparametric-fourier",
                            KMV_MLP + KMV_SMALL + ["train.optimizer.weight_decay=0.0"])
    inst = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu")
    ConsistencyBased(inst, cfg, 1, "cpu").create_model_fn()
    assert "[warn] non-parametric KMV without a stabilizer" in capsys.readouterr().out


def test_kmv_exact_law_batches_and_entry():
    cfg = config_lib.preset("KMV", ["solver.train.sample_per_time=11", "solver.train.n_time_stamps=4",
                                    "solver.train.batch_size_init=5", "solver.train.batch_size_terminal=6"])
    inst = KineticMcKeanVlasovQuadratic(cfg, 3, "cpu")
    method = ConsistencyBased(inst, cfg, 4, "cpu")
    method.create_model_fn()
    data = method.sample_data(9)
    assert data["0T"].shape == (44, 4) and data["tau_0T"].shape == (4,)
    assert data["initial"].shape == (5, 4) and data["terminal"].shape == (6, 4)
    assert all(torch.equal(method.sample_data(9)[k], v) for k, v in data.items())
    assert method._kmv_kwargs()["closed_form_quadratic"]
    out = entry(["solver.train.sample_per_time=50"], device="cpu", preset="KMV")
    assert np.isfinite(float(out["loss"])) and out["grad"]["F.weight"].shape == (2, 2)
