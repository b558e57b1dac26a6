"""The port's kinetic Fokker-Planck weak-form loss, its parametric models
and the parameter converter against the JAX package's, on the CPU.

Both packages get the same ground truth (the JAX instance's GMM means), the
same batch (made with numpy from a seed) and the same model parameters
(flax parameters converted with ``convert.from_flax_params``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.losses import kinetic_fokker_planck as jkfp
from pde_inverse_tpu.models import parametric as jmodels
from pde_inverse_tpu.problems.kfp_gmm import KineticFokkerPlanckGMM as JaxKGMM
from pde_inverse_torch.convert import from_flax_params, to_numpy, to_torch
from pde_inverse_torch.losses import kinetic_fokker_planck as tkfp
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.models import parametric as tmodels
from pde_inverse_torch.problems.kfp_gmm import KineticFokkerPlanckGMM as TorchKGMM

torch.set_num_threads(1)

# Loss, gap and parameter gradient: f32 means over a few hundred points in
# another summation order.
RTOL = 1e-5

D = 4


@pytest.fixture(scope="module")
def instances():
    cfg = config_lib.preset("KGMM", ["pde_instance.n_steps=10", "solver.train.batch_size_0T=8"])
    j = JaxKGMM(cfg, jax.random.PRNGKey(0))
    t = TorchKGMM(cfg, 0, "cpu", configuration={"mus": np.asarray(j.configuration["mus"])})
    return j, t


def _batch(seed: int, n_init=240, n_term=240, n_path=160):
    rs = np.random.default_rng(seed)
    sd = np.array([2.0] * D + [np.sqrt(0.1)] * D, np.float32)
    make = lambda n: (rs.normal(size=(n, 2 * D)) * sd).astype(np.float32)
    return {"initial": make(n_init), "terminal": make(n_term) * 1.2, "0T": make(n_path)}


def _model_pair(kind: str, seed: int):
    rs = np.random.default_rng(seed)
    if kind == "gmm_means":
        params = {"params": {"mus": rs.normal(size=(3, D)).astype(np.float32) * 2.0}}
        return jmodels.GMMMeansModel(dim=D, n_components=3), tmodels.GMMMeansModel(D, 3), params
    params = {"params": {"F": {"kernel": rs.normal(size=(D, D)).astype(np.float32) * 0.3,
                               "bias": rs.normal(size=D).astype(np.float32) * 0.1}}}
    return jmodels.QuadraticFormModel(dim=D), tmodels.QuadraticFormModel(D), params


@pytest.mark.parametrize("kind", ["gmm_means", "quadratic_form"])
@pytest.mark.parametrize("batch_kind", ["full", "empty_initial"])
def test_loss_gap_and_grad_match_jax(instances, kind, batch_kind):
    jinst, tinst = instances
    net, model, params_np = _model_pair(kind, 1)
    batch = _batch(2, n_init=0 if batch_kind == "empty_initial" else 240)
    j = jkfp.value_and_grad_fn(
        net.apply, jax.tree_util.tree_map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch.items()}, None, jinst,
    )
    t = tkfp.value_and_grad_fn(
        functional_forward(model), from_flax_params(params_np),
        {k: torch.from_numpy(v) for k, v in batch.items()}, tinst,
    )
    for name in ("loss", "loss ground truth", "grad_norm"):
        np.testing.assert_allclose(float(t[name]), float(j[name]), rtol=RTOL)
    j_grad = from_flax_params(jax.tree_util.tree_map(np.asarray, j["grad"]))
    assert set(t["grad"]) == set(j_grad)
    for name, g in t["grad"].items():
        scale = float(j_grad[name].abs().max())
        np.testing.assert_allclose(g.numpy(), j_grad[name].numpy(), rtol=RTOL, atol=RTOL * scale)


def test_loss_at_truth_is_the_gap_floor(instances):
    """At the true means the model's gradient is the true one, so the gap
    is zero."""
    _, tinst = instances
    model = tmodels.GMMMeansModel(D, 3)
    params = {"mus": tinst.configuration["mus"].clone()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    out = tkfp.value_and_grad_fn(functional_forward(model), params, batch, tinst)
    assert float(out["loss ground truth"]) == pytest.approx(0.0, abs=1e-10)


def test_fused_provider_is_refused(instances):
    """The fused provider serves PotentialMLP hypotheses only: for the
    parametric means the loss stays on the autodiff path, bit for bit, in
    every mode; an unknown mode raises."""
    _, tinst = instances
    model = tmodels.GMMMeansModel(D, 3)
    params = {"mus": torch.zeros((3, D))}
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    fwd = functional_forward(model)
    ref = tkfp.value_and_grad_fn(fwd, params, batch, tinst)
    for mode in ("auto", "on", "fwd", "xla", "off"):
        out = tkfp.value_and_grad_fn(fwd, params, batch, tinst, fused_module=model, fused_mode=mode)
        assert float(out["loss"]) == float(ref["loss"])
        assert torch.equal(out["grad"]["mus"], ref["grad"]["mus"])
    with pytest.raises(ValueError, match="kfp_fused"):
        tkfp.value_and_grad_fn(fwd, params, batch, tinst, fused_module=model, fused_mode="pallas")


class _FixedPoints:
    """A stand-in problem whose samplers return fixed points, so that both
    packages' test_fn evaluate on the same inputs."""

    sample_scheme = "SDE"
    distribution_terminal = None

    def __init__(self, V_true_fn, init, term, path, to, device=None):
        self.V_true_fn = V_true_fn
        self.device = device
        self._init, self._term, self._path = (to(x) for x in (init, term, path))
        points = self._init
        self.distribution_initial = type("Fixed", (), {"sample": lambda self_, n, key: points})()

    def sample_ground_truth(self, key, batch_size):
        return self._init, self._term, self._path


def test_test_fn_matches_jax_on_shared_points(instances):
    jinst, tinst = instances
    net, model, params_np = _model_pair("gmm_means", 5)
    b = _batch(6)
    jfix = _FixedPoints(jinst.V_true_fn, b["initial"], b["terminal"], b["0T"], jnp.asarray)
    tfix = _FixedPoints(tinst.V_true_fn, b["initial"], b["terminal"], b["0T"], torch.from_numpy, "cpu")
    j = jkfp.test_fn(partial(net.apply, jax.tree_util.tree_map(jnp.asarray, params_np)), jfix,
                     jax.random.PRNGKey(0), batch_size=240, sde_probe_trajectories=16)
    t = tkfp.test_fn(partial(functional_forward(model), from_flax_params(params_np)), tfix,
                     7, batch_size=240, sde_probe_trajectories=16)
    assert set(t) == set(j) and len(t) == 3
    for name in t:
        np.testing.assert_allclose(float(t[name]), float(j[name]), rtol=RTOL)


def test_test_fn_on_the_problem_runs_the_path_probe(instances):
    _, tinst = instances
    model = tmodels.GMMMeansModel(D, 3)
    out = tkfp.test_fn(partial(functional_forward(model), {"mus": tinst.configuration["mus"]}),
                       tinst, 3, batch_size=200, sde_probe_trajectories=8)
    assert set(out) == {f"relative error of gradient estimation {w}"
                        for w in ("initial", "path", "terminal")}
    # the true means recover the true gradient everywhere
    assert all(float(v) < 1e-5 for v in out.values())


@pytest.mark.parametrize("kind", ["gmm_means", "quadratic_form"])
def test_models_match_flax(kind):
    net, model, params_np = _model_pair(kind, 8)
    params = from_flax_params(params_np)
    fwd = functional_forward(model)
    x = np.random.default_rng(9).normal(size=(32, D)).astype(np.float32) * 2.0
    j_batch = np.asarray(net.apply(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(x)))
    t_batch = fwd(params, torch.from_numpy(x))
    assert t_batch.shape == (32,)
    np.testing.assert_allclose(t_batch.detach().numpy(), j_batch, rtol=RTOL, atol=RTOL)
    t_point = fwd(params, torch.from_numpy(x[0]))
    assert t_point.shape == (1,)
    np.testing.assert_allclose(t_point.detach().numpy(), j_batch[:1], rtol=RTOL, atol=RTOL)


def test_converter_layout():
    _, model, params_np = _model_pair("quadratic_form", 10)
    state = from_flax_params(params_np)
    assert set(state) == {"F.weight", "F.bias"}
    np.testing.assert_array_equal(to_numpy(state["F.weight"]), params_np["params"]["F"]["kernel"].T)
    np.testing.assert_array_equal(to_numpy(state["F.bias"]), params_np["params"]["F"]["bias"])
    model.load_state_dict(state)  # nn.Linear layout
    assert set(from_flax_params({"params": {"mus": np.zeros((3, D))}})) == {"mus"}
    x = to_torch(np.arange(6, dtype=np.float64).reshape(2, 3))
    assert x.dtype == torch.float32 and to_numpy(x).tolist() == [[0, 1, 2], [3, 4, 5]]


def test_recovered_rel_l2_is_permutation_matched(instances):
    jinst, tinst = instances
    true = np.asarray(jinst.configuration["mus"])
    est = true[[2, 0, 1]] + np.random.default_rng(11).normal(size=true.shape).astype(np.float32) * 0.1
    j = float(jinst.recovered_parameter_rel_l2({"params": {"mus": jnp.asarray(est)}}))
    t = tinst.recovered_parameter_rel_l2({"mus": torch.from_numpy(est)})
    assert t == pytest.approx(j, rel=1e-5)
    assert t < 0.1  # the permutation is undone
    assert tinst.recovered_parameter_rel_l2({"F.weight": torch.zeros((D, D))}) is None
