"""The port's KMV consistency loss (``pde_inverse_torch.losses.
kinetic_mckean_vlasov``) against the JAX package on the CPU, on shared
batches and converted parameters.

* the weights, the closed-form quadratic statistics and the generic
  chunked pairwise reduction;
* the full loss, gap and parameter gradient for the parametric closed form,
  the generic path and the non-parametric blockwise path (hidden (16, 16),
  feature 8, n = 13, nt = 3; with and without Fourier front end and
  quadratic head);
* exact-law samples against the oracle's moments, distributionally.

Tolerances: loss and gap rtol 1e-5 (the JAX blockwise gate against the
generic path is 2e-4; the two packages run the same f32 formulas), each
gradient leaf 3e-4 relative to its max-abs; the statistics rtol 2e-4 /
atol 1e-5 as in tests/test_kmv_blockwise.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.losses import kinetic_mckean_vlasov as jloss
from pde_inverse_tpu.models.mlp import PotentialMLP as JaxMLP
from pde_inverse_tpu.models.parametric import QuadraticFormModel as JaxQuad
from pde_inverse_tpu.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic as JaxKMV
from pde_inverse_torch.convert import from_flax_params
from pde_inverse_torch.losses import kinetic_mckean_vlasov as tloss
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.models.mlp import PotentialMLP
from pde_inverse_torch.models.parametric import QuadraticFormModel
from pde_inverse_torch.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL = 3e-4
N, NT = 13, 3
T = lambda a: torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def inst():
    cfg = config_lib.preset("KMV")
    j = JaxKMV(cfg, jax.random.PRNGKey(0))
    t = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu", configuration={"tilde_F": np.asarray(j.tilde_F)})
    return j, t


def _batch(seed=0):
    rs = np.random.default_rng(seed)
    z = (rs.normal(size=(N * NT, 4)) * 0.8).astype(np.float32)
    taus = np.array([0.15, 0.5, 0.85], np.float32)
    return ({"0T": jnp.asarray(z), "tau_0T": jnp.asarray(taus)}, {"0T": T(z), "tau_0T": T(taus)})


def _close_rel(got, want, rel=GRAD_REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (what, np.abs(got - want).max() / scale)


def _compare(jout, tout):
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tout["loss ground truth"]), float(jout["loss ground truth"]),
                               rtol=LOSS_RTOL)
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, jout["grad"]))
    assert set(want) == set(tout["grad"])
    for k, w in want.items():
        _close_rel(tout["grad"][k], w, what=k)


def test_weights_match_jax(inst):
    j, t = inst
    jd, td = _batch()
    x = jd["0T"][:, :2].reshape(-1, NT, 2)
    want = jloss.compute_weights(j, jd["tau_0T"], x)
    got = tloss.compute_weights(t, td["tau_0T"], td["0T"][:, :2].reshape(-1, NT, 2))
    _close_rel(got, want, rel=1e-5)


def test_quadratic_statistics_and_generic_reduction_match_jax(inst):
    j, t = inst
    jd, td = _batch(1)
    jx, jv = (a.reshape(-1, NT, 2) for a in jnp.split(jd["0T"], 2, axis=-1))
    tx, tv = (a.reshape(-1, NT, 2) for a in torch.chunk(td["0T"], 2, dim=-1))
    want = jloss._quadratic_meanfield_stats(j.Phi_true_fn, jx, jv)
    got = tloss._quadratic_meanfield_stats(t.Phi_true_fn, tx, tv)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-5, atol=1e-5, err_msg=k)
    jstats = lambda _p, dflat, vflat: {"nabla_true": jax.vmap(jax.grad(j.Phi_true_fn))(dflat)}
    from pde_inverse_torch.ops import autodiff as ad

    tstats = lambda _p, dflat, vflat: {"nabla_true": ad.batched_grad(t.Phi_true_fn, dflat)}
    for chunk in (4, 512):  # ragged chunks (13 refs) and a single chunk
        w = jloss._pairwise_stats(jstats, jx, jv, jx, chunk)
        g = tloss._pairwise_stats(tstats, tx, tv, tx, chunk)
        np.testing.assert_allclose(g["nabla_true"].numpy(), np.asarray(w["nabla_true"]), rtol=2e-4, atol=1e-5)
    # the closed form equals the pairwise reduction for a quadratic kernel
    np.testing.assert_allclose(got["nabla"].numpy(), g["nabla_true"].numpy(), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("closed_form", [True, False])
def test_parametric_loss_and_gradient_match_jax(inst, closed_form):
    j, t = inst
    jd, td = _batch(2)
    jnet = JaxQuad(dim=2)
    jparams = jnet.init(jax.random.PRNGKey(4), jnp.zeros(2))
    model = QuadraticFormModel(2)
    tparams = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
    jout = jloss.value_and_grad_fn(jnet.apply, jparams, jd, None, j, closed_form_quadratic=closed_form,
                                   element_budget=100)
    tout = tloss.value_and_grad_fn(functional_forward(model), tparams, td, t,
                                   closed_form_quadratic=closed_form, element_budget=100)
    _compare(jout, tout)


@pytest.mark.parametrize("fourier,quad", [(0, False), (0, True), (4, True)])
@pytest.mark.parametrize("path", ["blockwise", "generic"])
def test_nonparametric_loss_and_gradient_match_jax(inst, fourier, quad, path):
    j, t = inst
    jd, td = _batch(3)
    jnet = JaxMLP(hidden_dims=[16, 16], feature_dim=8, fourier_features=fourier, quadratic_head=quad)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros(2))
    model = PotentialMLP(2, [16, 16], 8, fourier_features=fourier, quadratic_head=quad)
    tparams = from_flax_params(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(tparams) == set(dict(model.named_parameters()))
    jkw = dict(blockwise_module=jnet, pallas_mode="off") if path == "blockwise" else {}
    tkw = dict(blockwise_module=model, pallas_mode="off") if path == "blockwise" else {}
    jout = jloss.value_and_grad_fn(jnet.apply, jparams, jd, None, j, **jkw)
    tout = tloss.value_and_grad_fn(functional_forward(model), tparams, td, t, **tkw)
    _compare(jout, tout)


def test_exact_law_samples_match_the_oracle(inst):
    """grid_time samples at each stamp have the oracle's mean and covariance
    (20,000 samples per stamp: Monte Carlo error ~ 0.007 x scale)."""
    _, t = inst
    n = 20_000
    z = t.sample_ground_truth(7, (5, n)).reshape(n, 5, 4)
    ts = t.get_time_sample_ground_truth(7, (5, n))
    means, covs = t.oracle.moments_grid(ts)
    for k in range(5):
        zk = z[:, k].double()
        scale = float(covs[k].diagonal().max()) ** 0.5
        assert float((zk.mean(0) - means[k]).abs().max()) < 0.04 * scale
        emp = torch.cov(zk.T)
        assert float((emp - covs[k]).abs().max()) < 0.05 * scale**2


def test_test_fn_is_zero_at_the_truth_and_finite_elsewhere(inst):
    _, t = inst
    out = tloss.test_fn(lambda y: t.Phi_true_fn(y)[None], t, 3, batch_size=200)
    assert float(out["relative error of interaction gradient"]) < 1e-6
    model = PotentialMLP(2, [16, 16], 8, generator=torch.Generator().manual_seed(0))
    out = tloss.test_fn(lambda y: model(y), t, 3, batch_size=200)
    assert np.isfinite(float(out["relative error of interaction gradient"]))


@pytest.mark.parametrize("key,item", [("w_0T", "item 14"), ("tau_0T_groups", "item 17"),
                                      ("tau_0T_per_traj", "item 17")])
def test_unported_batch_layouts_raise(inst, key, item):
    _, t = inst
    _, td = _batch()
    td[key] = torch.ones(3)
    with pytest.raises(NotImplementedError, match=item):
        tloss.make_loss_fn(lambda p, y: y.sum(-1, keepdim=True), td, t)
