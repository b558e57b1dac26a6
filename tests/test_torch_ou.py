"""The port's Gaussian path oracle (``pde_inverse_torch.ops.ou``) and the
exact-law KMV/KFP-OU problem against the JAX package on the CPU.

Tolerances: the moments of both packages are float32 evaluations of the
same closed form (the JAX package documents ~7e-6 absolute error of its
float32 oracle against float64, ``pde_inverse_tpu/ops/ou.py:19-21``), so
they must agree within 2e-5 absolutely.  The log-density time derivatives
divide by the covariance (and its square), which amplifies the moments'
rounding near t = 0: they are held to 1e-4 relative to each stamp's
max-abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.ops import ou as jou
from pde_inverse_tpu.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic as JaxKMV
from pde_inverse_torch.distributions import Uniform
from pde_inverse_torch.ops import ou
from pde_inverse_torch.problems.kfp_ou import KineticFokkerPlanckOU
from pde_inverse_torch.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic

torch.set_num_threads(1)

MOMENT_ATOL = 2e-5
DERIV_RTOL = 1e-4
TIMES = np.array([1e-3, 0.05, 0.2, 0.5, 0.77, 1.0], np.float32)


@pytest.fixture(scope="module")
def pair():
    cfg = config_lib.preset("KMV")
    j = JaxKMV(cfg, jax.random.PRNGKey(0))
    t = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu", configuration={"tilde_F": np.asarray(j.tilde_F)})
    return j, t


@pytest.mark.parametrize("spectral", [True, False])
def test_moments_match_jax(pair, spectral):
    j, t = pair
    c = t.configuration
    oracle = ou.GaussianPathOracle.create(c["F"], c["L"], c["m_0"], c["P_0"], use_spectral=spectral)
    assert (oracle.spectral is not None) == spectral
    jm, jc = j.oracle.moments_grid(jnp.asarray(TIMES))
    tm, tc = oracle.moments_grid(torch.from_numpy(TIMES))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=MOMENT_ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=MOMENT_ATOL)
    m1, c1 = oracle.moments(0.5)
    np.testing.assert_allclose(c1.numpy(), tc[3].numpy(), rtol=0, atol=1e-6)


def test_expm_path_matches_jax_lti_moments(pair):
    j, t = pair
    c, jc_ = t.configuration, j.configuration
    jm, jc = jou.lti_moments_grid(jc_["F"], jc_["L"], jc_["m_0"], jc_["P_0"], jnp.asarray(TIMES))
    tm, tc = ou.lti_moments_grid(c["F"], c["L"], c["m_0"], c["P_0"], torch.from_numpy(TIMES))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=MOMENT_ATOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=MOMENT_ATOL)


@pytest.mark.parametrize("order", [1, 2])
def test_logdensity_time_derivatives_match_jax(pair, order):
    j, t = pair
    x = np.random.default_rng(1).normal(size=(len(TIMES), 17, 2)).astype(np.float32) * 1.5
    jfn = j.partial_s_log_density_fn if order == 1 else j.partial_s2_log_density_fn
    tfn = t.partial_s_log_density_fn if order == 1 else t.partial_s2_log_density_fn
    want = np.stack([np.asarray(jfn(jnp.float32(s), jnp.asarray(x[i]))) for i, s in enumerate(TIMES)])
    got = tfn(torch.from_numpy(TIMES), torch.from_numpy(x)).numpy()
    for i in range(len(TIMES)):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=DERIV_RTOL * np.abs(want[i]).max())


def test_logdensity_time_derivative_matches_finite_differences(pair):
    """d/ds and d2/ds2 of log N(x; m(s), P(s)) against central differences of
    the log-density in float64 moments."""
    _, t = pair
    c = t.configuration
    A, L, m0, P0 = (c[k].double() for k in ("F", "L", "m_0", "P_0"))
    x = torch.tensor([[0.3, -0.7], [1.2, 0.4]], dtype=torch.float64)
    s, h = 0.4, 1e-3

    def logp(si):
        m, P = ou.lti_moments_grid(A, L, m0, P0, torch.tensor([si], dtype=torch.float64))
        m, P = m[0, :2], P[0, :2, :2]
        return torch.distributions.MultivariateNormal(m, P).log_prob(x)

    fd1 = (logp(s + h) - logp(s - h)) / (2 * h)
    fd2 = (logp(s + h) - 2 * logp(s) + logp(s - h)) / h**2
    got1 = t.partial_s_log_density_fn(torch.tensor([s]), x[None].float())[0].double()
    got2 = t.partial_s2_log_density_fn(torch.tensor([s]), x[None].float())[0].double()
    torch.testing.assert_close(got1, fd1, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got2, fd2, rtol=2e-2, atol=2e-2)


def test_uniform_time_law():
    u = Uniform.create(1e-4, 2.0)
    s = u.sample(10_000, torch.Generator().manual_seed(0))
    assert s.shape == (10_000,) and float(s.min()) >= 1e-4 and float(s.max()) <= 2.0
    assert abs(float(s.mean()) - 1.0) < 0.03
    lp = u.logdensity(torch.tensor([0.5, 3.0]))
    assert float(lp[0]) == pytest.approx(-np.log(2.0 - 1e-4)) and float(lp[1]) == -np.inf
    box = Uniform.create([0.0, -1.0], [1.0, 1.0])
    assert box.sample(5, torch.Generator().manual_seed(1)).shape == (5, 2)
    assert float(box.logdensity(torch.tensor([0.5, 0.0]))) == pytest.approx(-np.log(2.0))


def test_grid_times_are_stratified_and_aligned():
    cfg = config_lib.preset("KMV")
    t = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu")
    ts = t.get_time_sample_ground_truth(5, (7, 3))
    T = t.total_evolving_time
    assert ts.shape == (7,)
    for i, s in enumerate(ts.tolist()):
        assert i * T / 7 <= s < (i + 1) * T / 7
    z = t.sample_ground_truth(5, (7, 3))
    assert z.shape == (21, 4)
    torch.testing.assert_close(t.get_time_sample_ground_truth(5, (7, 3)), ts, rtol=0, atol=0)
    random_ts = t.get_time_sample_ground_truth(5, 400)
    assert random_ts.shape == (4,) and t.sample_ground_truth(5, 400).shape == (400, 4)


def test_own_truth_is_symmetric_positive_and_fixed():
    cfg = config_lib.preset("KMV")
    a = KineticFokkerPlanckOU(cfg, 0, "cpu").tilde_F
    b = KineticFokkerPlanckOU(cfg, 1, "cpu").tilde_F
    assert torch.equal(a, b) and torch.allclose(a, a.T)
    assert float(torch.linalg.eigvalsh(a).min()) > 0


def test_recovered_parameter_rel_l2_matches_jax(pair):
    j, t = pair
    W = np.random.default_rng(2).normal(size=(2, 2)).astype(np.float32)
    want = float(j.recovered_parameter_rel_l2({"params": {"F": {"kernel": jnp.asarray(W)}}}))
    got = t.recovered_parameter_rel_l2({"F.weight": torch.from_numpy(W.T.copy()), "F.bias": torch.zeros(2)})
    assert got == pytest.approx(want, rel=1e-6)
    assert t.recovered_parameter_rel_l2({"Dense_0.weight": torch.zeros(2, 2)}) is None


def test_unported_samplers_raise():
    cfg = config_lib.preset("KMV")
    t = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        t.sample_ground_truth_weighted(0, (2, 3))
    with pytest.raises(NotImplementedError, match="item 17"):
        t.generate_ground_truth_dataset(0)
    with pytest.raises(NotImplementedError, match="item 14"):
        KineticMcKeanVlasovQuadratic(config_lib.preset("KMV", ["pde_instance.init_broaden=1.3"]), 0, "cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        KineticMcKeanVlasovQuadratic(config_lib.preset("KMV-offline"), 0, "cpu")
