"""The exact-law KMV step's factorisations without host syncs: the sampler's
Cholesky and the oracle weights' solves and inverse use the
``torch.linalg.*_ex`` variants with NaN selected on the device where a
factorisation fails (``ou.nan_where_failed``).

* on positive-definite covariances each changed function is bitwise what the
  checking variants (``cholesky``, ``solve``, ``inv``) give, at the KMV
  benchmark cell's shapes (7 stamps x 2,000 samples, 2d = 4) and at odd
  batched ones;
* a covariance that is not positive definite, or singular, gives NaN at the
  call, not an exception and not finite numbers;
* a KMV ``Trainer.fit`` whose oracle covariance goes bad mid-chunk stops at
  the chunk's NaN guard, naming the step.
"""

import numpy as np
import pytest
import torch

from pde_inverse_torch import config as config_lib
from pde_inverse_torch.methods import ConsistencyBased, functional_forward
from pde_inverse_torch.ops import ou
from pde_inverse_torch.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic
from pde_inverse_torch.training import trainer

torch.set_num_threads(1)

# (stamps, samples a stamp): the benchmark cell kmv-mlp.pairs28m's, and an odd one
SHAPES = [(7, 2000), (5, 37)]


def checking_linalg(monkeypatch):
    """Make each ``torch.linalg.*_ex`` call the checking variant with an
    all-zero info: the formulation the ``_ex`` calls replaced."""
    for name in ("cholesky", "solve", "inv"):
        def ex(*args, _checked=getattr(torch.linalg, name), **kwargs):
            out = _checked(*args, **kwargs)
            return out, torch.zeros(out.shape[:-2], dtype=torch.int32, device=out.device)

        monkeypatch.setattr(torch.linalg, f"{name}_ex", ex)


@pytest.fixture(scope="module")
def kmv():
    return KineticMcKeanVlasovQuadratic(config_lib.preset("KMV"), 0, "cpu")


def _spd(gen, batch, d):
    a = torch.randn((batch, d, d), generator=gen)
    return a @ a.transpose(-1, -2) + 0.1 * torch.eye(d)


def _derivative_inputs(gen, batch, n, d):
    """(x, mean, cov, dmean, dcov, d2mean, d2cov) with PD covariances."""
    sym = lambda: (lambda a: a + a.transpose(-1, -2))(torch.randn((batch, d, d), generator=gen))
    x = torch.randn((batch, n, d), generator=gen)
    return (x, torch.randn((batch, d), generator=gen), _spd(gen, batch, d), torch.randn((batch, d), generator=gen),
            sym(), torch.randn((batch, d), generator=gen), sym())


def _derivative(order, args):
    if order == 1:
        return ou.gaussian_logdensity_time_derivative(*args[:5])
    return ou.gaussian_logdensity_time_second_derivative(*args)


@pytest.mark.parametrize("n_time,per_time", SHAPES)
def test_sampler_is_bitwise_the_checking_cholesky(kmv, monkeypatch, n_time, per_time):
    got = kmv.sample_ground_truth(3, (n_time, per_time))
    assert got.shape == (n_time * per_time, 4) and torch.isfinite(got).all()
    checking_linalg(monkeypatch)
    assert torch.equal(got, kmv.sample_ground_truth(3, (n_time, per_time)))


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("n_time,per_time", SHAPES)
def test_weights_are_bitwise_the_checking_solve_and_inv(kmv, monkeypatch, order, n_time, per_time):
    """The oracle's log-density time derivatives at the problem's own stamps
    and samples (d = 2), and the functions alone at d = 3."""
    z = kmv.sample_ground_truth(4, (n_time, per_time)).reshape(per_time, n_time, 4)
    taus = kmv.get_time_sample_ground_truth(4, (n_time, per_time))
    x = z[..., :2].transpose(0, 1)
    fn = kmv.partial_s_log_density_fn if order == 1 else kmv.partial_s2_log_density_fn
    args = _derivative_inputs(torch.Generator().manual_seed(n_time), n_time, per_time, 3)
    got = fn(taus, x), _derivative(order, args)
    assert all(torch.isfinite(g).all() for g in got)
    checking_linalg(monkeypatch)
    assert torch.equal(got[0], fn(taus, x))
    assert torch.equal(got[1], _derivative(order, args))


def test_sampler_gives_nan_where_a_covariance_is_not_positive_definite(kmv, monkeypatch):
    """Stamp 2's covariance negated: Cholesky fails there (the factor the
    `_ex` call leaves is finite) and only that stamp's samples are NaN."""
    real = ou.GaussianPathOracle.moments_grid

    def negate_stamp_2(oracle, ts):
        mean, cov = real(oracle, ts)
        return mean, torch.where((torch.arange(len(ts)) == 2)[:, None, None], -cov, cov)

    monkeypatch.setattr(ou.GaussianPathOracle, "moments_grid", negate_stamp_2)
    z = kmv.sample_ground_truth(5, (7, 11)).reshape(11, 7, 4)
    assert torch.isnan(z[:, 2]).all()
    assert torch.isfinite(z[:, [0, 1, 3, 4, 5, 6]]).all()


@pytest.mark.parametrize("order", [1, 2])
def test_weights_are_nan_where_a_covariance_is_singular(order):
    args = list(_derivative_inputs(torch.Generator().manual_seed(9), 4, 6, 2))
    v = torch.tensor([1.0, 2.0])
    args[2] = args[2].clone()
    args[2][1] = torch.outer(v, v)  # rank one: LU's second pivot is exactly 0
    out = _derivative(order, args)
    assert torch.isnan(out[1]).all()
    assert torch.isfinite(out[[0, 2, 3]]).all()


def test_failed_factorisation_stops_training_at_the_chunk_guard(monkeypatch):
    """Negated covariances from step 2 on (each step asks the oracle three
    times: the sampler, then the two derivatives of the weights): Cholesky
    fails, the solves do not, so only the sampler's NaN can stop the run;
    no exception at the calls, NaN losses, and the guard names step 2."""
    cfg = config_lib.preset("KMV", ["solver.train.sample_per_time=13", "solver.train.n_time_stamps=3",
                                    "train.number_of_iterations=4", "train.steps_per_chunk=4",
                                    "logging.writer=none"])
    inst = KineticMcKeanVlasovQuadratic(cfg, 0, "cpu")
    method = ConsistencyBased(inst, cfg, 1, "cpu")
    model, params = method.create_model_fn()
    real, calls = ou.GaussianPathOracle.moments_grid, []

    def negate_from_step_2(oracle, ts):
        mean, cov = real(oracle, ts)
        calls.append(ts)
        return mean, -cov if len(calls) > 6 else cov

    monkeypatch.setattr(ou.GaussianPathOracle, "moments_grid", negate_from_step_2)
    t = trainer.Trainer(cfg, method, 2, functional_forward(model), params)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 2"):
        t.fit()
    assert len(calls) == 12
    assert np.isfinite(t.losses[:2]).all() and np.isnan(t.losses[2:]).all()
