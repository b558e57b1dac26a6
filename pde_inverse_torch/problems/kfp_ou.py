"""Kinetic Fokker-Planck inverse problem on a kinetic OU process, exact-law
online sampling (counterpart of pde_inverse_tpu/problems/kfp_ou.py).

Ground truth: underdamped Langevin dynamics in V_true(x) = 1/2 x^T F~ x with
friction gamma,
    dz = F z dt + sqrt(L) dW,   F = [[0, I], [-F~, -gamma I]],   L = diag(0, 2I),
whose path law is Gaussian; the moments come from the closed-form oracle
(``ops.ou.GaussianPathOracle``), so every sample is drawn from the exact law
at its time stamp.

F~ = G G^T with G ~ N(0, 1)^{d x (d+1)} is drawn from the port's own
generator (seed 2217, as the JAX package's fixed truth key), so it differs
from the JAX truth.  To run both on one ground truth, pass
``configuration={"tilde_F": <numpy [d, d]>}``.

Not ported here: tail-boost sampling (``pde_instance.init_broaden > 1``)
and the offline dataset; both raise NotImplementedError.  The KFP loss on
this instance (preset KOU) is not ported either (ROADMAP items 4-5).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from pde_inverse_torch.config import Config
from pde_inverse_torch import rng
from pde_inverse_torch.distributions import Gaussian
from pde_inverse_torch.models.parametric import QuadraticFormModel, recovered_quadratic_matrix
from pde_inverse_torch.ops import ou
from pde_inverse_torch.problems.base import ProblemInstance

_TRUTH_SEED = 2217

BatchSpec = Union[int, Tuple[int, int]]


def make_configuration(dim: int, device: torch.device, tilde_F=None, gamma: float = 1.0) -> dict:
    """The instance's constants; F~ = G G^T from the port's generator unless
    given (numpy or tensor [d, d])."""
    if tilde_F is None:
        G = torch.randn((dim, dim + 1), generator=rng.generator(_TRUTH_SEED))
        tilde_F = G @ G.T
    tilde_F = torch.as_tensor(np.array(tilde_F, np.float32), device=device)
    eye = torch.eye(dim, device=device)
    zeros = torch.zeros((dim, dim), device=device)
    block = lambda a, b, c, d: torch.cat([torch.cat([a, b], 1), torch.cat([c, d], 1)], 0)
    return {
        "gamma_friction": gamma,
        "tilde_F": tilde_F,
        "F": block(zeros, eye, -tilde_F, -gamma * eye),
        "L": block(zeros, zeros, zeros, 2.0 * eye),
        "m_0": torch.zeros(2 * dim, device=device),
        "P_0": torch.eye(2 * dim, device=device),
        "m_x_0": torch.zeros(dim, device=device),
        "P_x_0": eye,
    }


class KineticFokkerPlanckOU(ProblemInstance):
    sample_scheme = "exact"

    def __init__(
        self,
        cfg: Config,
        key: int,
        device: torch.device,
        configuration: Optional[dict] = None,
    ):
        super().__init__(cfg, device)
        if cfg.pde_instance.init_broaden > 1.0:
            raise NotImplementedError(
                "pde_instance.init_broaden>1 (tail-boost exact-law sampling) is not "
                "ported yet: ROADMAP queue 1, item 14"
            )
        if self.sample_mode != "online":
            raise NotImplementedError(
                "pde_instance.sample_mode=offline (the exact-law dataset) is not "
                "ported yet: ROADMAP queue 1, item 17"
            )
        c = make_configuration(
            self.dim, self.device,
            tilde_F=None if configuration is None else configuration["tilde_F"],
        )
        self.configuration = c
        self.gamma_friction = c["gamma_friction"]
        self.tilde_F = c["tilde_F"]
        self.oracle = ou.GaussianPathOracle.create(c["F"], c["L"], c["m_0"], c["P_0"])
        self.distribution_initial = Gaussian.create(c["m_0"], c["P_0"])
        self.distribution_initial_x = Gaussian.create(c["m_x_0"], c["P_x_0"])
        mT, PT = self.oracle.moments(self.total_evolving_time)
        self.distribution_terminal = Gaussian.create(mT, PT)

    # -- truth ---------------------------------------------------------------

    def V_true_fn(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.einsum("...i,ij,...j->...", x, self.tilde_F, x)

    # -- sampling ------------------------------------------------------------

    def _grid_times(self, key: int, n_time_stamps: int) -> torch.Tensor:
        """Stratified stamps: stamp i ~ i T/n + U[0, T/n)."""
        T = self.total_evolving_time
        u = torch.rand((n_time_stamps,), generator=rng.generator(key, self.device),
                       device=self.device)
        base = torch.linspace(0.0, T, n_time_stamps + 1, device=self.device)[:-1]
        return base + u * (T / n_time_stamps)

    def _sample_at_times(self, key: int, ts: torch.Tensor, per_time: int) -> torch.Tensor:
        """[per_time, n_time, D] samples from the exact Gaussian law at ts."""
        means, covs = self.oracle.moments_grid(ts)
        chols = ou.nan_where_failed(*torch.linalg.cholesky_ex(covs))  # NaN where a cov is not PD
        eps = torch.randn((per_time, ts.shape[0], 2 * self.dim),
                          generator=rng.generator(key, self.device), device=self.device)
        return torch.einsum("tij,ntj->nti", chols, eps) + means

    def _times(self, key_t: int, batch_size: BatchSpec):
        """(stamps, samples per stamp): random-time mode (an int spec,
        batch // 100 uniform stamps with 100 samples each) or grid mode
        ((n_time, per_time) spec, stratified stamps)."""
        if isinstance(batch_size, int):
            per_time = 100
            if batch_size < 2 * per_time:
                raise ValueError("random-time mode needs batch_size >= 200")
            n_times = batch_size // per_time
            return self.distribution_time.sample(n_times, rng.generator(key_t, self.device)), per_time
        n_times, per_time = batch_size
        return self._grid_times(key_t, n_times), per_time

    def sample_ground_truth(self, key: int, batch_size: BatchSpec) -> torch.Tensor:
        """Samples laid out so that reshape(per_time, n_time, 2d) recovers the
        (sample, stamp) axes; same key layout as get_time_sample_ground_truth."""
        key_t, key_x = rng.split(key, 2)
        ts, per_time = self._times(key_t, batch_size)
        return self._sample_at_times(key_x, ts, per_time).reshape(-1, 2 * self.dim)

    def get_time_sample_ground_truth(self, key: int, batch_size: BatchSpec) -> torch.Tensor:
        """The stamps that sample_ground_truth uses under the same key."""
        key_t, _ = rng.split(key, 2)
        return self._times(key_t, batch_size)[0]

    def sample_ground_truth_weighted(self, key: int, batch_size: BatchSpec, s=None):
        raise NotImplementedError(
            "tail-boost exact-law sampling is not ported yet: ROADMAP queue 1, item 14"
        )

    def generate_ground_truth_dataset(self, key: int) -> dict:
        raise NotImplementedError(
            "the offline exact-law dataset is not ported yet: ROADMAP queue 1, item 17"
        )

    # -- models ----------------------------------------------------------------

    def create_parametric_model(self, generator: torch.Generator) -> QuadraticFormModel:
        return QuadraticFormModel(self.dim, generator=generator).to(self.device)

    def recovered_parameter_rel_l2(self, params) -> Optional[float]:
        if "F.weight" not in params:
            return None  # non-parametric model: no physical parameter
        est = recovered_quadratic_matrix(params).detach().to(self.device)
        return float(torch.linalg.norm(est - self.tilde_F) / torch.linalg.norm(self.tilde_F))
