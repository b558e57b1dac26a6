"""Closed-form Gaussian moment oracle for linear SDEs (counterpart of
pde_inverse_tpu/ops/ou.py).

For dz = A z dt + sqrt(L) dW the law stays Gaussian with
    m(t) = e^{At} m0,   P(t) = e^{At} P0 e^{A^T t} + int_0^t e^{Au} L e^{A^T u} du.

``GaussianPathOracle.create`` diagonalises A once on the host (float64
numpy, complex eigenvectors) and evaluates the moments elementwise in t:
    m(t) = Re[V (e^{lam t} * V^-1 m0)],
    P(t) = Re[V (E(t) * (B0 + C) - C) V^T],  E_ij(t) = e^{(lam_i + lam_j) t},
with B0 = V^-1 P0 V^-T, B = V^-1 L V^-T and C_ij = B_ij / (lam_i + lam_j).
The JAX package stores the complex numbers as (re, im) float32 pairs because
its TPU backend has no complex type; the port keeps them as complex64
tensors.  A drift too close to non-diagonalisable (cond(V) > 1e8) falls back
to the Kronecker-augmented matrix exponential (``torch.linalg.matrix_exp``).

The time derivatives of a Gaussian marginal's log-density follow the
Lyapunov ODE analytically (dm/dt = A m, dP/dt = A P + P A^T + L).  They are
the KMV loss weights.  Here every oracle function takes a batch of stamps
s [B] with the points of each stamp x [B, n, d] (the JAX functions take one
stamp and are vmapped).

The factorisations on the step path use the ``torch.linalg.*_ex`` variants,
which skip the checking variants' read of ``info`` back to the host (a
host-device sync every call on CUDA); ``nan_where_failed`` keeps the check
on the device, so a failed factorisation makes the step's loss NaN and the
trainer's chunk-end guard stops the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Moment propagation
# ---------------------------------------------------------------------------


def _lyapunov_augmented(A: torch.Tensor) -> torch.Tensor:
    """[[K, I], [0, 0]] with K = A (x) I + I (x) A (row-major vec)."""
    D = A.shape[0]
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    n = D * D
    aug = torch.zeros((2 * n, 2 * n), dtype=A.dtype, device=A.device)
    aug[:n, :n] = torch.kron(A, eye) + torch.kron(eye, A)
    aug[:n, n:] = torch.eye(n, dtype=A.dtype, device=A.device)
    return aug


def lti_moments_grid(A, L, m0, P0, ts: torch.Tensor):
    """(means [T, D], covs [T, D, D]) over a 1-D tensor of times, by matrix
    exponentials (the fallback of the spectral form)."""
    D = A.shape[0]
    n = D * D
    tt = ts.reshape(-1, 1, 1).to(A.dtype)
    mean = torch.linalg.matrix_exp(A[None] * tt) @ m0
    M = torch.linalg.matrix_exp(_lyapunov_augmented(A)[None] * tt)
    vecP = M[:, :n, :n] @ P0.reshape(-1) + M[:, :n, n:] @ L.reshape(-1)
    cov = vecP.reshape(-1, D, D)
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def spectral_moment_data(A, L, m0, P0, device) -> dict:
    """Host-side eigendecomposition data of the spectral oracle (float64
    numpy, stored as complex64 tensors on `device`).  Raises ValueError when
    A is too close to non-diagonalisable."""
    to = lambda t: np.asarray(t.detach().cpu() if torch.is_tensor(t) else t, np.float64)
    A, L, m0, P0 = to(A), to(L), to(m0), to(P0)
    lam, V = np.linalg.eig(A)
    if np.linalg.cond(V) > 1e8:
        raise ValueError(
            "drift matrix is too close to non-diagonalizable for the spectral "
            "oracle; use the expm path"
        )
    Vinv = np.linalg.inv(V)
    B0 = Vinv @ P0 @ Vinv.T
    B = Vinv @ L @ Vinv.T
    lam_sum = lam[:, None] + lam[None, :]
    C = B / lam_sum
    c64 = lambda z: torch.as_tensor(np.asarray(z, np.complex128), device=device).to(torch.complex64)
    return {
        "lam": c64(lam),
        "V": c64(V),
        "m0_tilde": c64(Vinv @ m0),
        "B0_plus_C": c64(B0 + C),
        "C": c64(C),
        "lam_sum": c64(lam_sum),
    }


def spectral_moments(data: dict, ts: torch.Tensor):
    """(means [..., D], covs [..., D, D]) for a time tensor of any shape,
    elementwise in t."""
    ts = ts.to(torch.float32)
    V = data["V"]
    w = torch.exp(ts[..., None] * data["lam"]) * data["m0_tilde"]  # [..., D]
    mean = torch.einsum("ij,...j->...i", V, w).real
    E = torch.exp(ts[..., None, None] * data["lam_sum"])
    inner = E * data["B0_plus_C"] - data["C"]
    cov = torch.einsum("ij,...jk,lk->...il", V, inner, V).real
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def nan_where_failed(result: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """`result` [..., r, c] of a ``torch.linalg.*_ex`` call, NaN in every
    matrix whose `info` [...] is non-zero (a failed factorisation or a
    singular solve), without reading `info` on the host."""
    return torch.where((info != 0)[..., None, None], torch.nan, result)


# ---------------------------------------------------------------------------
# Moment time-derivatives and Gaussian log-density time-derivatives
# ---------------------------------------------------------------------------


def lti_moment_derivatives(A, L, mean, cov):
    """(dm/dt, dP/dt) = (A m, A P + P A^T + L), batched over leading axes."""
    dm = mean @ A.T
    dP = A @ cov + cov @ A.T + L
    return dm, dP


def lti_moment_second_derivatives(A, L, mean, cov):
    """(d2m/dt2, d2P/dt2) = (A A m, A dP + dP A^T)."""
    dm, dP = lti_moment_derivatives(A, L, mean, cov)
    return dm @ A.T, A @ dP + dP @ A.T


def gaussian_logdensity_time_derivative(x, mean, cov, dmean, dcov):
    """d/ds log N(x; m(s), P(s)): x [B, n, d], mean/dmean [B, d], cov/dcov
    [B, d, d] -> [B, n].  With u = x - m, Ainv = P^{-1}:
    -1/2 tr(Ainv dP) + dm^T Ainv u + 1/2 u^T Ainv dP Ainv u."""
    u = x - mean[..., None, :]
    Ainv_u = nan_where_failed(*torch.linalg.solve_ex(cov[..., None, :, :], u[..., None]))[..., 0]
    Ainv_dP = nan_where_failed(*torch.linalg.solve_ex(cov, dcov))
    term_tr = -0.5 * torch.diagonal(Ainv_dP, dim1=-2, dim2=-1).sum(-1)
    term_mean = torch.einsum("...ni,...i->...n", Ainv_u, dmean)
    term_quad = 0.5 * torch.einsum("...ni,...ij,...nj->...n", Ainv_u, dcov, Ainv_u)
    return term_tr[..., None] + term_mean + term_quad


def gaussian_logdensity_time_second_derivative(x, mean, cov, dmean, dcov, d2mean, d2cov):
    """d2/ds2 log N(x; m(s), P(s)) (same shapes); with K = Ainv dP Ainv:
    1/2 tr(Ainv dP Ainv dP) - 1/2 tr(Ainv d2P) + d2m^T Ainv u - 2 dm^T K u
    - dm^T Ainv dm + 1/2 u^T Ainv d2P Ainv u - u^T K dP Ainv u."""
    tr = lambda M: torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    u = x - mean[..., None, :]
    Ainv = nan_where_failed(*torch.linalg.inv_ex(cov))
    K = Ainv @ dcov @ Ainv
    Ainv_u = u @ Ainv
    tr1 = 0.5 * tr(Ainv @ dcov @ Ainv @ dcov)
    tr2 = -0.5 * tr(Ainv @ d2cov)
    t_mm = -torch.einsum("...i,...ij,...j->...", dmean, Ainv, dmean)
    t_mean2 = torch.einsum("...ni,...i->...n", Ainv_u, d2mean)
    t_cross = -2.0 * torch.einsum("...i,...ij,...nj->...n", dmean, K, u)
    t_quad1 = 0.5 * torch.einsum("...ni,...ij,...nj->...n", Ainv_u, d2cov, Ainv_u)
    t_quad2 = -torch.einsum("...ni,...ij,...nj->...n", u @ K, dcov, Ainv_u)
    return (tr1 + tr2 + t_mm)[..., None] + t_mean2 + t_cross + t_quad1 + t_quad2


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GaussianPathOracle:
    """Exact Gaussian law of dz = A z dt + sqrt(L) dW (float32 tensors)."""

    A: torch.Tensor
    L: torch.Tensor
    m0: torch.Tensor
    P0: torch.Tensor
    spectral: Optional[dict] = None

    @classmethod
    def create(cls, A, L, m0, P0, use_spectral: bool = True) -> "GaussianPathOracle":
        spectral = None
        if use_spectral:
            try:
                spectral = spectral_moment_data(A, L, m0, P0, A.device)
            except ValueError:
                spectral = None
        return cls(A=A, L=L, m0=m0, P0=P0, spectral=spectral)

    def moments_grid(self, ts):
        """ts [T] -> (means [T, D], covs [T, D, D])."""
        ts = torch.as_tensor(ts, dtype=torch.float32, device=self.A.device).reshape(-1)
        if self.spectral is not None:
            return spectral_moments(self.spectral, ts)
        return lti_moments_grid(self.A, self.L, self.m0, self.P0, ts)

    def moments(self, t):
        """Scalar t -> (mean [D], cov [D, D])."""
        mean, cov = self.moments_grid(t)
        return mean[0], cov[0]

    def _marginal_state(self, s, dim: int):
        mean, cov = self.moments_grid(s)
        dm, dP = lti_moment_derivatives(self.A, self.L, mean, cov)
        d2m, d2P = lti_moment_second_derivatives(self.A, self.L, mean, cov)
        v, M = (lambda t: t[..., :dim]), (lambda t: t[..., :dim, :dim])
        return v(mean), M(cov), v(dm), M(dP), v(d2m), M(d2P)

    def partial_s_logdensity(self, s, x: torch.Tensor, dim: int) -> torch.Tensor:
        """d/ds log rho_s(x) of the leading dim-marginal: s [B], x [B, n, dim]
        -> [B, n]."""
        m, P, dm, dP, _, _ = self._marginal_state(s, dim)
        return gaussian_logdensity_time_derivative(x, m, P, dm, dP)

    def partial_s2_logdensity(self, s, x: torch.Tensor, dim: int) -> torch.Tensor:
        """d2/ds2 log rho_s(x) of the leading dim-marginal (same shapes)."""
        m, P, dm, dP, d2m, d2P = self._marginal_state(s, dim)
        return gaussian_logdensity_time_second_derivative(x, m, P, dm, dP, d2m, d2P)
