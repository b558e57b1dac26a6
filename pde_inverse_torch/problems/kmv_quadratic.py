"""Kinetic McKean-Vlasov inverse problem with a quadratic interaction
(counterpart of pde_inverse_tpu/problems/kmv_quadratic.py).

For Phi(x) = 1/2 x^T F~ x the mean-field convolution stays quadratic, so the
ground-truth dynamics are those of the kinetic OU problem; what the KMV loss
adds is the first and second time derivatives of the position marginal's
log-density, which the oracle gives in closed form.
"""

from __future__ import annotations

import torch

from pde_inverse_torch.problems.kfp_ou import KineticFokkerPlanckOU


class KineticMcKeanVlasovQuadratic(KineticFokkerPlanckOU):
    # Phi_true is exactly quadratic: the loss takes the true side's
    # mean-field statistics from per-stamp sufficient statistics
    phi_true_is_quadratic = True

    def Phi_true_fn(self, x: torch.Tensor) -> torch.Tensor:
        """True interaction kernel Phi(x) = 1/2 x^T F~ x at x [..., d]."""
        return 0.5 * torch.einsum("...i,ij,...j->...", x, self.tilde_F, x)

    def partial_s_log_density_fn(self, s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """d/ds log rho_s(x) of the position marginal: stamps s [B], the
        points of each stamp x [B, n, d] -> [B, n]."""
        return self.oracle.partial_s_logdensity(s, x, self.dim)

    def partial_s2_log_density_fn(self, s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """d2/ds2 log rho_s(x) of the position marginal (same shapes)."""
        return self.oracle.partial_s2_logdensity(s, x, self.dim)
