"""Problem instances (counterpart of pde_inverse_tpu.problems)."""

from pde_inverse_torch.problems.kfp_gmm import KineticFokkerPlanckGMM
from pde_inverse_torch.problems.kfp_ou import KineticFokkerPlanckOU
from pde_inverse_torch.problems.kmv_quadratic import KineticMcKeanVlasovQuadratic

__all__ = ["KineticFokkerPlanckGMM", "KineticFokkerPlanckOU", "KineticMcKeanVlasovQuadratic"]
