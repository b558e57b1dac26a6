"""Parametric hypothesis models: the weights are the physical parameters
(counterpart of pde_inverse_tpu/models/parametric.py).

Both models take one point x [d] or a batch [n, d] and return [1] or [n],
so the scalar potential at a point is ``model(x)[0]`` as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pde_inverse_torch.models.mlp import _dense
from pde_inverse_torch.potentials import GMMPotential


class QuadraticFormModel(nn.Module):
    """V(x) = x . (W x + b); the symmetric part of W estimates F~/2.  The
    kernel starts LeCun-normal and the bias at zero, as flax's Dense."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.F = _dense(dim, dim, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value = torch.sum(x * self.F(x), dim=-1)
        return value[None] if x.ndim == 1 else value


class GMMMeansModel(nn.Module):
    """GMM potential with learnable means (uniform weights, unit sigma)."""

    def __init__(
        self, dim: int, n_components: int, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.mus = nn.Parameter(torch.randn((n_components, dim), generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value = GMMPotential.create(self.mus, 1.0).value(x)
        return value[None] if x.ndim == 1 else value


def recovered_quadratic_matrix(params) -> torch.Tensor:
    """F~ estimate of a QuadraticFormModel: V(x) = x^T W x estimates
    1/2 x^T F~ x, so F~ = W + W^T (W the flax kernel, F.weight^T here)."""
    weight = params["F.weight"]
    return weight + weight.T
