"""Non-parametric potential hypotheses (counterpart of
pde_inverse_tpu/models/mlp.py).

Every module maps one point x [d] or a batch [n, d] to [1] or [n], so the
scalar potential at a point is ``model(x)[0]`` as in the JAX package.
Submodules and parameters carry the flax names (``Dense_0 ... Dense_L``,
``fourier_B``, ``quad_A``, ``quad_b``), so ``convert.from_flax_params``
carries a flax parameter tree across unchanged; a Dense layer is an
``nn.Linear`` (weight [out, in]).

Initialisation follows flax's initialisers in distribution (the random
numbers differ): Kaiming-normal (``he_normal``: truncated normal, fan-in,
scale 2) Dense kernels and zero biases in ``PotentialMLP``, LeCun-normal
(scale 1) in the ResNet and bilinear modules, N(0, fourier_scale^2) for
``fourier_B``, N(0, 0.1^2) for ``quad_A`` and zeros for ``quad_b``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from pde_inverse_torch.ops.activations import ACTIVATIONS

# flax's variance_scaling(..., "truncated_normal") draws from N(0, 1)
# truncated to [-2, 2] and divides by that law's standard deviation
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal") on an
    nn.Linear weight [out, in]."""
    std = math.sqrt(scale / w.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _dense(n_in: int, n_out: int, scale: float, generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        _variance_scaling_(layer.weight, scale, generator)
        layer.bias.zero_()
    return layer


def _point_or_batch(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return value[None] if x.ndim == 1 else value


def _check_dtype(dtype: str) -> None:
    if dtype != "float32":
        raise NotImplementedError(
            f"neural_network.dtype={dtype} (a bfloat16 hidden path) is not ported "
            "yet: ROADMAP queue 1, item 27"
        )


class PotentialMLP(nn.Module):
    """V(x) = sum_i h(x)_i^2 with h an MLP: smooth, >= 0, scalar.

    Optional trainable random-Fourier front end (``fourier_features > 0``):
    the input is augmented with [cos(xB), sin(xB)].  Optional PSD-quadratic
    skip head (``quadratic_head``): V += 1/2 ||A x||^2 + b.x.
    """

    def __init__(
        self,
        dim: int,
        hidden_dims: Sequence[int],
        feature_dim: int = 128,
        activation: str = "tanh",
        dtype: str = "float32",
        fourier_features: int = 0,
        fourier_scale: float = 1.0,
        quadratic_head: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_dtype(dtype)
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; available: {sorted(ACTIVATIONS)}")
        self.dim = dim
        self.hidden_dims = list(hidden_dims)
        self.feature_dim = feature_dim
        self.activation = activation
        self.fourier_features = fourier_features
        self.quadratic_head = quadratic_head
        if fourier_features > 0:
            self.fourier_B = nn.Parameter(
                torch.randn((dim, fourier_features), generator=generator) * fourier_scale
            )
        widths = [dim + 2 * fourier_features, *self.hidden_dims, feature_dim]
        for k in range(len(widths) - 1):
            self.add_module(f"Dense_{k}", _dense(widths[k], widths[k + 1], 2.0, generator))
        if quadratic_head:
            self.quad_A = nn.Parameter(torch.randn((dim, dim), generator=generator) * 0.1)
            self.quad_b = nn.Parameter(torch.zeros(dim))

    @property
    def n_layers(self) -> int:
        """Dense layers, the feature layer included."""
        return len(self.hidden_dims) + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        h = x
        if self.fourier_features > 0:
            proj = h @ self.fourier_B
            h = torch.cat([h, torch.cos(proj), torch.sin(proj)], dim=-1)
        for k in range(self.n_layers - 1):
            h = act(getattr(self, f"Dense_{k}")(h))
        h = getattr(self, f"Dense_{self.n_layers - 1}")(h)
        value = torch.sum(h * h, dim=-1)
        if self.quadratic_head:
            Ax = x @ self.quad_A.T
            value = value + 0.5 * torch.sum(Ax * Ax, dim=-1) + x @ self.quad_b
        return _point_or_batch(x, value)


class BilinearDebugPotential(nn.Module):
    """V(x) = x . (W x + c): one Dense map contracted against the input, an
    exact quadratic form for the symmetric part of W."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = _dense(dim, dim, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _point_or_batch(x, torch.sum(x * self.Dense_0(x), dim=-1))


class ResNetPotential(nn.Module):
    """Residual-block MLP with the sum-of-squares head.  Dense layers are
    numbered in call order as flax numbers them: Dense_0 the stem, Dense_{2b+1}
    and Dense_{2b+2} block b, Dense_{2 n_blocks + 1} the feature layer."""

    def __init__(
        self,
        dim: int,
        hidden_dim: int,
        n_blocks: int,
        feature_dim: int = 128,
        activation: str = "tanh",
        dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_dtype(dtype)
        self.n_blocks = n_blocks
        self.activation = activation
        self.Dense_0 = _dense(dim, hidden_dim, 1.0, generator)
        for k in range(1, 2 * n_blocks + 1):
            self.add_module(f"Dense_{k}", _dense(hidden_dim, hidden_dim, 1.0, generator))
        self.add_module(
            f"Dense_{2 * n_blocks + 1}", _dense(hidden_dim, feature_dim, 1.0, generator)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        dense = lambda k: getattr(self, f"Dense_{k}")
        h = dense(0)(x)
        for b in range(self.n_blocks):
            r = dense(2 * b + 1)(act(h))
            h = h + dense(2 * b + 2)(act(r))
        h = dense(2 * self.n_blocks + 1)(act(h))
        return _point_or_batch(x, torch.sum(h * h, dim=-1))
