"""Probability primitives (counterpart of pde_inverse_tpu/distributions.py).

The Gaussian (slice 1) and the Uniform law of the problems' time stamps
(slice 3); the other classes of the JAX module (GaussianMixture, ...) are
ported with the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pde_inverse_torch.ops import gaussian as gops


@dataclass(frozen=True)
class Gaussian:
    mean: torch.Tensor
    cov: torch.Tensor
    chol: torch.Tensor

    @classmethod
    def create(cls, mean: torch.Tensor, cov: torch.Tensor) -> "Gaussian":
        return cls(mean=mean, cov=cov, chol=torch.linalg.cholesky(cov))

    def sample(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        return gops.gaussian_sample(generator, self.mean, self.chol, batch_size)

    def logdensity(self, x: torch.Tensor) -> torch.Tensor:
        return gops.gaussian_logdensity(x, self.mean, self.cov)


@dataclass(frozen=True)
class Uniform:
    """Uniform over an interval (scalar mins/maxs) or an axis-aligned box
    ([d] mins/maxs)."""

    mins: torch.Tensor
    maxs: torch.Tensor

    @classmethod
    def create(cls, mins, maxs, device: torch.device | str = "cpu") -> "Uniform":
        as_t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return cls(mins=as_t(mins), maxs=as_t(maxs))

    @property
    def dim(self) -> int:
        return self.mins.shape[0] if self.mins.ndim == 1 else 0

    def sample(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        shape = (batch_size, self.dim) if self.dim else (batch_size,)
        u = torch.rand(shape, generator=generator, device=self.mins.device)
        return self.mins + u * (self.maxs - self.mins)

    def logdensity(self, x: torch.Tensor) -> torch.Tensor:
        log_vol = torch.sum(torch.log(self.maxs - self.mins))
        inside = (x >= self.mins) & (x <= self.maxs)
        if self.dim:
            inside = inside.all(dim=-1)
        return torch.where(inside, -log_vol, torch.full_like(log_vol, -float("inf")))
