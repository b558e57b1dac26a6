"""Problem-instance base class (counterpart of pde_inverse_tpu/problems/base.py).

An instance owns the ground-truth dynamics, the initial law, online
sampling of (initial, terminal, path) batches and, for parametric
estimation, the hypothesis model whose weights are the physical parameters.
Sampling methods take an integer key (``pde_inverse_torch.rng``) and
return tensors on the instance's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from pde_inverse_tpu.config import Config
from pde_inverse_torch.distributions import Uniform


class ProblemInstance:
    sample_scheme: str = "exact"  # exact: closed-form law; SDE: Langevin simulation
    sample_mode: str = "online"

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dim = cfg.pde_instance.domain_dim
        self.total_evolving_time = float(cfg.pde_instance.total_evolving_time)
        self.sample_mode = cfg.pde_instance.sample_mode
        # time stamps start at 1e-4, away from the degenerate t = 0 law
        self.distribution_time = Uniform.create(1e-4, self.total_evolving_time, self.device)

    def V_true_fn(self, x: torch.Tensor) -> torch.Tensor:
        """True potential at x [..., d] -> [...]."""
        raise NotImplementedError

    def sample_ground_truth(self, key: int, batch_size: int):
        raise NotImplementedError

    def create_parametric_model(self, generator: torch.Generator):
        """nn.Module whose weights are the physical parameters."""
        raise NotImplementedError

    def recovered_parameter_rel_l2(self, params) -> Optional[float]:
        """Relative L2 error of the recovered physical parameter; None when
        the model has none (non-parametric)."""
        return None
