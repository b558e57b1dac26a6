"""Model factory (counterpart of pde_inverse_tpu/models/factory.py)."""

from __future__ import annotations

import torch

from pde_inverse_tpu.config import Config
from pde_inverse_torch.models.mlp import BilinearDebugPotential, PotentialMLP, ResNetPotential


def get_model(cfg: Config, pde_instance, generator: torch.Generator) -> torch.nn.Module:
    """Parametric models come from the problem instance (their weights are
    the physical parameters); non-parametric is an MLP (or ResNet, or the
    bilinear debug form) potential on the problem's dimension."""
    if cfg.estimation_mode == "parametric":
        return pde_instance.create_parametric_model(generator)
    if cfg.estimation_mode != "non-parametric":
        raise ValueError(f"unknown estimation_mode {cfg.estimation_mode!r}")
    net, dim = cfg.neural_network, pde_instance.dim
    if net.model == "fourier-kernel":
        raise NotImplementedError(
            "neural_network.model=fourier-kernel is not ported yet: ROADMAP queue 1, "
            "item 20 (models/fourier_kernel.py)"
        )
    if net.model == "bilinear-debug":
        model = BilinearDebugPotential(dim, generator=generator)
    elif net.model != "mlp":
        raise ValueError(f"unknown neural_network.model {net.model!r}")
    elif net.n_resblocks > 0:
        model = ResNetPotential(
            dim,
            hidden_dim=net.hidden_dim,
            n_blocks=net.n_resblocks,
            feature_dim=net.feature_dim,
            activation=net.activation,
            dtype=net.dtype,
            generator=generator,
        )
    else:
        model = PotentialMLP(
            dim,
            hidden_dims=[net.hidden_dim] * net.layers,
            feature_dim=net.feature_dim,
            activation=net.activation,
            dtype=net.dtype,
            fourier_features=net.fourier_features,
            fourier_scale=net.fourier_scale,
            quadratic_head=net.quadratic_head,
            generator=generator,
        )
    return model.to(pde_instance.device)
