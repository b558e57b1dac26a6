"""Method layer: the consistency-based estimator and its online data
policy (counterpart of pde_inverse_tpu/methods.py, kinetic Fokker-Planck
online SDE path).

Each training step samples (initial, terminal, path) batches through the
problem's simulator -- K1 on CUDA -- and evaluates the weak-form loss and
its parameter gradient; for a PotentialMLP hypothesis the loss takes the
fused pointwise provider (K3/K4 on CUDA) as ``solver.train.kfp_fused``
selects.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import torch
from torch.func import functional_call

from pde_inverse_tpu.config import Config
from pde_inverse_torch import rng
from pde_inverse_torch.losses import LOSS_MODULES
from pde_inverse_torch.losses import fused_pointwise as fp
from pde_inverse_torch.models import get_model


def functional_forward(model: torch.nn.Module) -> Callable:
    """forward_fn(params, x) = model(x) with the given parameter dict."""
    return lambda params, x: functional_call(model, params, (x,))


class ConsistencyBased:
    """Weak-form consistency estimator (kinetic Fokker-Planck)."""

    def __init__(self, pde_instance, cfg: Config, key: int, device: torch.device):
        self.pde_instance = pde_instance
        self.cfg = cfg
        self.key = key
        self.device = torch.device(device)
        self._model = None

    def _loss_module(self):
        name = self.cfg.pde_instance.name
        if name not in LOSS_MODULES:
            raise NotImplementedError(f"no ported consistency loss for {name!r}")
        return LOSS_MODULES[name]

    def create_model_fn(self):
        """(model, params): params is a dict of detached tensors on the
        device; the initial weights come from a fixed generator (the JAX
        package likewise initialises from a fixed key)."""
        model = get_model(self.cfg, self.pde_instance, rng.generator(11))
        self._model = model
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        return model, params

    def value_and_grad_fn(self, forward_fn, params, key: int, step=None) -> Dict:
        key_sample, _ = rng.split(key, 2)
        data = self.sample_data(key_sample)
        return self._loss_module().value_and_grad_fn(
            forward_fn=forward_fn,
            params=params,
            data=data,
            pde_instance=self.pde_instance,
            **self._fused_kwargs(),
        )

    def _fused_kwargs(self) -> Dict:
        """The fused pointwise provider's arguments for a supported
        PotentialMLP on the kinetic Fokker-Planck loss, none otherwise."""
        if self.cfg.pde_instance.name != "Kinetic-Fokker-Planck" or not fp.supported(self._model):
            return {}
        return {"fused_module": self._model, "fused_mode": self.cfg.solver.train.kfp_fused}

    def test_fn(self, forward_fn, params, key: int) -> Dict[str, torch.Tensor]:
        return self._loss_module().test_fn(
            forward_fn=partial(forward_fn, params),
            pde_instance=self.pde_instance,
            key=key,
        )

    # -- data policy -----------------------------------------------------------

    def sample_data(self, key: int) -> Dict[str, torch.Tensor]:
        """One step's {initial, terminal, 0T} batch; boundary and path share
        the key layout of the problem's combined sample_ground_truth."""
        if self.pde_instance.sample_mode != "online":
            raise NotImplementedError(
                "offline data policies are not ported yet: ROADMAP queue 1, item 17"
            )
        return {**self._boundary_unsharded(key), **self._path_unsharded(key)}

    def _boundary_unsharded(self, key: int, batch_size=None):
        inst = self.pde_instance
        if inst.sample_scheme != "SDE":
            raise NotImplementedError(
                "exact-law sampling (KFP-OU) is not ported yet: ROADMAP queue 1, "
                "items 4-5"
            )
        _, _, key_0T = rng.split(key, 3)
        n = batch_size or self.cfg.solver.train.batch_size_0T
        initial, terminal = inst.sample_boundary_only(key_0T, n)
        return {"initial": initial, "terminal": terminal}

    def _path_unsharded(self, key: int):
        _, _, key_0T = rng.split(key, 3)
        return {
            "0T": self.pde_instance.sample_path_only(
                key_0T, self.cfg.solver.train.batch_size_0T
            )
        }
