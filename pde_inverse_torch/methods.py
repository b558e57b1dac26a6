"""Method layer: the consistency-based estimator and its online data
policies (counterpart of pde_inverse_tpu/methods.py).

Each training step samples a batch and evaluates the weak-form loss and its
parameter gradient:

* kinetic Fokker-Planck, online SDE: (initial, terminal, path) batches from
  the problem's simulator (K1 on CUDA); for a PotentialMLP hypothesis the
  loss takes the fused pointwise provider (K3/K4 on CUDA) as
  ``solver.train.kfp_fused`` selects;
* kinetic McKean-Vlasov, online exact law: initial and terminal draws from
  the closed-form laws and a grid_time path batch with its stamps
  ``tau_0T``; the loss takes the closed-form statistics for the parametric
  quadratic model, or the blockwise pairwise reduction for a PotentialMLP
  (K5-K8 on CUDA, ``solver.train.kmv_pallas``).
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
from pde_inverse_torch.losses import pairwise_blockwise as bw
from pde_inverse_torch.models import get_model
from pde_inverse_torch.models.parametric import QuadraticFormModel


def functional_forward(model: torch.nn.Module) -> Callable:
    """forward_fn(params, x) = model(x) with the given parameter dict."""
    return lambda params, x: functional_call(model, params, (x,))


class ConsistencyBased:
    """Weak-form consistency estimator (kinetic Fokker-Planck and kinetic
    McKean-Vlasov)."""

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
        cfg = self.cfg
        if (
            cfg.pde_instance.name == "Kinetic-McKean-Vlasov"
            and cfg.estimation_mode == "non-parametric"
            and cfg.train.optimizer.weight_decay < 1e-1
            and cfg.solver.train.kmv_field_reg <= 0.0
        ):
            print(
                "[warn] non-parametric KMV without a stabilizer: the weak-form loss's "
                "linear-in-Phi terms leave unbounded finite-sample descent directions "
                "(the field norm can explode within ~1k steps). Set "
                "train.optimizer.weight_decay=1e-1."
            )
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
            **self._kmv_kwargs(),
        )

    def _kmv_closed_form(self) -> bool:
        """Parametric KMV with the exactly quadratic model: the mean-field
        reduction collapses to per-stamp sufficient statistics."""
        return (
            self.cfg.pde_instance.name == "Kinetic-McKean-Vlasov"
            and self.cfg.solver.train.kmv_closed_form
            and isinstance(self._model, QuadraticFormModel)
        )

    def _kmv_kwargs(self) -> Dict:
        """The KMV loss's model-side route: closed form, or the blockwise
        reduction for a PotentialMLP; none (the generic reduction) otherwise."""
        tr = self.cfg.solver.train
        if self.cfg.pde_instance.name != "Kinetic-McKean-Vlasov":
            return {}
        kwargs = {"element_budget": tr.kmv_element_budget}
        if self._kmv_closed_form():
            kwargs["closed_form_quadratic"] = True
        elif tr.kmv_blockwise and bw.supports(self._model):
            kwargs.update(blockwise_module=self._model, blockwise_rows=tr.kmv_blockwise_rows,
                          pallas_mode=tr.kmv_pallas)
        return kwargs

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
        tr = self.cfg.solver.train
        key_init, key_term, key_0T = rng.split(key, 3)
        if inst.sample_scheme == "exact":
            return {
                "initial": inst.distribution_initial.sample(
                    batch_size or tr.batch_size_init, rng.generator(key_init, inst.device)
                ),
                "terminal": inst.distribution_terminal.sample(
                    batch_size or tr.batch_size_terminal, rng.generator(key_term, inst.device)
                ),
            }
        n = batch_size or tr.batch_size_0T
        initial, terminal = inst.sample_boundary_only(key_0T, n)
        return {"initial": initial, "terminal": terminal}

    def _path_unsharded(self, key: int):
        inst = self.pde_instance
        tr = self.cfg.solver.train
        _, _, key_0T = rng.split(key, 3)
        if inst.sample_scheme == "exact":
            spec = (
                tr.batch_size_0T if tr.sample_mode == "random_time"
                else (tr.n_time_stamps, tr.sample_per_time)
            )
            return {
                "0T": inst.sample_ground_truth(key_0T, spec),
                "tau_0T": inst.get_time_sample_ground_truth(key_0T, spec),
            }
        return {"0T": inst.sample_path_only(key_0T, tr.batch_size_0T)}
