"""Method layer: the consistency-based estimator and its data policies
(counterpart of pde_inverse_tpu/methods.py).

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
  (K5-K8 on CUDA, ``solver.train.kmv_pallas``);
* kinetic Fokker-Planck, offline: the full initial and terminal sets of the
  problem's dataset plus a strided random subsample of its trajectories
  (stride 5 in time with a random shift, 1/5 of the trajectories), or, with
  offline streaming, the trainer's per-chunk host gathers
  (``gather_stream_chunk``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from pde_inverse_torch.config import Config
from pde_inverse_torch import rng
from pde_inverse_torch.losses import LOSS_MODULES
from pde_inverse_torch.losses import fused_pointwise as fp
from pde_inverse_torch.losses import pairwise_blockwise as bw
from pde_inverse_torch.models import get_model
from pde_inverse_torch.models.parametric import QuadraticFormModel
from pde_inverse_torch.tracing import span


def functional_forward(model: torch.nn.Module) -> Callable:
    """forward_fn(params, x) = model(x) with the given parameter dict."""
    return lambda params, x: functional_call(model, params, (x,))


OFFLINE_STRIDE = 5  # time and trajectory stride of the offline subsample


def offline_batch(dataset: Dict[str, torch.Tensor], shift: int, traj_idx: torch.Tensor):
    """The offline policy's batch for a drawn (shift, traj_idx): the full
    initial and terminal sets, the trajectories traj_idx at every fifth
    stamp from `shift`, flattened, and their stamps."""
    n_time = dataset["0T"].shape[1]
    time_idx = torch.arange(n_time // OFFLINE_STRIDE, device=traj_idx.device) * OFFLINE_STRIDE + shift
    sub = dataset["0T"][traj_idx][:, time_idx]  # [n', t', 2d]
    data = {"initial": dataset["initial"], "terminal": dataset["terminal"],
            "0T": sub.reshape(-1, sub.shape[-1])}
    if "tau_0T" in dataset:
        data["tau_0T_per_traj"] = dataset["tau_0T"][traj_idx][:, time_idx]
    return data


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

    def value_and_grad_fn(self, forward_fn, params, key: int, step=None,
                          dataset: Optional[Dict[str, torch.Tensor]] = None,
                          stream_batch: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """One step's loss and gradient.  `stream_batch`: this step's
        trajectory batch gathered by the streaming loader, used with the
        dataset's initial and terminal sets; otherwise the data policy draws
        the batch (offline: from `dataset`, by default the problem's)."""
        key_sample, _ = rng.split(key, 2)
        with span("sample"):
            if stream_batch is not None:
                data = self.sample_data(key_sample, dataset, stream_batch)
            elif dataset is not None:
                data = self.sample_data(key_sample, dataset)
            else:
                data = self.sample_data(key_sample)
        with span("loss_grad"):
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

    def sample_data(self, key: int, dataset=None, stream_batch=None) -> Dict[str, torch.Tensor]:
        """One step's {initial, terminal, 0T} batch.  Online, boundary and
        path share the key layout of the problem's combined
        sample_ground_truth; offline, the subsample of `dataset` (by default
        the problem's) drawn by ``offline_draw``, or with a `stream_batch`
        (the streaming loader's gather for this step) that batch beside the
        dataset's initial and terminal sets."""
        mode = self.pde_instance.sample_mode
        if mode == "online":
            return {**self._boundary_unsharded(key), **self._path_unsharded(key)}
        if mode != "offline":
            raise ValueError(f"unknown sample mode {mode!r}")
        dataset = self.pde_instance.dataset if dataset is None else dataset
        if stream_batch is not None:
            return {"initial": dataset["initial"], "terminal": dataset["terminal"], **stream_batch}
        if "tau_groups" in dataset:
            raise NotImplementedError(
                "the grouped offline policy (tau_groups, offline KMV) is not ported yet: "
                "ROADMAP queue 1, item 17"
            )
        n_traj, n_time = dataset["0T"].shape[:2]
        return offline_batch(dataset, *self.offline_draw(key, n_traj, n_time))

    def offline_draw(self, key: int, n_traj: int, n_time: int):
        """(shift, traj_idx) of the offline subsample: a time shift in
        [0, 5) and the first n_traj // 5 entries of a permutation, drawn on
        the dataset's device from the key's generators."""
        key_time, key_sample = rng.split(key, 2)
        shift = int(torch.randint(0, OFFLINE_STRIDE, (1,), generator=rng.generator(key_time)))
        dev = self.pde_instance.device
        perm = torch.randperm(n_traj, generator=rng.generator(key_sample, dev), device=dev)
        return shift, perm[: n_traj // OFFLINE_STRIDE]

    def gather_stream_chunk(self, stream, keys: Sequence[int]) -> Dict[str, np.ndarray]:
        """Host-side gather of one chunk's trajectory batches for the
        streaming offline loader (counterpart of the JAX method's).

        stream: {"0T": memmap [n_traj, n_time, 2d], "tau_0T": memmap} kept
        on the host by the problem (pde_instance.offline_streaming); keys:
        the chunk's per-step keys.  Each step draws, from a numpy Philox
        generator keyed by its key, a time shift and
        solver.train.offline_traj_batch trajectories (sorted, so that the
        memmap reads stay near-sequential), and takes every fifth stamp from
        the shift.  Returns {"0T": [K, k * t', 2d], "tau_0T_per_traj": [K, k,
        t']} numpy arrays."""
        traj_mm, tau_mm = stream["0T"], stream.get("tau_0T")
        n_traj, n_time, d2 = traj_mm.shape
        t_len = max(1, n_time // OFFLINE_STRIDE)
        k_traj = min(self.cfg.solver.train.offline_traj_batch, n_traj)
        K = len(keys)
        z = np.empty((K, k_traj * t_len, d2), np.float32)
        taus = np.empty((K, k_traj, t_len), np.float32) if tau_mm is not None else None
        for i, key in enumerate(keys):
            gen = np.random.Generator(np.random.Philox(key=int(key)))
            shift = int(gen.integers(n_time - (t_len - 1) * OFFLINE_STRIDE))
            time_idx = np.arange(t_len) * OFFLINE_STRIDE + shift
            traj_idx = np.sort(gen.permutation(n_traj)[:k_traj])
            z[i] = traj_mm[traj_idx[:, None], time_idx].reshape(-1, d2)
            if taus is not None:
                taus[i] = tau_mm[traj_idx[:, None], time_idx]
        out = {"0T": z}
        if taus is not None:
            out["tau_0T_per_traj"] = taus
        return out

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
