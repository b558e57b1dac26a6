"""Weak-form consistency loss for the kinetic Fokker-Planck equation
(counterpart of pde_inverse_tpu/losses/kinetic_fokker_planck.py).

For the candidate potential V and path samples z = [x | v]:

    loss = E_0T ||grad V||^2  -  2 E_0T [v^T Hess(V) v]
         + 2 gamma E_0T [grad V . v]  +  E_0T ||grad V_true||^2
         + (2 / T) ( E_term [grad V . v] - E_init [grad V . v] )

The gradient and the Hessian quadratic form on the path batch come from
one forward-over-reverse pass (``ops.autodiff``) or, for PotentialMLP
hypotheses, from the fused provider (``losses.fused_pointwise``: kernels
K3/K4 on CUDA), as ``solver.train.kfp_fused`` selects.  The parameter
gradient is an outer ``torch.func.grad``, or ``torch.autograd`` where the
fused provider is engaged.  The path term's forward runs in the
``pde.kfp_path`` span, the boundary terms' in ``pde.kfp_boundary``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import grad_and_value

from pde_inverse_torch import rng
from pde_inverse_torch.losses import fused_pointwise as fp
from pde_inverse_torch.ops import autodiff as ad
from pde_inverse_torch.tracing import span


def _split_xv(z: torch.Tensor):
    return torch.chunk(z, 2, dim=-1)


def _mean_sq_norm(g: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(g * g, dim=-1))


def _use_fused(fused_module, fused_mode: str, device: torch.device) -> bool:
    return (
        fused_module is not None
        and fp.active(fused_mode, device)
        and fp.supported(fused_module)
    )


def make_loss_fn(
    forward_fn: Callable,
    data: Dict[str, torch.Tensor],
    pde_instance,
    fused_module=None,
    fused_mode: str = "auto",
):
    """loss_fn(params) -> (loss, gap) over the batch `data`; gap =
    E_0T ||grad V_true - grad V||^2, the accuracy diagnostic.  With a
    supported `fused_module` and an active `fused_mode`, the path batch's
    gradient and quadform come from the fused provider."""
    x_init, v_init = _split_xv(data["initial"])
    x_term, v_term = _split_xv(data["terminal"])
    x_0T, v_0T = _split_xv(data["0T"])
    gamma = pde_instance.gamma_friction
    T = pde_instance.total_evolving_time
    nabla_V_true = ad.batched_grad(pde_instance.V_true_fn, x_0T)
    loss_nabla_true = _mean_sq_norm(nabla_V_true)
    use_fused = _use_fused(fused_module, fused_mode, x_0T.device)

    def loss_fn(params):
        V = lambda x: forward_fn(params, x)[0]
        with span("kfp_path"):
            if use_fused:
                nabla_0T, quad_0T = fp.grad_and_quadform(
                    fused_module, params, x_0T, v_0T, mode=fused_mode
                )
            else:
                nabla_0T, quad_0T = ad.batched_grad_and_hvp_quadform(V, x_0T, v_0T)
        loss_nabla = _mean_sq_norm(nabla_0T)
        loss_hessian = torch.mean(quad_0T)
        loss_friction = gamma * torch.mean(torch.sum(nabla_0T * v_0T, dim=-1))

        def boundary(x, v):
            # mean of grad V . v, safe for an empty boundary batch
            if x.shape[0] == 0:
                return torch.zeros((), dtype=x.dtype, device=x.device)
            return torch.mean(torch.sum(ad.batched_grad(V, x) * v, dim=-1))

        with span("kfp_boundary"):
            loss_initial = boundary(x_init, v_init)
            loss_terminal = boundary(x_term, v_term)
        loss = (
            loss_nabla - 2.0 * loss_hessian + 2.0 * loss_friction + loss_nabla_true
        ) + (2.0 * loss_terminal - 2.0 * loss_initial) / T
        gap = _mean_sq_norm(nabla_V_true - nabla_0T)
        return loss, gap

    return loss_fn


def value_and_grad_fn(
    forward_fn: Callable,
    params,
    data,
    pde_instance,
    fused_module=None,
    fused_mode: str = "auto",
) -> Dict[str, object]:
    """{"loss", "grad" (dict like params), "grad_norm", "loss ground truth"}."""
    loss_fn = make_loss_fn(forward_fn, data, pde_instance, fused_module, fused_mode)
    if _use_fused(fused_module, fused_mode, data["0T"].device):
        # the fused provider's autograd.Function hands raw device pointers
        # to K3/K4, which functorch-wrapped tensors (its backward's inputs
        # under torch.func.grad) do not have: take this gradient with
        # torch.autograd instead (same result, tests/test_torch_fused_pointwise.py)
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss, gap = loss_fn(leaves)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss, gap = loss.detach(), gap.detach()
    else:
        grads, (loss, gap) = grad_and_value(loss_fn, has_aux=True)(params)
    return {
        "loss": loss,
        "grad": grads,
        "grad_norm": ad.pytree_l2_norm(grads),
        "loss ground truth": gap,
    }


def gradient_rel_error(V: Callable, V_true: Callable, x: torch.Tensor) -> torch.Tensor:
    """sqrt( E||grad V - grad V_true||^2 / E||grad V_true||^2 ) over x [n, d]."""
    pred = ad.batched_grad(V, x)
    true = ad.batched_grad(V_true, x)
    return torch.sqrt(_mean_sq_norm(pred - true) / _mean_sq_norm(true))


def test_fn(
    forward_fn: Callable,
    pde_instance,
    key: int,
    batch_size: int = 10_000,
    sde_probe_trajectories: int = 1024,
) -> Dict[str, torch.Tensor]:
    """Relative L2 error of grad V at fresh initial samples and, for SDE
    instances without a closed-form terminal law, over fresh path and
    terminal samples (the weak form constrains grad V only where the path
    measure has mass).  forward_fn maps a point to [1]."""
    V = lambda x: forward_fn(x)[0]
    V_true = pde_instance.V_true_fn
    k_i, k_t, k_p = rng.split(key, 3)
    metrics = {}
    z = pde_instance.distribution_initial.sample(
        batch_size, rng.generator(k_i, pde_instance.device)
    )
    metrics["relative error of gradient estimation initial"] = gradient_rel_error(
        V, V_true, _split_xv(z)[0]
    )
    if pde_instance.distribution_terminal is not None:
        z = pde_instance.distribution_terminal.sample(
            batch_size, rng.generator(k_t, pde_instance.device)
        )
        metrics["relative error of gradient estimation terminal"] = gradient_rel_error(
            V, V_true, _split_xv(z)[0]
        )
    elif getattr(pde_instance, "sample_scheme", "") == "SDE":
        _, term, path = pde_instance.sample_ground_truth(k_p, sde_probe_trajectories)
        metrics["relative error of gradient estimation path"] = gradient_rel_error(
            V, V_true, _split_xv(path)[0]
        )
        metrics["relative error of gradient estimation terminal"] = gradient_rel_error(
            V, V_true, _split_xv(term)[0]
        )
    return metrics
