"""Autodiff building blocks for the weak-form losses, on ``torch.func``.

Counterpart of ``pde_inverse_tpu/ops/autodiff.py``: point functions
``f: [d] -> scalar`` are lifted over any number of leading batch axes with
``vmap``; Hessian quadratic forms come from forward-over-reverse
``jvp(grad(f))`` and never materialise the Hessian.  Every function here
composes under an outer ``torch.func.grad`` (the loss's parameter gradient).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch.func import grad, grad_and_value, jvp, vmap


def batched_grad(f: Callable, x: torch.Tensor) -> torch.Tensor:
    """grad of scalar-valued f at a batch of points x: [..., d] -> [..., d]."""
    g = grad(f)
    for _ in range(x.ndim - 1):
        g = vmap(g)
    return g(x)


def batched_grad_and_hvp_quadform(f: Callable, x: torch.Tensor, v: torch.Tensor):
    """(grad f(x) [..., d], v^T H_f(x) v [...]) in one forward-over-reverse
    pass: the primal output of jvp(grad f) is the gradient itself."""

    def one(xi, vi):
        g, hv = jvp(grad(f), (xi,), (vi,))
        return g, torch.dot(vi, hv)

    for _ in range(x.ndim - 1):
        one = vmap(one)
    return one(x, v)


def batched_value_grad_hvp_quadform(f: Callable, x: torch.Tensor, v: torch.Tensor):
    """(f(x) [...], grad f(x) [..., d], v^T H_f(x) v [...]) in one
    forward-over-reverse pass over the points x [..., d]."""

    def one(xi, vi):
        (g, val), (hv, _) = jvp(grad_and_value(f), (xi,), (vi,))
        return val, g, torch.dot(vi, hv)

    for _ in range(x.ndim - 1):
        one = vmap(one)
    return one(x, v)


def pytree_l2_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over a collection of tensors (dict values or a list)."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))
