"""Fused per-point {grad V, v^T Hess V v} provider for the kinetic
Fokker-Planck weak-form loss (counterpart of
pde_inverse_tpu/losses/fused_pointwise.py).

``grad_and_quadform(module, params, x, v)`` returns, for a PotentialMLP,

    nabla[i] = grad V(x_i)            [n, d]
    quad[i]  = v_i^T Hess V(x_i) v_i  [n]

differentiable w.r.t. ``params`` with ``torch.autograd`` (and, on CPU
tensors, with ``torch.func.grad``).  Decomposition:

* the first linear stage (plain rows W0y plus the Fourier rows W0c/W0s on
  [cos(xB), sin(xB)]) gives per-point streams (z1, d_v z1, d_v^2 z1) at the
  first-layer preactivation: with a Fourier front end K9
  (``ops/cuda/pointwise.front_streams``), with K10 as its VJP, where
  ``front_fits`` names the shape, else its plain version; without one,
  z1 = x W0y + b0 here;
* K3 (``ops/cuda/pointwise.mlp_grad_quad``) propagates them through the
  remaining layers and returns {quad, delta = dV/dz1}; K4 is its VJP;
* nabla comes back through the front end's Jacobian:
  nabla = delta W0y^T + [(delta W0c^T)(-sin p) + (delta W0s^T)(cos p)] B^T;
* the quadratic skip head is exact closed form here.

The matrix products outside the kernels are plain ``torch`` ops, as the
JAX package leaves them to XLA.  Modes (``solver.train.kfp_fused``):
"auto" runs the kernels on CUDA tensors and leaves CPU tensors on the
autodiff path; "on" runs K9, K3, K4 and K10; "fwd" runs K9 and K3 with the
VJP of the plain versions; "xla" differentiates the plain versions; "off"
is the autodiff path (the caller does not call this provider).  On CPU
tensors "on" and "fwd" run the kernels' plain versions behind the same
``torch.autograd.Function``s.
"""

from __future__ import annotations

import torch
from torch.func import vjp

from pde_inverse_torch.ops.activations import supported_activation
from pde_inverse_torch.ops.cuda import pointwise as pk

MODES = ("auto", "on", "fwd", "xla", "off")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"solver.train.kfp_fused must be one of {MODES}, got {mode!r}")


def active(mode: str, device: torch.device) -> bool:
    """Whether the provider replaces the autodiff path: 'auto' engages on
    CUDA only (the CPU keeps the autodiff formulation), the explicit modes
    always do."""
    _check_mode(mode)
    return mode in ("on", "fwd", "xla") or (mode == "auto" and torch.device(device).type == "cuda")


def supported(module) -> bool:
    """PotentialMLP stacks (any Fourier front end or quadratic head) with an
    activation the kernels' derivative tables cover."""
    from pde_inverse_torch.models.mlp import PotentialMLP

    return isinstance(module, PotentialMLP) and supported_activation(module.activation)


def _kernels(mode: str, device: torch.device) -> bool:
    """Whether `mode` runs the kernels (or, on CPU tensors, their plain
    versions behind the same autograd Functions)."""
    return mode in ("on", "fwd") or (mode == "auto" and device.type == "cuda")


class _FrontEnd(torch.autograd.Function):
    """(z1, dz1, d2z1, cos p, sin p) = K9(x, v, B, W0, b0) with the VJP from
    K10 (``backward_mode="kernel"``) or from differentiating the plain
    version (``"plain"``).  cos p and sin p are outputs, so that the recovery
    of nabla reads them and their cotangents reach K10 beside the streams'.
    K10 gives no gradient for the points x and v."""

    @staticmethod
    def forward(backward_mode, x, v, B, W0, b0):
        return pk.front_streams(x, v, B, W0, b0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        backward_mode, *tensors = inputs
        ctx.backward_mode = backward_mode
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *bars):
        x, v, B, W0, b0 = ctx.saved_tensors
        if ctx.backward_mode == "kernel":
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                raise ValueError("the front end's VJP (K10) gives no gradient for x and v")
            B_bar, W0_bar, b0_bar = pk.front_streams_bwd(x, v, B, W0, *bars)
            return None, None, None, B_bar, W0_bar, b0_bar
        _, pullback = vjp(pk.front_streams_plain, x, v, B, W0, b0)
        return (None, *pullback(bars))


def _streams(module, params, x, v, mode):
    """First-layer preactivation streams (z1, d_v z1, d_v^2 z1), the layers
    after the first as [(W [w_in, w_out], b)], and the projection context
    for recovering nabla from delta."""
    dense = lambda k: (params[f"Dense_{k}.weight"].T, params[f"Dense_{k}.bias"])
    W0, b0 = dense(0)
    mids = [dense(k) for k in range(1, module.n_layers)]
    d, nf = x.shape[-1], module.fourier_features
    W0y = W0[:d]
    if nf == 0:
        z1 = x @ W0y + b0
        return mids, z1, v @ W0y, torch.zeros_like(z1), None, W0y
    B = params["fourier_B"]
    if _kernels(mode, x.device) and (x.device.type == "cpu" or pk.front_fits(d, nf, W0.shape[1])):
        streams = _FrontEnd.apply("plain" if mode == "fwd" else "kernel", x, v, B, W0, b0)
    else:
        streams = pk.front_streams_plain(x, v, B, W0, b0)
    z1, dz1, d2z1, cosp, sinp = streams
    return mids, z1, dz1, d2z1, (cosp, sinp, W0[d: d + nf], W0[d + nf:], B), W0y


def _pairs(flat):
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(flat) // 2)]


class _FusedSums(torch.autograd.Function):
    """(quad, delta) = K3(mids, z1, dz1, d2z1) with the VJP from K4
    (``backward_mode="kernel"``) or from differentiating the plain version
    (``"plain"``).  The layers are passed flat ([W_1, b_1, ..., W_L, b_L])
    so that each is an input autograd sees.  The function is in the
    setup_context form, so torch.func.grad accepts it, but there its
    backward receives functorch-wrapped tensors, which have no device
    pointer for K4: on CUDA tensors take the gradient through it with
    torch.autograd (the loss does)."""

    @staticmethod
    def forward(act_name, backward_mode, z1, dz1, d2z1, *flat_mids):
        return pk.mlp_grad_quad(_pairs(flat_mids), act_name, z1, dz1, d2z1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        act_name, backward_mode, *tensors = inputs
        ctx.act_name, ctx.backward_mode = act_name, backward_mode
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, g_quad, g_delta):
        z1, dz1, d2z1, *flat = ctx.saved_tensors
        mids = _pairs(flat)
        if ctx.backward_mode == "kernel":
            mids_bar, *streams_bar = pk.mlp_grad_quad_bwd(
                mids, ctx.act_name, z1, dz1, d2z1, g_quad, g_delta
            )
            flat_bar = [t for pair in mids_bar for t in pair]
        else:
            plain = lambda a, b, c, *f: pk.mlp_grad_quad_plain(_pairs(f), ctx.act_name, a, b, c)
            _, pullback = vjp(plain, z1, dz1, d2z1, *flat)
            grads = pullback((g_quad, g_delta))
            streams_bar, flat_bar = grads[:3], grads[3:]
        return (None, None, *streams_bar, *flat_bar)


def grad_and_quadform(module, params, x: torch.Tensor, v: torch.Tensor, mode: str = "auto"):
    """(nabla V [n, d], v^T Hess V v [n]) for a PotentialMLP, fused.

    mode: 'auto' (the kernels on CUDA tensors, the plain versions on CPU),
    'on' (K9, K3, K4, K10), 'fwd' (K9 and K3, the VJPs of the plain
    versions), 'xla' (the plain versions, differentiated by autograd)."""
    _check_mode(mode)
    if mode == "off":
        raise ValueError("kfp_fused=off uses the autodiff path; do not call the fused provider")
    mids, z1, dz1, d2z1, trig, W0y = _streams(module, params, x, v, mode)
    if _kernels(mode, x.device):
        # the kernels take W [w_in, w_out] row-major
        flat = [t.contiguous() for pair in mids for t in pair]
        quad, delta = _FusedSums.apply(
            module.activation, "plain" if mode == "fwd" else "kernel",
            z1.contiguous(), dz1.contiguous(), d2z1.contiguous(), *flat,
        )
    else:
        quad, delta = pk.mlp_grad_quad_plain(mids, module.activation, z1, dz1, d2z1)

    nabla = delta @ W0y.T
    if trig is not None:
        cosp, sinp, W0c, W0s, B = trig
        dproj = (delta @ W0c.T) * (-sinp) + (delta @ W0s.T) * cosp
        nabla = nabla + dproj @ B.T
    if module.quadratic_head:
        A, b = params["quad_A"], params["quad_b"]
        nabla = nabla + (x @ A.T) @ A + b
        Av = v @ A.T
        quad = quad + torch.sum(Av * Av, dim=-1)
    return nabla, quad
