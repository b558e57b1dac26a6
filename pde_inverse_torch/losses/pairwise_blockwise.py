"""Blockwise pairwise mean-field statistics for PotentialMLP interaction
kernels (counterpart of pde_inverse_tpu/losses/pairwise_blockwise.py).

For y = x_{i,t} - r_{j,t} the network's first linear stage factors through
per-point projections: (x - r) W0 = x W0 - r W0, and the Fourier phases
(x - r) B = px - pr.  The pairwise work therefore starts at the first-layer
preactivation z0 = ax_i - ar_j with tangent av_i, where one second-order
forward pass gives Phi and v^T Hess Phi v and one reverse sweep gives
dPhi/dz0; its masked sums over the refs, projected back with W0^T (and
B^T), are E_ref grad Phi.  The quadratic skip head is exact per-stamp
sufficient statistics.

Routes (``solver.train.kmv_pallas``):

* "off": the plain formulation (``_tile_stats``, Fourier front end
  included) over ref chunks of at most ``rows_per_chunk`` pair rows, each
  chunk recomputed in the backward pass (``torch.utils.checkpoint``), the
  parameter gradient by autograd;
* "on": K5 forward and K6 backward (``ops/cuda/pairwise.py``) behind one
  ``torch.autograd.Function`` over (layers after the first, ax, av, ar);
  the first-layer projections stay outside it as differentiable torch;
* "fwd": K5 forward, the VJP of K5's plain version;
* "packed": K7 and K8 behind a Function over (hidden layers, M, u, ax, av,
  ar), with M = W_F W_F^T, u = 2 W_F b_F and c = |b_F|^2 built outside it;
  c sum(mask) is added to the value there;
* "auto": on CUDA tensors, where ``pallas_supported`` holds, the kernels
  ``pk.choose`` gives for the chain's widths: K7/K8 ("packed") where every
  width before the feature layer is <= 32, else K5/K6; else (a Fourier
  front end) the plain formulation; on CPU tensors the plain formulation.

On CPU tensors "on", "fwd" and "packed" run the kernels' plain versions
behind the same Functions.  A kernel that fails to build or launch raises.
Under ``torch.func.grad`` a Function's backward gets tensors without a
device pointer, so the KMV loss takes its parameter gradient with
``torch.autograd``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.func import jvp, vjp
from torch.utils.checkpoint import checkpoint

from pde_inverse_torch.ops.activations import ACT_D012, ACTIVATIONS, supported_activation
from pde_inverse_torch.ops.cuda import pairwise as pk

ROWS_PER_CHUNK = 1 << 20  # pair rows per chunk of the plain formulation
MODES = ("auto", "on", "fwd", "packed", "off")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"solver.train.kmv_pallas must be one of {MODES}, got {mode!r}")


def supports(module) -> bool:
    """PotentialMLP stacks (any Fourier front end or quadratic head)."""
    from pde_inverse_torch.models.mlp import PotentialMLP

    return isinstance(module, PotentialMLP)


def pallas_supported(module) -> bool:
    """The K5/K6 kernels take plain MLP stacks: no Fourier front end (the
    quadratic head is exact statistics outside them) and an activation with
    a derivative table."""
    return supports(module) and module.fourier_features == 0 and supported_activation(module.activation)


def _act_d012(act_name: str, z: torch.Tensor):
    """(act, act', act'') from the derivative table, or by nested forward
    derivatives for an activation without one (as the JAX package does)."""
    if act_name in ACT_D012:
        return ACT_D012[act_name](z)
    act = ACTIVATIONS[act_name]
    ones = torch.ones_like(z)
    d1 = lambda t: jvp(act, (t,), (torch.ones_like(t),))[1]
    a, da = jvp(act, (z,), (ones,))
    return a, da, jvp(d1, (z,), (ones,))[1]


def _quad_head_stats(A, b, x, v, refs, valid):
    """Exact per-stamp mean-field SUMS over refs of q(y) = 1/2 |A y|^2 + b.y:
    x, v [n, nt, d]; refs [m, nt, d] with weights valid [m].  With H = A^T A,
    m_t = sum_j w_j, rsum_t = sum_j w_j r_j, rsq_t = sum_j w_j r_j^T H r_j:
    value = m_t/2 x^T H x - x^T H rsum + rsq/2 + m_t b.x - b.rsum,
    nabla = m_t H x - H rsum + m_t b, hess = m_t v^T H v."""
    H = A.T @ A
    w = valid.to(x.dtype)
    m_t = torch.sum(w)
    rsum = torch.einsum("m,mtd->td", w, refs)
    rsq = torch.einsum("m,mtd,de,mte->t", w, refs, H, refs)
    xH = x @ H
    value = (0.5 * m_t * torch.einsum("ntd,ntd->nt", xH, x) - torch.einsum("ntd,td->nt", xH, rsum)
             + 0.5 * rsq[None, :] + m_t * (x @ b) - (rsum @ b)[None, :])
    nabla = m_t * xH - (rsum @ H)[None] + m_t * b
    hess = m_t * torch.einsum("ntd,de,nte->nt", v, H, v)
    return {"value": value, "nabla_direct": nabla, "hess": hess}


def _mlp_structure(module, params):
    """(layers [(W [in, out], b)], fourier_B or None, (quad_A, quad_b) or
    None) of a PotentialMLP's parameter dict."""
    layers = [(params[f"Dense_{k}.weight"].T, params[f"Dense_{k}.bias"]) for k in range(module.n_layers)]
    B = params["fourier_B"] if module.fourier_features > 0 else None
    quad = (params["quad_A"], params["quad_b"]) if module.quadratic_head else None
    return layers, B, quad


def _tile_stats(layers, act_name, ax, ar_c, av, px, pr_c, pv, mask_c):
    """Pairwise stats of one ref chunk, masked-summed over the chunk.

    ax/av [n, nt, w0] first-layer projections of points and velocities (ax
    with the bias); ar_c [c, nt, w0] of the chunk's refs; px/pv/pr_c the
    Fourier phases (or None); mask_c [c].  Returns per-point sums, flat:
    {"value" [n*nt], "hess" [n*nt], "s_dz0" [n*nt, w0], "s_dproj" [n*nt, nf]}.
    """
    (W0, _), mids = layers[0], layers[1:]
    c = ar_c.shape[0]
    n, nt, w0 = ax.shape
    z = (ax[None] - ar_c[:, None]).reshape(-1, w0)
    dz = av[None].expand(c, n, nt, w0).reshape(-1, w0)
    d2z = torch.zeros_like(z)
    trig = None
    if px is not None:
        nf = px.shape[-1]
        d = W0.shape[0] - 2 * nf  # W0 rows: [y; cos; sin]
        W0c, W0s = W0[d: d + nf], W0[d + nf:]
        p = (px[None] - pr_c[:, None]).reshape(-1, nf)
        dp = pv[None].expand(c, n, nt, nf).reshape(-1, nf)
        cosp, sinp = torch.cos(p), torch.sin(p)
        dp2 = dp * dp
        z = z + cosp @ W0c + sinp @ W0s
        dz = dz + (-sinp * dp) @ W0c + (cosp * dp) @ W0s
        d2z = d2z + (-cosp * dp2) @ W0c + (-sinp * dp2) @ W0s
        trig = (cosp, sinp, W0c, W0s)

    preacts = []
    for W, b in mids:
        preacts.append(z)
        a, da, d2a = _act_d012(act_name, z)
        z, dz, d2z = a @ W + b, (da * dz) @ W, (d2a * dz * dz + da * d2z) @ W
    f = torch.sum(z * z, dim=-1)
    d2f = 2.0 * torch.sum(dz * dz + z * d2z, dim=-1)
    delta = 2.0 * z
    for (W, _), zk in zip(reversed(mids), reversed(preacts)):
        delta = (delta @ W.T) * _act_d012(act_name, zk)[1]

    N = n * nt
    w = mask_c.to(z.dtype)

    def msum(t):
        return torch.einsum("c,c...->...", w, t.reshape(c, N, *t.shape[1:]))

    out = {"value": msum(f), "hess": msum(d2f), "s_dz0": msum(delta)}
    if trig is not None:
        cosp, sinp, W0c, W0s = trig
        out["s_dproj"] = msum((delta @ W0c.T) * (-sinp) + (delta @ W0s.T) * cosp)
    return out


def _pairs(flat):
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(flat) // 2)]


class _PairwiseSums(torch.autograd.Function):
    """(value, hess, s_dz0) = K5(mids, ax, av, ar) with the VJP from K6
    (backward_mode "kernel") or from K5's plain version ("plain").  Layers
    are passed flat so that autograd sees each one."""

    @staticmethod
    def forward(act_name, backward_mode, mask, ax, av, ar, *flat):
        out = pk.mlp_pairwise_sums(_pairs(flat), act_name, ax, av, ar, mask)
        return out["value"], out["hess"], out["s_dz0"]

    @staticmethod
    def setup_context(ctx, inputs, output):
        act_name, backward_mode, *tensors = inputs
        ctx.act_name, ctx.backward_mode = act_name, backward_mode
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, g_val, g_hess, g_dz0):
        mask, ax, av, ar, *flat = ctx.saved_tensors
        if ctx.backward_mode == "kernel":
            mids_bar, ax_bar, av_bar, ar_bar = pk.mlp_pairwise_sums_bwd(
                _pairs(flat), ctx.act_name, ax, av, ar, mask, g_val, g_hess, g_dz0
            )
            flat_bar = [t for pair in mids_bar for t in pair]
        else:
            def plain(ax_, av_, ar_, *f):
                o = pk.mlp_pairwise_sums_plain(_pairs(f), ctx.act_name, ax_, av_, ar_, mask)
                return o["value"], o["hess"], o["s_dz0"]

            _, pullback = vjp(plain, ax, av, ar, *flat)
            ax_bar, av_bar, ar_bar, *flat_bar = pullback((g_val, g_hess, g_dz0))
        return (None, None, None, ax_bar, av_bar, ar_bar, *flat_bar)


class _PackedSums(torch.autograd.Function):
    """(value without c, hess, s_dz0) = K7(mids_m, M, u, ax, av, ar) with
    the VJP from K8."""

    @staticmethod
    def forward(act_name, mask, M, u, ax, av, ar, *flat):
        out = pk.mlp_pairwise_sums_packed(_pairs(flat), M, u, act_name, ax, av, ar, mask)
        return out["value"], out["hess"], out["s_dz0"]

    @staticmethod
    def setup_context(ctx, inputs, output):
        act_name, *tensors = inputs
        ctx.act_name = act_name
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, g_val, g_hess, g_dz0):
        mask, M, u, ax, av, ar, *flat = ctx.saved_tensors
        mids_bar, M_bar, u_bar, ax_bar, av_bar, ar_bar = pk.mlp_pairwise_sums_packed_bwd(
            _pairs(flat), M, u, ctx.act_name, ax, av, ar, mask, g_val, g_hess, g_dz0
        )
        return (None, None, M_bar, u_bar, ax_bar, av_bar, ar_bar,
                *(t for pair in mids_bar for t in pair))


def route(module, mids, mode: str, device: torch.device) -> str:
    """The route `mode` takes for `module` on `device`: "plain", "v1",
    "v1-fwd" or "packed" (where ``pk.choose`` gives K7/K8 for the widths of
    `mids`, the layers after the first, as the JAX dispatch decides)."""
    check_mode(mode)
    if mode == "off" or (mode == "auto" and torch.device(device).type != "cuda"):
        return "plain"
    if pallas_supported(module):
        widths = [W.shape[0] for W, _ in mids] + [mids[-1][0].shape[1]]
        if pk.choose(widths, mode)[0] == "k7":
            return "packed"
        if mode != "packed":
            return {"auto": "v1", "on": "v1", "fwd": "v1-fwd"}[mode]
    elif mode == "auto":
        return "plain"
    raise ValueError(
        f"solver.train.kmv_pallas={mode} needs a PotentialMLP without a Fourier front end, "
        f"with a tabled activation{' and widths <= 32' if mode == 'packed' else ''}"
    )


def mlp_pairwise_stats(
    module,
    params,
    x: torch.Tensor,
    v: torch.Tensor,
    refs: torch.Tensor,
    rows_per_chunk: int = ROWS_PER_CHUNK,
    pallas_mode: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Per-stamp mean over refs of {Phi, grad Phi, v^T Hess Phi v} at
    y = x_{i,t} - r_{j,t}: x, v [n, nt, d]; refs [m, nt, d] (the refs at the
    same stamp).  Returns {"nabla" [n, nt, d], "hess" [n, nt], "value"
    [n, nt]}, as the generic path does."""
    n, nt, d = x.shape
    m = refs.shape[0]
    layers, B, quad = _mlp_structure(module, params)
    (W0, b0), mids = layers[0], layers[1:]
    W0y = W0[:d]
    valid = torch.ones((m,), dtype=x.dtype, device=x.device)
    path = route(module, mids, pallas_mode, x.device)
    act = module.activation

    if path == "plain":
        ax, av, ar = x @ W0y + b0, v @ W0y, refs @ W0y
        px = pv = pr = None
        if B is not None:
            px, pv, pr = x @ B, v @ B, refs @ B
        chunk = max(1, min(m, rows_per_chunk // max(n * nt, 1)))
        sums: Optional[Dict[str, torch.Tensor]] = None
        for j0 in range(0, m, chunk):
            j1 = min(m, j0 + chunk)
            part = checkpoint(
                _tile_stats, layers, act, ax, ar[j0:j1], av, px,
                None if pr is None else pr[j0:j1], pv, valid[j0:j1], use_reentrant=False,
            )
            sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
        sums = {k: s.reshape(n, nt, *s.shape[1:]) for k, s in sums.items()}
    else:
        ax = torch.einsum("ntd,dw->tnw", x, W0y) + b0
        av = torch.einsum("ntd,dw->tnw", v, W0y)
        ar = torch.einsum("mtd,dw->tmw", refs, W0y)
        ax, av, ar = ax.contiguous(), av.contiguous(), ar.contiguous()
        if path == "packed":
            WF, bF = mids[-1]
            M, u, c = WF @ WF.T, 2.0 * (WF @ bF), bF @ bF
            flat = [t.contiguous() for pair in mids[:-1] for t in pair]
            value, hess, s_dz0 = _PackedSums.apply(act, valid, M.contiguous(), u.contiguous(),
                                                   ax, av, ar, *flat)
            value = value + c * torch.sum(valid)
        else:
            flat = [t.contiguous() for pair in mids for t in pair]
            value, hess, s_dz0 = _PairwiseSums.apply(
                act, "plain" if path == "v1-fwd" else "kernel", valid, ax, av, ar, *flat
            )
        sums = {"value": value.T, "hess": hess.T, "s_dz0": s_dz0.transpose(0, 1)}

    nabla = sums["s_dz0"] @ W0y.T
    if "s_dproj" in sums:
        nabla = nabla + sums["s_dproj"] @ B.T
    value, hess = sums["value"], sums["hess"]
    if quad is not None:
        qs = _quad_head_stats(quad[0], quad[1], x, v, refs, valid)
        value, hess, nabla = value + qs["value"], hess + qs["hess"], nabla + qs["nabla_direct"]
    return {"nabla": nabla / m, "hess": hess / m, "value": value / m}
