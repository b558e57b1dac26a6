"""K3 and K4: the fused pointwise kernels (``csrc/pointwise.cu``) and their
plain PyTorch versions.

``mlp_grad_quad`` is the counterpart of
``pde_inverse_tpu.ops.pallas.pointwise_kernel.mlp_grad_quad`` (K3): given
the first-layer streams (z1, d_v z1, d_v^2 z1) [n, w0] of a PotentialMLP
and the layers after the first (``mids``: [(W [w_in, w_out], b [w_out])],
the JAX layout), it returns

    quad  [n]      = v^T Hess V v of the sum-of-squares head
    delta [n, w0]  = dV/dz1

``mlp_grad_quad_bwd`` is the counterpart of ``mlp_grad_quad_bwd`` (K4): the
VJP of K3 with respect to (mids, z1, dz1, d2z1) given the cotangents
(g_quad [n], g_delta [n, w0]).

For a CUDA tensor each wrapper launches its kernel on the current stream
and raises if the build or the launch fails; for a CPU tensor it runs its
plain version.  ``mlp_grad_quad.launches`` and
``mlp_grad_quad_bwd.launches`` count kernel launches (CPU calls do not
count).  All arithmetic is float32.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from pde_inverse_torch.ops.activations import ACT_D012, ACT_D0123, supported_activation
from pde_inverse_torch.ops.cuda import build

Mids = Sequence[Tuple[torch.Tensor, torch.Tensor]]

MAX_MID = 16  # layers after the first that the kernels take
_ACTS = {"tanh": 0, "silu": 1, "softplus": 2}
_TILE = 16  # points per tile, csrc/pointwise.cu kTile
_ROW = _TILE + 4  # floats per feature row of a tile in shared memory
_MAX_SHARED_BYTES = 227 * 1024  # a block's opt-in maximum on Hopper


# -- plain versions ----------------------------------------------------------------


def mlp_grad_quad_plain(mids: Mids, act_name: str, z1, dz1, d2z1):
    """K3's plain version (mirror of ``fused_pointwise._sums_jnp``): second-
    order streams through ``mids``, the head's quadform and the reverse
    sweep to delta.  Returns (quad [n], delta [n, w0])."""
    act = ACT_D012[act_name]
    z, dz, d2z = z1, dz1, d2z1
    preacts = []
    for W, b in mids:
        preacts.append(z)
        a, d1, d2 = act(z)
        d2h = d2 * dz * dz + d1 * d2z
        z = a @ W + b
        dz = (d1 * dz) @ W
        d2z = d2h @ W
    quad = 2.0 * torch.sum(dz * dz + z * d2z, dim=-1)
    delta = 2.0 * z
    for (W, _), zk in zip(reversed(mids), reversed(preacts)):
        delta = (delta @ W.T) * act(zk)[1]
    return quad, delta


def mlp_grad_quad_bwd_plain(mids: Mids, act_name: str, z1, dz1, d2z1, g_quad, g_delta):
    """K4's plain version: the VJP of K3 as the kernel computes it -- four
    forward streams (z, p = d_v z, q = d_v^2 z, r = d_g z from r0 = g_delta),
    the head cotangents of S = g_quad * quad + <g_delta, delta>, and one
    reverse sweep.  Returns ([(Wbar, bbar)], z1bar, dz1bar, d2z1bar)."""
    act3 = ACT_D0123[act_name]
    z, p, q, r = z1, dz1, d2z1, g_delta
    saved = []
    for W, b in mids:
        saved.append((z, p, q, r))
        a0, a1, a2, _ = act3(z)
        hq = a2 * p * p + a1 * q
        z, p, q, r = a0 @ W + b, (a1 * p) @ W, hq @ W, (a1 * r) @ W

    gq = g_quad[:, None]
    zbar, pbar, qbar, rbar = 2.0 * gq * q + 2.0 * r, 4.0 * gq * p, 2.0 * gq * z, 2.0 * z
    mids_bar: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for (W, _), (zk, pk, qk, rk) in zip(reversed(mids), reversed(saved)):
        a0, a1, a2, a3 = act3(zk)
        h, hp, hq, hr = a0, a1 * pk, a2 * pk * pk + a1 * qk, a1 * rk
        wbar = h.T @ zbar + hp.T @ pbar + hq.T @ qbar + hr.T @ rbar
        mids_bar.append((wbar, torch.sum(zbar, dim=0)))
        hbar, hpbar, hqbar, hrbar = zbar @ W.T, pbar @ W.T, qbar @ W.T, rbar @ W.T
        zbar = hbar * a1 + hpbar * (a2 * pk) + hrbar * (a2 * rk) + hqbar * (a3 * pk * pk + a2 * qk)
        pbar = hpbar * a1 + hqbar * (2.0 * a2 * pk)
        qbar = hqbar * a1
        rbar = hrbar * a1
    return mids_bar[::-1], zbar, pbar, qbar


# -- kernels -----------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = build.load("pointwise")
    if lib.k3_mlp_grad_quad.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        common = [ci, ci, ci, ctypes.POINTER(ci), ci]  # device, act, n_mid, widths, n
        lib.k3_mlp_grad_quad.argtypes = common + [vp, vp, vp, vp, vp, vp, vp, vp]
        lib.k4_mlp_grad_quad_bwd.argtypes = common + [ci] + [vp] * 13
        lib.k4_max_blocks.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        for fn in (lib.k3_mlp_grad_quad, lib.k4_mlp_grad_quad_bwd, lib.k4_max_blocks):
            fn.restype = ci
    return lib


def shared_bytes(widths: Sequence[int], n_streams: int) -> int:
    """Dynamic shared memory of one block: every layer's streams for a tile
    of points plus one activated copy of the widest layer input, rows padded
    to a multiple of 4 features."""
    rows = sum(widths) + (-(-max(widths[:-1]) // 4) * 4)
    return n_streams * rows * _ROW * 4


def _check(mids: Mids, act_name: str, tensors, name: str):
    """Validate the kernel's inputs; returns (widths, packed W|b, packed W^T)."""
    if not supported_activation(act_name):
        raise ValueError(f"{name}: activation {act_name!r} has no derivative table")
    if not 1 <= len(mids) <= MAX_MID:
        raise ValueError(f"{name} takes 1..{MAX_MID} layers after the first, got {len(mids)}")
    dev = tensors[0].device
    n, w0 = tensors[0].shape
    widths = [w0]
    for W, b in mids:
        if W.ndim != 2 or W.shape[0] != widths[-1] or tuple(b.shape) != (W.shape[1],):
            raise ValueError(f"{name}: layer shapes {tuple(W.shape)}, {tuple(b.shape)} do not chain")
        widths.append(W.shape[1])
    for t in [*tensors, *(x for pair in mids for x in pair)]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: every input must be float32 on {dev}, got {t.dtype} on {t.device}")
    if not 1 <= n < 2**31:
        raise ValueError(f"{name}: need 1 <= n < 2^31 points, got {n}")
    params = torch.cat([x for W, b in mids for x in (W.reshape(-1), b)])
    params_t = torch.cat([W.t().reshape(-1) for W, _ in mids])
    return widths, params, params_t.contiguous()


def _rows(t: torch.Tensor, n: int, w: int, what: str) -> torch.Tensor:
    if tuple(t.shape) != (n, w):
        raise ValueError(f"{what} must be [{n}, {w}], got {tuple(t.shape)}")
    return t.contiguous()


def _raise(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def mlp_grad_quad(mids: Mids, act_name: str, z1, dz1, d2z1):
    """(quad [n], delta [n, w0]).  CUDA tensors: the K3 kernel; CPU
    tensors: ``mlp_grad_quad_plain``."""
    if z1.device.type == "cpu":
        return mlp_grad_quad_plain(mids, act_name, z1, dz1, d2z1)
    if z1.device.type != "cuda" or z1.ndim != 2:
        raise ValueError(f"K3 takes [n, w0] CUDA or CPU tensors, got {tuple(z1.shape)} on {z1.device}")
    widths, params, params_t = _check(mids, act_name, (z1, dz1, d2z1), "K3")
    n, w0 = z1.shape
    z1, dz1, d2z1 = (_rows(t, n, w0, "z1/dz1/d2z1") for t in (z1, dz1, d2z1))
    smem = shared_bytes(widths, 3)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"K3: widths {widths} need {smem} B of shared memory per block, "
                         f"more than {_MAX_SHARED_BYTES}")
    quad = torch.empty((n,), dtype=torch.float32, device=z1.device)
    delta = torch.empty((n, w0), dtype=torch.float32, device=z1.device)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    err = _library().k3_mlp_grad_quad(
        z1.device.index if z1.device.index is not None else torch.cuda.current_device(),
        _ACTS[act_name], len(mids), c_widths, n,
        z1.data_ptr(), dz1.data_ptr(), d2z1.data_ptr(), params.data_ptr(),
        params_t.data_ptr(), quad.data_ptr(), delta.data_ptr(),
        torch.cuda.current_stream(z1.device).cuda_stream,
    )
    _raise(err, "K3")
    mlp_grad_quad.launches += 1
    return quad, delta


def mlp_grad_quad_bwd(mids: Mids, act_name: str, z1, dz1, d2z1, g_quad, g_delta):
    """([(Wbar, bbar)], z1bar, dz1bar, d2z1bar).  CUDA tensors: the K4
    kernel (per-block partial weight gradients, then a fixed-order
    reduction: two calls give bitwise-equal results); CPU tensors:
    ``mlp_grad_quad_bwd_plain``."""
    if z1.device.type == "cpu":
        return mlp_grad_quad_bwd_plain(mids, act_name, z1, dz1, d2z1, g_quad, g_delta)
    if z1.device.type != "cuda" or z1.ndim != 2:
        raise ValueError(f"K4 takes [n, w0] CUDA or CPU tensors, got {tuple(z1.shape)} on {z1.device}")
    widths, params, params_t = _check(mids, act_name, (z1, dz1, d2z1, g_quad, g_delta), "K4")
    n, w0 = z1.shape
    z1, dz1, d2z1, g_delta = (_rows(t, n, w0, "z1/dz1/d2z1/g_delta") for t in (z1, dz1, d2z1, g_delta))
    if tuple(g_quad.shape) != (n,):
        raise ValueError(f"g_quad must be [{n}], got {tuple(g_quad.shape)}")
    g_quad = g_quad.contiguous()
    smem = shared_bytes(widths, 4)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"K4: widths {widths} need {smem} B of shared memory per block, "
                         f"more than {_MAX_SHARED_BYTES}")
    device = z1.device.index if z1.device.index is not None else torch.cuda.current_device()
    lib = _library()
    per_sm = ctypes.c_int(0)
    _raise(lib.k4_max_blocks(device, _ACTS[act_name], smem, ctypes.byref(per_sm)), "K4 occupancy query")
    n_tiles = -(-n // _TILE)
    n_sm = torch.cuda.get_device_properties(z1.device).multi_processor_count
    blocks = max(1, min(n_tiles, per_sm.value * n_sm))
    grads = torch.empty((params.numel(),), dtype=torch.float32, device=z1.device)
    partials = torch.empty((blocks, params.numel()), dtype=torch.float32, device=z1.device)
    outs = [torch.empty((n, w0), dtype=torch.float32, device=z1.device) for _ in range(3)]
    c_widths = (ctypes.c_int * len(widths))(*widths)
    err = lib.k4_mlp_grad_quad_bwd(
        device, _ACTS[act_name], len(mids), c_widths, n, blocks,
        z1.data_ptr(), dz1.data_ptr(), d2z1.data_ptr(), g_quad.data_ptr(), g_delta.data_ptr(),
        params.data_ptr(), params_t.data_ptr(), partials.data_ptr(), grads.data_ptr(),
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(z1.device).cuda_stream,
    )
    _raise(err, "K4")
    mlp_grad_quad_bwd.launches += 1
    mids_bar, off = [], 0
    for W, b in mids:
        wbar = grads[off: off + W.numel()].view(W.shape)
        off += W.numel()
        mids_bar.append((wbar, grads[off: off + b.numel()]))
        off += b.numel()
    return mids_bar, outs[0], outs[1], outs[2]


mlp_grad_quad.launches = 0
mlp_grad_quad_bwd.launches = 0
