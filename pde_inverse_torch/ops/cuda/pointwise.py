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
plain version.  Both kernels take widths in multiples of 8: the wrappers
zero-pad any other chain (``pad_chain``) and drop the padded columns and
gradients (``unpad_grads``), which is exact.  ``k3_plan`` chooses K3's tile
of points, the chunk of the last layer's features and whether two blocks
share an SM; ``k4_plan`` chooses K4's tile, chunk and where the block keeps
its weight-gradient sums.  ``mlp_grad_quad.launches`` and
``mlp_grad_quad_bwd.launches`` count kernel launches (CPU calls do not
count).  All arithmetic is float32.

K9 and K10 are the Fourier front end before K3 and its VJP: for the first
layer W0 [d + 2F, w0] (rows x | cos | sin), b0 [w0] and the frequencies
B [d, F], ``front_streams`` gives

    z1, dz1, d2z1 [n, w0]   the first-layer streams K3 takes
    cos p, sin p  [n, F]    p = x B, which the recovery of grad V reads

and ``front_streams_bwd`` the gradients of B, W0 and b0 for the
cotangents of all five.  They replace XLA's fusion of the same function in
the JAX package (``pde_inverse_tpu/losses/fused_pointwise.py::_streams``).
``front_fits`` says which (d, F, w0) have an instantiation; the counters
``front_streams.launches`` and ``front_streams_bwd.launches`` count kernel
launches as K3's and K4's do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from pde_inverse_torch.ops.activations import ACT_D012, ACT_D0123, supported_activation
from pde_inverse_torch.ops.cuda import build, current_stream, device_index

Mids = Sequence[Tuple[torch.Tensor, torch.Tensor]]

MAX_MID = 16  # layers after the first that the kernels take
_ACTS = {"tanh": 0, "silu": 1, "softplus": 2}
_MAX_SHARED_BYTES = 227 * 1024  # a block's opt-in maximum on Hopper
_SM_SHARED_BYTES = 228 * 1024  # an SM's, of which each resident block takes 1 KB beside its own
K3_TILES = (64, 32, 16, 8)  # points per K3 tile, largest first
K3_CHUNK = 64  # most output features of the last layer K3 holds at a time
K4_THREADS = 256  # csrc/pointwise.cu kThreads
K4_TILES = (64, 32, 16, 8)  # points per K4 tile, largest first
K4_CHUNK = 64  # most output features of the last layer held at a time
FRONT_SHAPES = ((4, 64, 64),)  # (d, F, w0) that csrc/pointwise.cu instantiates K9 and K10 at
FRONT_TILE = 32  # points a K9 block, a K10 tile


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


def front_streams_plain(x, v, B, W0, b0):
    """K9's plain version: the first-layer streams of the front end [x, cos
    p, sin p] with p = x B and dp = v B (the math of the JAX package's
    ``fused_pointwise._streams``).  Returns (z1, dz1, d2z1, cos p, sin p)."""
    d, nf = B.shape
    W0y, W0c, W0s = W0[:d], W0[d: d + nf], W0[d + nf:]
    p, dp = x @ B, v @ B
    cosp, sinp = torch.cos(p), torch.sin(p)
    dp2 = dp * dp
    z1 = x @ W0y + b0 + cosp @ W0c + sinp @ W0s
    dz1 = v @ W0y + (-sinp * dp) @ W0c + (cosp * dp) @ W0s
    d2z1 = (-cosp * dp2) @ W0c + (-sinp * dp2) @ W0s
    return z1, dz1, d2z1, cosp, sinp


def front_streams_bwd_plain(x, v, B, W0, g_z1, g_dz1, g_d2z1, g_cos, g_sin):
    """K10's plain version: the VJP of ``front_streams_plain`` for the
    cotangents of its five outputs, with p and dp recomputed, as K10 computes
    it.  Returns (B_bar [d, F], W0_bar [d + 2F, w0], b0_bar [w0])."""
    d, nf = B.shape
    W0c, W0s = W0[d: d + nf], W0[d + nf:]
    p, e = x @ B, v @ B
    c, s = torch.cos(p), torch.sin(p)
    ee = e * e
    W0_bar = torch.cat([x.T @ g_z1 + v.T @ g_dz1,
                        c.T @ g_z1 - (s * e).T @ g_dz1 - (c * ee).T @ g_d2z1,
                        s.T @ g_z1 + (c * e).T @ g_dz1 - (s * ee).T @ g_d2z1])
    # the streams' cotangents through the cos and sin rows: s_bar W^T
    zc, zs = g_z1 @ W0c.T, g_z1 @ W0s.T
    pc, ps = g_dz1 @ W0c.T, g_dz1 @ W0s.T
    qc, qs = g_d2z1 @ W0c.T, g_d2z1 @ W0s.T
    c_bar = zc + e * ps - ee * qc + g_cos
    s_bar = zs - e * pc - ee * qs + g_sin
    p_bar = -s * c_bar + c * s_bar
    e_bar = -s * pc + c * ps - 2.0 * e * (c * qc + s * qs)
    return x.T @ p_bar + v.T @ e_bar, W0_bar, torch.sum(g_z1, dim=0)


# -- kernels -----------------------------------------------------------------------


_vp, _ci = ctypes.c_void_p, ctypes.c_int
# K9's and K10's C entries (csrc/pointwise.cu): argument types, return type.
# Each starts device, d, F, w0; pointers and the stream are c_void_p.
FRONT_ENTRIES = {
    "k10_max_blocks": ([_ci] * 4 + [ctypes.POINTER(_ci)], _ci),
    "k9_front_streams": ([_ci] * 5 + [_vp, _ci, _vp, _ci] + [_vp] * 9, _ci),
    "k10_front_streams_bwd": ([_ci] * 6 + [_vp, _ci, _vp, _ci] + [_vp] * 11, _ci),
}


def _library() -> ctypes.CDLL:
    lib = build.load("pointwise")
    if lib.k3_mlp_grad_quad.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        common = [ci, ci, ci, ctypes.POINTER(ci), ci]  # device, act, n_mid, widths, n
        lib.k3_mlp_grad_quad.argtypes = common + [ci, ci] + [vp] * 8
        lib.k4_mlp_grad_quad_bwd.argtypes = common + [ci] * 4 + [vp] * 13
        lib.k3_shared_bytes_c.argtypes = [ci, ctypes.POINTER(ci), ci, ci]
        lib.k4_shared_bytes_c.argtypes = [ci, ctypes.POINTER(ci), ci, ci, ci]
        lib.k3_shared_bytes_c.restype = lib.k4_shared_bytes_c.restype = ctypes.c_longlong
        lib.k3_max_blocks.argtypes = lib.k4_max_blocks.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        for fn in (lib.k3_mlp_grad_quad, lib.k4_mlp_grad_quad_bwd, lib.k3_max_blocks, lib.k4_max_blocks):
            fn.restype = ci
        for name, (args, ret) in FRONT_ENTRIES.items():
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, ret
    return lib


class K3Plan(NamedTuple):
    """How K3 runs a chain: `widths` zero-padded to multiples of 8, `tile`
    points a block, the last layer's output features in chunks of `chunk`,
    `blocks_per_sm` blocks resident on an SM, `shared_bytes` a block."""

    widths: Tuple[int, ...]
    tile: int
    chunk: int
    blocks_per_sm: int
    shared_bytes: int


def k3_shared_bytes(widths: Sequence[int], tile: int, chunk: int) -> int:
    """K3's dynamic shared memory a block (csrc/pointwise.cu): rows of tile +
    4 floats -- the pre-activations of every layer's input, p and q of the
    widest input, its activated copy (h, hp, hq), one chunk of 2 z_L, and a
    row of quad partials for every four features of the chunk."""
    rows = sum(widths[:-1]) + 5 * max(widths[:-1]) + chunk + chunk // 4
    return 4 * rows * (tile + 4)


def k3_plan(widths: Sequence[int]) -> K3Plan:
    """K3's plan for the chain `widths` = [w0, the output widths of the
    layers after the first]: the largest tile of which two blocks fit an SM
    (the kernel's registers allow two), else the largest of which one does."""
    if not 2 <= len(widths) <= MAX_MID + 1 or min(widths) < 1:
        raise ValueError(f"K3 takes 1..{MAX_MID} layers of positive widths, got {list(widths)}")
    padded = tuple(-(-w // 8) * 8 for w in widths)
    chunk = min(K3_CHUNK, padded[-1])
    for blocks in (2, 1):
        for tile in K3_TILES:
            smem = k3_shared_bytes(padded, tile, chunk)
            if smem <= _MAX_SHARED_BYTES and blocks * (smem + 1024) <= _SM_SHARED_BYTES:
                return K3Plan(padded, tile, chunk, blocks, smem)
    raise ValueError(f"K3: widths {list(widths)} need more than {_MAX_SHARED_BYTES} B of shared "
                     f"memory per block at every tile")


class K4Plan(NamedTuple):
    """How K4 runs a chain: `widths` zero-padded to multiples of 8, `tile`
    points a tile, the last layer's output features in chunks of `chunk`,
    the block's weight-gradient sums in shared memory (`acc_shared`) or in
    its row of the partials in device memory, `shared_bytes` a block."""

    widths: Tuple[int, ...]
    tile: int
    chunk: int
    acc_shared: bool
    shared_bytes: int


def k4_shared_bytes(widths: Sequence[int], tile: int, chunk: int, acc_shared: bool) -> int:
    """K4's dynamic shared memory a block (csrc/pointwise.cu): four streams
    of rows of tile + 4 floats -- the saved inputs of every layer, one
    activated copy of the widest of them, one chunk of the last layer (at
    least as many rows as that layer has inputs: one of its streams holds
    their hr + g hq) -- then g_quad of the tile and, with `acc_shared`, one
    float a parameter."""
    rows = sum(widths[:-1]) + max(widths[:-1]) + max(chunk, widths[-2])
    n_params = sum(a * b + b for a, b in zip(widths, widths[1:]))
    return 4 * (4 * rows * (tile + 4) + tile + (n_params if acc_shared else 0))


def k4_plan(widths: Sequence[int]) -> K4Plan:
    """K4's plan for the chain `widths` = [w0, the output widths of the
    layers after the first]: the largest tile whose shared memory fits,
    with the weight-gradient sums in shared memory if they fit beside it.
    The last layer's inputs must be one pass of the block (a thread pair
    owns four points by four features): wide ones shrink the tile."""
    if not 2 <= len(widths) <= MAX_MID + 1 or min(widths) < 1:
        raise ValueError(f"K4 takes 1..{MAX_MID} layers of positive widths, got {list(widths)}")
    padded = tuple(-(-w // 8) * 8 for w in widths)
    chunk = min(K4_CHUNK, padded[-1])
    for tile in K4_TILES:
        if (tile // 4) * (padded[-2] // 4) > K4_THREADS // 2:
            continue
        for acc_shared in (True, False):
            smem = k4_shared_bytes(padded, tile, chunk, acc_shared)
            if smem <= _MAX_SHARED_BYTES:
                return K4Plan(padded, tile, chunk, acc_shared, smem)
    raise ValueError(f"K4: widths {list(widths)} need more than {_MAX_SHARED_BYTES} B of shared "
                     f"memory per block at every tile")


def pad_chain(mids: Mids, widths: Sequence[int], tensors):
    """The layers zero-padded to the chain `widths` and the [n, w0] tensors
    zero-padded to widths[0] columns.  A padded feature's outgoing weights
    are zero, so whatever its activation, it adds exactly 0.0 downstream."""
    padded = []
    for (W, b), w_in, w_out in zip(mids, widths, widths[1:]):
        Wp = W.new_zeros((w_in, w_out))
        Wp[: W.shape[0], : W.shape[1]] = W
        bp = b.new_zeros((w_out,))
        bp[: b.shape[0]] = b
        padded.append((Wp, bp))
    pad = widths[0] - tensors[0].shape[1]
    return padded, [torch.nn.functional.pad(t, (0, pad)) for t in tensors]


def unpad_grads(mids_bar, stream_bars, mids: Mids):
    """The gradients of the unpadded chain `mids` out of those of the chain
    ``pad_chain`` made of it: the padded entries dropped."""
    w0 = mids[0][0].shape[0]
    return ([(wb[: W.shape[0], : W.shape[1]], bb[: b.shape[0]]) for (wb, bb), (W, b) in zip(mids_bar, mids)],
            [t[:, :w0] for t in stream_bars])


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
    """(quad [n], delta [n, w0]).  CUDA tensors: the K3 kernel under
    ``k3_plan`` (a block a tile, nothing summed across points: two calls
    give bitwise-equal results); CPU tensors: ``mlp_grad_quad_plain``."""
    if z1.device.type == "cpu":
        return mlp_grad_quad_plain(mids, act_name, z1, dz1, d2z1)
    if z1.device.type != "cuda" or z1.ndim != 2:
        raise ValueError(f"K3 takes [n, w0] CUDA or CPU tensors, got {tuple(z1.shape)} on {z1.device}")
    widths, params, params_t = _check(mids, act_name, (z1, dz1, d2z1), "K3")
    n, w0 = z1.shape
    rows = [_rows(t, n, w0, "z1/dz1/d2z1") for t in (z1, dz1, d2z1)]
    plan = k3_plan(widths)
    if list(plan.widths) != widths:
        layers, rows = pad_chain(mids, plan.widths, rows)
        _, params, params_t = _check(layers, act_name, rows, "K3")
    z1, dz1, d2z1 = rows
    quad = torch.empty((n,), dtype=torch.float32, device=z1.device)
    delta = torch.empty((n, plan.widths[0]), dtype=torch.float32, device=z1.device)
    c_widths = (ctypes.c_int * len(plan.widths))(*plan.widths)
    err = _library().k3_mlp_grad_quad(
        device_index(z1),
        _ACTS[act_name], len(mids), c_widths, n, plan.tile, plan.chunk,
        z1.data_ptr(), dz1.data_ptr(), d2z1.data_ptr(), params.data_ptr(),
        params_t.data_ptr(), quad.data_ptr(), delta.data_ptr(),
        current_stream(device_index(z1)),
    )
    _raise(err, "K3")
    mlp_grad_quad.launches += 1
    if plan.widths[0] != w0:
        delta = delta[:, :w0].contiguous()
    return quad, delta


def mlp_grad_quad_bwd(mids: Mids, act_name: str, z1, dz1, d2z1, g_quad, g_delta):
    """([(Wbar, bbar)], z1bar, dz1bar, d2z1bar).  CUDA tensors: the K4
    kernel under ``k4_plan`` (a block sums its weight gradients over the
    tiles it walks and writes one row of partials, then a fixed-order
    reduction: two calls give bitwise-equal results); CPU tensors:
    ``mlp_grad_quad_bwd_plain``."""
    if z1.device.type == "cpu":
        return mlp_grad_quad_bwd_plain(mids, act_name, z1, dz1, d2z1, g_quad, g_delta)
    if z1.device.type != "cuda" or z1.ndim != 2:
        raise ValueError(f"K4 takes [n, w0] CUDA or CPU tensors, got {tuple(z1.shape)} on {z1.device}")
    widths, params, params_t = _check(mids, act_name, (z1, dz1, d2z1, g_quad, g_delta), "K4")
    n, w0 = z1.shape
    rows = [_rows(t, n, w0, "z1/dz1/d2z1/g_delta") for t in (z1, dz1, d2z1, g_delta)]
    if tuple(g_quad.shape) != (n,):
        raise ValueError(f"g_quad must be [{n}], got {tuple(g_quad.shape)}")
    g_quad = g_quad.contiguous()
    plan = k4_plan(widths)
    layers = mids
    if list(plan.widths) != widths:
        layers, rows = pad_chain(mids, plan.widths, rows)
        _, params, params_t = _check(layers, act_name, (*rows, g_quad), "K4")
    z1, dz1, d2z1, g_delta = rows
    device = device_index(z1)
    lib = _library()
    per_sm = ctypes.c_int(0)
    _raise(lib.k4_max_blocks(device, _ACTS[act_name], plan.shared_bytes, ctypes.byref(per_sm)),
           "K4 occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"K4: no block of {plan.shared_bytes} B of shared memory fits an SM")
    n_tiles = -(-n // plan.tile)
    n_sm = torch.cuda.get_device_properties(z1.device).multi_processor_count
    blocks = max(1, min(n_tiles, per_sm.value * n_sm))
    grads = torch.empty((params.numel(),), dtype=torch.float32, device=z1.device)
    partials = torch.empty((blocks, params.numel()), dtype=torch.float32, device=z1.device)
    outs = [torch.empty((n, plan.widths[0]), dtype=torch.float32, device=z1.device) for _ in range(3)]
    c_widths = (ctypes.c_int * len(plan.widths))(*plan.widths)
    err = lib.k4_mlp_grad_quad_bwd(
        device, _ACTS[act_name], len(mids), c_widths, n, blocks,
        plan.tile, plan.chunk, int(plan.acc_shared),
        z1.data_ptr(), dz1.data_ptr(), d2z1.data_ptr(), g_quad.data_ptr(), g_delta.data_ptr(),
        params.data_ptr(), params_t.data_ptr(), partials.data_ptr(), grads.data_ptr(),
        *(o.data_ptr() for o in outs),
        current_stream(device),
    )
    _raise(err, "K4")
    mlp_grad_quad_bwd.launches += 1
    mids_bar, off = [], 0
    for W, b in layers:
        wbar = grads[off: off + W.numel()].view(W.shape)
        off += W.numel()
        mids_bar.append((wbar, grads[off: off + b.numel()]))
        off += b.numel()
    if layers is not mids:
        mids_bar, outs = unpad_grads(mids_bar, outs, mids)
        outs = [o.contiguous() for o in outs]
    return mids_bar, outs[0], outs[1], outs[2]


mlp_grad_quad.launches = 0
mlp_grad_quad_bwd.launches = 0


def front_fits(d: int, nf: int, w0: int) -> bool:
    """Whether K9 and K10 take the front end of `d` inputs, `nf` Fourier
    features and a first layer of width `w0`: an instantiation has that
    shape (``FRONT_SHAPES``).  The provider keeps the plain streams
    elsewhere, and the counters then stay as they are."""
    return (d, nf, w0) in FRONT_SHAPES


def _front_check(x, v, B, W0, tensors, name: str):
    """(n, d, F, w0) of a front end the kernels take; raises otherwise."""
    if x.ndim != 2 or v.shape != x.shape or B.ndim != 2 or B.shape[0] != x.shape[1] or W0.ndim != 2:
        raise ValueError(f"{name}: x, v [n, d] and B [d, F], got {tuple(x.shape)}, {tuple(v.shape)}, "
                         f"{tuple(B.shape)}")
    (n, d), nf, w0 = x.shape, B.shape[1], W0.shape[1]
    if W0.shape[0] != d + 2 * nf:
        raise ValueError(f"{name}: W0 must be [{d + 2 * nf}, w0], got {tuple(W0.shape)}")
    for t in (x, v, B, W0, *tensors):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: every input must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if not front_fits(d, nf, w0):
        raise ValueError(f"{name}: no instantiation for d, F, w0 = {d}, {nf}, {w0} (FRONT_SHAPES {FRONT_SHAPES})")
    if not 1 <= n <= (2**31 - 1) // max(w0, nf):
        raise ValueError(f"{name}: need 1 <= n and n * {max(w0, nf)} < 2^31, got n = {n}")
    return n, d, nf, w0


def _unit_rows(t: torch.Tensor):
    """`t` [n, d] with unit column stride, and its row stride (the x and v
    halves of a [n, 2d] batch pass as they are)."""
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        t = t.contiguous()
    return t, t.stride(0)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous, at an address the kernels' float4 loads take."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def front_streams(x, v, B, W0, b0):
    """(z1, dz1, d2z1 [n, w0], cos p, sin p [n, F]).  CUDA tensors: the K9
    kernel (a block a tile of 32 points, nothing summed across points: two
    calls give bitwise-equal results); CPU tensors: ``front_streams_plain``."""
    if x.device.type == "cpu":
        return front_streams_plain(x, v, B, W0, b0)
    n, d, nf, w0 = _front_check(x, v, B, W0, (b0,), "K9")
    if tuple(b0.shape) != (w0,):
        raise ValueError(f"K9: b0 must be [{w0}], got {tuple(b0.shape)}")
    (x, ldx), (v, ldv) = _unit_rows(x), _unit_rows(v)
    B, W, b0 = B.contiguous(), _aligned(W0), b0.contiguous()
    outs = [torch.empty((n, w), dtype=torch.float32, device=x.device) for w in (w0, w0, w0, nf, nf)]
    device = device_index(x)
    err = _library().k9_front_streams(
        device, d, nf, w0, n, x.data_ptr(), ldx, v.data_ptr(), ldv, B.data_ptr(), W.data_ptr(),
        b0.data_ptr(), *(o.data_ptr() for o in outs), current_stream(device))
    _raise(err, "K9")
    front_streams.launches += 1
    return tuple(outs)


@functools.lru_cache(maxsize=None)
def _k10_grid(device: int, d: int, nf: int, w0: int) -> int:
    """K10's blocks: as many as are resident on the card at once."""
    per_sm = ctypes.c_int(0)
    _raise(_library().k10_max_blocks(device, d, nf, w0, ctypes.byref(per_sm)), "K10 occupancy query")
    if per_sm.value < 1:
        raise RuntimeError("K10: no block fits an SM")
    return per_sm.value * torch.cuda.get_device_properties(device).multi_processor_count


def front_streams_bwd(x, v, B, W0, g_z1, g_dz1, g_d2z1, g_cos, g_sin):
    """(B_bar [d, F], W0_bar [d + 2F, w0], b0_bar [w0]).  CUDA tensors: the
    K10 kernel (persistent blocks each sum their tiles into a row of
    partials, and the last block to finish adds the rows in block order:
    two calls give bitwise-equal results); CPU tensors:
    ``front_streams_bwd_plain``."""
    if x.device.type == "cpu":
        return front_streams_bwd_plain(x, v, B, W0, g_z1, g_dz1, g_d2z1, g_cos, g_sin)
    bars = (g_z1, g_dz1, g_d2z1, g_cos, g_sin)
    n, d, nf, w0 = _front_check(x, v, B, W0, bars, "K10")
    g_z1, g_dz1, g_d2z1 = (_rows(t, n, w0, "the streams' cotangents") for t in bars[:3])
    g_cos, g_sin = (_aligned(_rows(t, n, nf, "the cotangents of cos p and sin p")) for t in bars[3:])
    (x, ldx), (v, ldv) = _unit_rows(x), _unit_rows(v)
    B, Wt = B.contiguous(), _aligned(W0.t())
    device = device_index(x)
    blocks = min(-(-n // FRONT_TILE), _k10_grid(device, d, nf, w0))
    rows = d + 2 * nf
    n_params = rows * w0 + w0 + d * nf
    # the blocks' rows of partials, then the ticket that finds the last block
    scratch = torch.empty((blocks * n_params + 1,), dtype=torch.float32, device=x.device)
    grads = torch.empty((n_params,), dtype=torch.float32, device=x.device)
    err = _library().k10_front_streams_bwd(
        device, d, nf, w0, n, blocks, x.data_ptr(), ldx, v.data_ptr(), ldv, B.data_ptr(), Wt.data_ptr(),
        g_z1.data_ptr(), g_dz1.data_ptr(), g_d2z1.data_ptr(), g_cos.data_ptr(), g_sin.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * blocks * n_params, grads.data_ptr(), current_stream(device))
    _raise(err, "K10")
    front_streams_bwd.launches += 1
    n_w = rows * w0
    return grads[n_w + w0:].view(d, nf), grads[:n_w].view(rows, w0), grads[n_w: n_w + w0]


front_streams.launches = 0
front_streams_bwd.launches = 0
