"""K5-K8: the pairwise mean-field kernels (``csrc/pairwise.cu``) and their
plain PyTorch versions.

Layouts are the JAX package's: ax, av [nt, n, w0] are the first-layer
projections of the points and velocities (ax includes the bias), ar
[nt, m, w0] those of the refs, mask [m] the refs' weights.  For each stamp
t and point i the pair with ref j has first-layer preactivation
z0 = ax[t, i] - ar[t, j] and tangent av[t, i]; every function returns the
masked sums over j

    value [nt, n]      = sum_j mask_j Phi
    hess  [nt, n]      = sum_j mask_j v^T Hess Phi v
    s_dz0 [nt, n, w0]  = sum_j mask_j dPhi/dz0

or their VJP.  Counterparts:

* ``mlp_pairwise_sums`` (K5) and ``mlp_pairwise_sums_bwd`` (K6):
  ``pde_inverse_tpu/ops/pallas/pairwise_kernel.py``, the layers after the
  first (``mids``: [(W [w_in, w_out], b)], the feature layer last) and
  Phi = |f_L|^2; K5 runs k5_kernel (K7's thread per point, the feature
  layer streamed in chunks of 4) or pw_fwd_kernel, K6 k6_kernel (K8's lane
  quads at widths <= 32, lane octets at 48 and 64, the feature layer
  streamed in chunks) or pw_bwd_kernel, as ``choose`` gives;
* ``mlp_pairwise_sums_packed`` (K7) and ``mlp_pairwise_sums_packed_bwd``
  (K8): ``pairwise_packed.py``, the hidden layers before the feature layer
  (``mids_m``) and the collapsed head Phi = g.(M g) + u.g with g the last
  hidden activation, M = W_F W_F^T and u = 2 W_F b_F; value excludes
  c = |b_F|^2 and M is assumed symmetric.

S1, the checks of the constructs these kernels run
(``pde_inverse_torch/scripts/diag_packed_onchip.py``), has its wrappers at the
end: ``s1_pair_rows``, ``s1_m_layer``, ``sum_rows`` (the fixed-order row sum
that finishes K5-K8's partial rows, in the chunk order of
``row_chunks.sum_rows_plan``; S2's ``sum`` mode too) and
``s1_packed_sums``/``s1_packed_sums_bwd`` (K7/K8 with the refs unsplit).

``choose`` holds the width rules that pick K5/K6's kernels and the route
to K7/K8; ``plan`` fits any of the six kernels (``KERNELS``) to a chain,
and ``_launch_fwd``/``_launch_bwd`` launch any plan.  For a CUDA tensor
each wrapper launches its kernel on the current stream and raises if the
build or the launch fails; for a CPU tensor it runs its plain version.
``<wrapper>.launches`` counts kernel launches (CPU calls do not count).  The plain versions process the refs in chunks of at most
``ROWS_PER_CHUNK`` pairs, so they also run at the full main-path width.
All arithmetic is float32.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from pde_inverse_torch.ops.activations import ACT_D012, ACT_D0123, supported_activation
from pde_inverse_torch.ops.cuda import build, current_stream, device_index
from pde_inverse_torch.ops.cuda.row_chunks import SumRowsPlan, chunked_sum, sum_rows_plan

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]

ROWS_PER_CHUNK = 1 << 20  # pairs per chunk of the plain versions
MAX_MID = 16  # layers after the first that the kernels take
_ACTS = {"tanh": 0, "silu": 1, "softplus": 2}
_TILE = 32  # points per tile, csrc/pairwise.cu kTile
_TILE_THREADS = 256  # threads a block of the tile kernels, csrc/pairwise.cu kThreads
_ROW = _TILE + 4  # floats per feature row of a tile in shared memory
_MAX_SHARED_BYTES = 227 * 1024  # a block's opt-in maximum on Hopper
_WAVES = 4  # aim for this many waves of resident blocks when splitting the refs
K7_WIDTHS = (8, 16, 20, 24, 32)  # k7_kernel's width instantiations
K7_THREADS = (128, 64, 32)  # points per K7 block: the most whose shared memory fits
K8_THREADS = (256, 192, 128, 96, 64, 32)  # lanes per K8 block (4 a point), likewise
K6_THREADS = (256, 224, 192, 160, 128, 96, 64, 32)  # lanes per k6_kernel block, likewise
K6_WIDTHS = K7_WIDTHS + (48, 64)  # k6_kernel's width instantiations: 4 lanes a pair, 8 at 48 and 64
K5_CHUNK = 4  # features of the feature layer a k5_kernel chunk (csrc/pairwise.cu kK5Chunk)


# -- plain versions ----------------------------------------------------------------


def _chunks(ar: torch.Tensor, n: int, rows: int):
    """(j0, j1) ref ranges of at most `rows` pairs (at least one ref each)."""
    nt, m = ar.shape[0], ar.shape[1]
    c = max(1, min(m, rows // max(1, nt * n)))
    return [(j0, min(m, j0 + c)) for j0 in range(0, m, c)]


def _pair_rows(ax, av, ar_c):
    """Flat pair rows ordered (t, j, i): z0 = ax_i - ar_j and dz0 = av_i."""
    nt, n, w0 = ax.shape
    c = ar_c.shape[1]
    z = (ax[:, None] - ar_c[:, :, None]).reshape(-1, w0)
    dz = av[:, None].expand(nt, c, n, w0).reshape(-1, w0)
    return z, dz


def _per_row(x, nt: int, c: int, n: int):
    """A per-point [nt, n] or per-ref [c] scalar as a [rows, 1] column."""
    if x.ndim == 1:
        return x[None, :, None].expand(nt, c, n).reshape(-1, 1)
    return x[:, None, :].expand(nt, c, n).reshape(-1, 1)


def _fwd_rows(layers: Layers, act_name: str, z, dz, head=None):
    """(Phi, vHv, dPhi/dz0) per pair row.  head None: Phi = |z_L|^2 after
    `layers`; head (M, u): Phi = g.(M g) + u.g with g = act(z_L)."""
    act = ACT_D012[act_name]
    d2z = torch.zeros_like(z)
    preacts = []
    for W, b in layers:
        preacts.append(z)
        a, d1, d2 = act(z)
        z, dz, d2z = a @ W + b, (d1 * dz) @ W, (d2 * dz * dz + d1 * d2z) @ W
    if head is None:
        val = torch.sum(z * z, dim=-1)
        hess = 2.0 * torch.sum(dz * dz + z * d2z, dim=-1)
        delta = 2.0 * z
    else:
        M, u = head
        g, d1, d2 = act(z)
        gp, gq = d1 * dz, d2 * dz * dz + d1 * d2z
        Mg = g @ M
        two = 2.0 * Mg + u
        val = torch.sum(g * (Mg + u), dim=-1)
        hess = torch.sum(2.0 * gp * (gp @ M) + gq * two, dim=-1)
        delta = two * d1
    for (W, _), zk in zip(reversed(layers), reversed(preacts)):
        delta = (delta @ W.T) * act(zk)[1]
    return val, hess, delta


def _sums(layers, act_name, ax, av, ar, mask, head, rows):
    nt, n, w0 = ax.shape
    value = torch.zeros((nt, n), dtype=ax.dtype, device=ax.device)
    hess = torch.zeros_like(value)
    s_dz0 = torch.zeros_like(ax)
    for j0, j1 in _chunks(ar, n, rows):
        c = j1 - j0
        z, dz = _pair_rows(ax, av, ar[:, j0:j1])
        val, hs, delta = _fwd_rows(layers, act_name, z, dz, head)
        mk = mask[j0:j1].to(ax.dtype)[None, :, None]
        value = value + torch.sum(val.reshape(nt, c, n) * mk, dim=1)
        hess = hess + torch.sum(hs.reshape(nt, c, n) * mk, dim=1)
        s_dz0 = s_dz0 + torch.sum(delta.reshape(nt, c, n, w0) * mk[..., None], dim=1)
    return {"value": value, "hess": hess, "s_dz0": s_dz0}


def mlp_pairwise_sums_plain(mids: Layers, act_name: str, ax, av, ar, mask, rows=ROWS_PER_CHUNK):
    """K5's plain version (the JAX package's ``_tile_stats`` sums)."""
    return _sums(mids, act_name, ax, av, ar, mask, None, rows)


def mlp_pairwise_sums_packed_plain(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask,
                                   rows=ROWS_PER_CHUNK):
    """K7's plain version: the collapsed-head sums, value without c."""
    return _sums(mids_m, act_name, ax, av, ar, mask, (M, u), rows)


def _forward4(layers: Layers, act3, z, p, r):
    """Four streams (z, p = d_v z, q = d_v^2 z, r = d_g z) through `layers`,
    saving every layer's inputs."""
    q = torch.zeros_like(z)
    saved = []
    for W, b in layers:
        saved.append((z, p, q, r))
        a0, a1, a2, _ = act3(z)
        z, p, q, r = a0 @ W + b, (a1 * p) @ W, (a2 * p * p + a1 * q) @ W, (a1 * r) @ W
    return (z, p, q, r), saved


def _reverse4(layers: Layers, act3, saved, bars):
    """One reverse sweep over the 4-stream formulation from the output
    cotangents `bars`; returns ([(Wbar, bbar)], z0bar, p0bar)."""
    zbar, pbar, qbar, rbar = bars
    grads: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for (W, _), (zk, pk, qk, rk) in zip(reversed(layers), reversed(saved)):
        a0, a1, a2, a3 = act3(zk)
        h, hp, hq, hr = a0, a1 * pk, a2 * pk * pk + a1 * qk, a1 * rk
        grads.append((h.T @ zbar + hp.T @ pbar + hq.T @ qbar + hr.T @ rbar, torch.sum(zbar, dim=0)))
        hb, hpb, hqb, hrb = zbar @ W.T, pbar @ W.T, qbar @ W.T, rbar @ W.T
        zbar = hb * a1 + hpb * (a2 * pk) + hrb * (a2 * rk) + hqb * (a3 * pk * pk + a2 * qk)
        pbar = hpb * a1 + hqb * (2.0 * a2 * pk)
        qbar, rbar = hqb * a1, hrb * a1
    return grads[::-1], zbar, pbar


def _sums_bwd(layers, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0, head, rows):
    """VJP of the sums with respect to (layers, [M, u], ax, av, ar), as the
    kernels compute it: S = mask (g_val Phi + g_hess vHv + <g_dz0, dPhi/dz0>)
    per pair, a 4-stream forward pass with r0 = g_dz0, one reverse sweep."""
    act3 = ACT_D0123[act_name]
    nt, n, w0 = ax.shape
    layer_bars = [(torch.zeros_like(W), torch.zeros_like(b)) for W, b in layers]
    ax_bar, av_bar = torch.zeros_like(ax), torch.zeros_like(av)
    ar_bar = torch.zeros_like(ar)
    if head is not None:
        M, u = head
        M_bar, u_bar = torch.zeros_like(M), torch.zeros_like(u)
    for j0, j1 in _chunks(ar, n, rows):
        c = j1 - j0
        z0, p0 = _pair_rows(ax, av, ar[:, j0:j1])
        r0 = g_dz0[:, None].expand(nt, c, n, w0).reshape(-1, w0)
        mk = _per_row(mask[j0:j1].to(ax.dtype), nt, c, n)
        gv = mk * _per_row(g_val, nt, c, n)
        gh = mk * _per_row(g_hess, nt, c, n)
        (z, p, q, r), saved = _forward4(layers, act3, z0, p0, r0)
        if head is None:
            bars = (2.0 * gv * z + 2.0 * gh * q + 2.0 * mk * r, 4.0 * gh * p, 2.0 * gh * z, 2.0 * mk * z)
        else:
            a0, a1, a2, a3 = act3(z)
            g, gp, gq, gs = a0, a1 * p, a2 * p * p + a1 * q, a1 * r
            Mg, Mgp, Mgq, Mgr = g @ M, gp @ M, gq @ M, gs @ M
            two = 2.0 * Mg + u
            gbar = gv * two + 2.0 * gh * Mgq + 2.0 * mk * Mgr
            gpbar, gqbar, gsbar = 4.0 * gh * Mgp, gh * two, mk * two
            L1 = gv * g + 2.0 * gh * gq + 2.0 * mk * gs
            M_bar = M_bar + L1.T @ g + (2.0 * gh * gp).T @ gp
            u_bar = u_bar + torch.sum(gv * g + gh * gq + mk * gs, dim=0)
            bars = (
                gbar * a1 + gpbar * (a2 * p) + gqbar * (a3 * p * p + a2 * q) + gsbar * (a2 * r),
                gpbar * a1 + gqbar * (2.0 * a2 * p),
                gqbar * a1,
                gsbar * a1,
            )
        grads, z0bar, p0bar = _reverse4(layers, act3, saved, bars)
        layer_bars = [(Wb + gW, bb + gb) for (Wb, bb), (gW, gb) in zip(layer_bars, grads)]
        z0bar = z0bar.reshape(nt, c, n, w0)
        ax_bar = ax_bar + torch.sum(z0bar, dim=1)
        av_bar = av_bar + torch.sum(p0bar.reshape(nt, c, n, w0), dim=1)
        ar_bar[:, j0:j1] = -torch.sum(z0bar, dim=2)
    if head is None:
        return layer_bars, ax_bar, av_bar, ar_bar
    return layer_bars, M_bar, u_bar, ax_bar, av_bar, ar_bar


def mlp_pairwise_sums_bwd_plain(mids: Layers, act_name: str, ax, av, ar, mask, g_val, g_hess, g_dz0,
                                rows=ROWS_PER_CHUNK):
    """K6's plain version: ([(Wbar, bbar)], ax_bar, av_bar, ar_bar)."""
    return _sums_bwd(mids, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0, None, rows)


def mlp_pairwise_sums_packed_bwd_plain(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask,
                                       g_val, g_hess, g_dz0, rows=ROWS_PER_CHUNK):
    """K8's plain version: ([(Wbar, bbar)], M_bar, u_bar, ax_bar, av_bar,
    ar_bar); M_bar is the VJP of the symmetric composition (the JAX
    kernel's)."""
    return _sums_bwd(mids_m, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0, (M, u), rows)


# -- kernels -----------------------------------------------------------------------


_CI, _LL, _VP = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_PLAN = [_CI] * 3 + [ctypes.POINTER(_CI), _CI]  # width, threads, n_mid, widths, n_chunks
_LAUNCH = [_CI] * 3 + _PLAN + [_CI] * 4  # device, kernel, act, the plan, nt, n, m, n_split
# (argtypes, restype) of csrc/pairwise.cu's entry points
ENTRIES = {
    "pw_max_blocks": ([_CI] * 3 + _PLAN + [ctypes.POINTER(_CI)], _CI),
    "pw_shared_bytes": ([_CI] + _PLAN, _LL),
    "pw_forward": (_LAUNCH + [_VP] * 9, _CI),
    "pw_backward": (_LAUNCH + [_VP] * 16, _CI),
    "s1_pair_rows": ([_CI] * 4 + [_VP] * 6, _CI),
    "s1_m_layer": ([_CI] * 3 + [_VP] * 4, _CI),
    "sum_rows_plan_c": ([_LL, _LL, _CI, ctypes.POINTER(_LL)], None),
    "pw_sum_rows": ([_CI, _VP, _VP, _CI, _LL, _VP], _CI),
    "pw_sum_rows_launches": ([], _LL),
}


def _library() -> ctypes.CDLL:
    lib = build.load("pairwise")
    if lib.pw_forward.argtypes is None:
        for name, (argtypes, restype) in ENTRIES.items():
            getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
    return lib


def shared_bytes(widths: Sequence[int], n_streams: int) -> int:
    """Dynamic shared memory of one block: every layer's streams of a tile,
    the activated copy of the widest layer input, the cached tile inputs and
    the block's accumulators."""
    rows = sum(widths)
    tmp_rows = -(-max(widths[:-1]) // 4) * 4
    return (n_streams * (rows + tmp_rows) + 5 * widths[0] + 4) * _ROW * 4


def k7_shared_bytes(width: int, threads: int, n_layers: int) -> int:
    """K7's shared memory a block (csrc/pairwise.cu): the padded weights,
    n_layers x (W_k, b_k) then M and u, and for each of the block's points
    act'(z_k) of every hidden layer and the s_dz0 sums, in rows of width
    floats (width + 4 where width is a multiple of 8)."""
    weights = n_layers * (width * width + width) + width * width + width
    row = width + 4 if width % 8 == 0 else width
    return 4 * (weights + (n_layers + 1) * threads * row)


def k8_rows(n_layers: int) -> int:
    """Row sets of a K8 block in shared memory: the saved inputs of the
    layers 1 .. n_layers - 1, the set H and the set S."""
    return max(n_layers, 1) + 1


def k8_scratch_floats(width: int, threads: int) -> int:
    """Floats of a K8 block's scratch for its warps' weight gradients of a
    layer: two buffers of one layer's (width^2 + width) a warp; none for a
    block of one warp, which adds its sums to the accumulators itself."""
    return 2 * (threads // 32) * (width * width + width) if threads > 32 else 0


def k8_shared_bytes(width: int, threads: int, n_layers: int) -> int:
    """K8's shared memory a block (csrc/pairwise.cu): the padded weights as
    K7's, as many gradient accumulators, ``k8_rows`` row sets of four rows
    (width floats, width + 4 where width is a multiple of 8) and 4 floats
    of padding a pair, the scratch (``k8_scratch_floats``) and one ref-row
    partial a warp."""
    weights = n_layers * (width * width + width) + width * width + width
    row = width + 4 if width % 8 == 0 else width
    return 4 * (2 * weights + k8_rows(n_layers) * (threads // 4) * (4 * row + 4)
                + k8_scratch_floats(width, threads) + threads // 32 * width)


def k6_rows(n_layers: int) -> int:
    """Row sets of a k6_kernel block in shared memory: the saved inputs of
    the layers 1 .. n_layers - 1, the set H and the two sets S."""
    return max(n_layers, 1) + 2


def k6_lanes(width: int) -> int:
    """Lanes a pair of k6_kernel at an instantiated width: four (K8's
    quads) up to 32, eight at 48 and 64 (csrc/pairwise.cu k8_lanes)."""
    return 8 if width > 32 else 4


def k6_shared_bytes(width: int, threads: int, n_layers: int, chunks: int) -> int:
    """k6_kernel's shared memory a block (csrc/pairwise.cu): the padded
    weights, n_layers x (W_k, b_k) then `chunks` x (a [width, width] block
    of W_F, its biases), as many gradient accumulators, ``k6_rows`` row
    sets (a pair's four rows of width floats, width + 4 where width is
    a multiple of 8, and 4 floats of padding, 8 at eight lanes a pair) and
    one ref-row partial a warp."""
    weights = (n_layers + chunks) * (width * width + width)
    row = width + 4 if width % 8 == 0 else width
    lanes = k6_lanes(width)
    pair = 4 * row + (4 if lanes == 4 else 8)
    return 4 * (2 * weights + k6_rows(n_layers) * (threads // lanes) * pair + threads // 32 * width)


def k5_shared_bytes(width: int, threads: int, n_layers: int, chunks: int) -> int:
    """k5_kernel's shared memory a block (csrc/pairwise.cu): the padded
    weights, n_layers x (W_k, b_k) then W_F [width, F4] and b_F [F4] (F4 =
    K5_CHUNK x chunks), and K7's rows of act' and of the s_dz0 sums."""
    weights = n_layers * (width * width + width) + (width + 1) * K5_CHUNK * chunks
    row = width + 4 if width % 8 == 0 else width
    return 4 * (weights + (n_layers + 1) * threads * row)


class Plan(NamedTuple):
    """How one kernel runs a chain: `kernel` (a key of ``KERNELS``), the
    instantiated `width` that every layer before the feature layer (K7/K8:
    every layer, M included) is zero-padded to (0 for the tile kernels,
    which take the chain unpadded), `threads` a block, the feature layer's
    `chunks` (k5_kernel: of K5_CHUNK features; k6_kernel: of `width`
    features; 0 for the others), `shared_bytes` of dynamic shared memory a
    block and `points` (pairs at one ref) a block."""

    kernel: str
    width: int
    threads: int
    chunks: int
    shared_bytes: int
    points: int


class _Kernel(NamedTuple):
    widths: Tuple[int, ...]  # width instantiations, least first; none for a tile kernel
    threads: Tuple[int, ...]  # threads a block to try, most first
    points: Callable[[int, int], int]  # points a block at (width, threads)
    chunk: Optional[Callable[[int], int]]  # features a chunk of the feature layer at width; None: no chunks
    shared: Callable[[List[int], int, int, int], int]  # shared memory a block at (widths, width, threads, chunks)


# The kernels of csrc/pairwise.cu, in the order of its KernelId.  k5_kernel
# and k7_kernel run a thread a point, k8_kernel four lanes and k6_kernel
# ``k6_lanes``; the tile kernels pw_fwd_kernel and pw_bwd_kernel run 256
# threads on a tile of _TILE points and split the refs by the _WAVES policy
# (``ref_splits``), the other four by ``k7_splits``.
KERNELS = {
    "k5": _Kernel(K7_WIDTHS, K7_THREADS, lambda w, t: t, lambda w: K5_CHUNK,
                  lambda ws, w, t, c: k5_shared_bytes(w, t, len(ws) - 2, c)),
    "pw_fwd": _Kernel((), (_TILE_THREADS,), lambda w, t: _TILE, None, lambda ws, w, t, c: shared_bytes(ws, 3)),
    "k6": _Kernel(K6_WIDTHS, K6_THREADS, lambda w, t: t // k6_lanes(w), lambda w: w,
                  lambda ws, w, t, c: k6_shared_bytes(w, t, len(ws) - 2, c)),
    "pw_bwd": _Kernel((), (_TILE_THREADS,), lambda w, t: _TILE, None, lambda ws, w, t, c: shared_bytes(ws, 4)),
    "k7": _Kernel(K7_WIDTHS, K7_THREADS, lambda w, t: t, None,
                  lambda ws, w, t, c: k7_shared_bytes(w, t, len(ws) - 2)),
    "k8": _Kernel(K7_WIDTHS, K8_THREADS, lambda w, t: t // 4, None,
                  lambda ws, w, t, c: k8_shared_bytes(w, t, len(ws) - 2)),
}
_KERNEL_IDS = {name: i for i, name in enumerate(KERNELS)}


def _fit(kernel: str, widths: Sequence[int]) -> Optional[Plan]:
    """``plan``, or None where no block's shared memory fits."""
    spec, widths = KERNELS[kernel], list(widths)
    if len(widths) < 2 or min(widths) < 1:
        raise ValueError(f"{kernel}: widths {widths} are not a chain ending with the head's width")
    width = 0
    if spec.widths:
        held = max(widths if spec.chunk is None else widths[:-1])
        width = next((w for w in spec.widths if w >= held), None)
        if width is None:
            where = "" if spec.chunk is None else " before the feature layer"
            raise ValueError(f"{kernel} takes widths <= {spec.widths[-1]}{where}, got {widths}")
    chunks = 0 if spec.chunk is None else -(-widths[-1] // spec.chunk(width))
    for threads in spec.threads:
        smem = spec.shared(widths, width, threads, chunks)
        if smem <= _MAX_SHARED_BYTES:
            return Plan(kernel, width, threads, chunks, smem, spec.points(width, threads))
    return None


def plan(kernel: str, widths: Sequence[int]) -> Plan:
    """`kernel`'s plan for the chain `widths` (k5, k6 and the tile kernels:
    [w0, the hidden layers' output widths..., the feature width]; k7 and
    k8: [w0, the hidden layers' output widths..., M's width]): the least
    instantiated width that holds every width before the feature layer
    (k7/k8: every width), the feature layer in chunks, and the most threads
    a block, of the kernel's candidates, whose shared memory fits; raises
    where none does."""
    fit = _fit(kernel, widths)
    if fit is None:
        raise ValueError(f"{kernel}: widths {list(widths)} need more than {_MAX_SHARED_BYTES} B of shared memory "
                         f"a block")
    return fit


def choose(widths: Sequence[int], mode: str = "auto") -> Tuple[str, str]:
    """The kernels (forward, backward) that run the square-head chain
    `widths` = [w0, the hidden layers' output widths..., the feature width]
    under solver.train.kmv_pallas `mode` ("auto", "packed", "on" or "fwd",
    whose forward is "on"'s); the one place that knows the width rules:

    * every width before the feature layer <= 32: k7/k8 on the collapsed
      head under "auto" and "packed", k5/k6 under "on" and "fwd";
    * else up to 64 where k6_kernel's plan on eight lanes a pair fits:
      pw_fwd/k6;
    * else pw_fwd/pw_bwd.  pw_bwd_kernel's tile holds some deep chains at
      33-64 that the octets, which pad every layer to the widest, do not
      (e.g. [1] + [56] x 6 + [8]).

    "packed" past 32 gives what "auto" gives: the loss layer refuses it."""
    if mode not in ("auto", "packed", "on", "fwd"):
        raise ValueError(f"no kernels for mode {mode!r}")
    widths = list(widths)
    if len(widths) < 2 or min(widths) < 1:
        raise ValueError(f"widths {widths} are not a chain ending with the feature width")
    hidden = max(widths[:-1])
    if hidden <= K7_WIDTHS[-1]:
        return ("k7", "k8") if mode in ("auto", "packed") else ("k5", "k6")
    if hidden <= K6_WIDTHS[-1] and _fit("k6", widths) is not None:
        return "pw_fwd", "k6"
    return "pw_fwd", "pw_bwd"


def pack_square(layers: Layers, width: int) -> torch.Tensor:
    """Layers padded to `width` (hidden [width, width], the feature layer
    [width, chunks x width]) as k6_kernel's flat weights: every hidden
    (W_k, b_k), then for each chunk of `width` features its [width, width]
    block of W_F and its biases."""
    *hidden, (WF, bF) = layers
    chunks = WF.shape[1] // width
    feature = torch.cat([WF.reshape(width, chunks, width).transpose(0, 1).reshape(chunks, -1),
                         bF.reshape(chunks, width)], dim=1)
    return torch.cat([x.reshape(-1) for W, b in hidden for x in (W, b)] + [feature.reshape(-1)])


def _pad_chain(mids: Layers, width: int, f_pad: int):
    """The square-head chain `mids` zero-padded: the hidden layers to [width,
    width] and [width], the feature layer to [width, f_pad] and [f_pad]."""
    padded = []
    for k, (W, b) in enumerate(mids):
        cols = width if k < len(mids) - 1 else f_pad
        Wp = W.new_zeros((width, cols))
        Wp[: W.shape[0], : W.shape[1]] = W
        bp = b.new_zeros(cols)
        bp[: b.shape[0]] = b
        padded.append((Wp, bp))
    return padded


def pad_square(mids: Layers, width: int):
    """The square-head chain `mids` zero-padded for k6_kernel: (flat weights
    of ``pack_square``, the padded layers [(W_k [width, width], b_k), (W_F
    [width, chunks x width], b_F)])."""
    padded = _pad_chain(mids, width, -(-mids[-1][0].shape[1] // width) * width)
    return pack_square(padded, width), padded


def unpad_square(flat: torch.Tensor, mids: Layers, width: int):
    """The gradients of the unpadded chain `mids` out of flat weights in the
    layout of ``pack_square``: [(Wbar, bbar)], the padded entries dropped."""
    *hidden, (WF, _) = mids
    lw = width * width + width
    out = []
    for k, (W, b) in enumerate(hidden):
        layer = flat[k * lw: (k + 1) * lw]
        out.append((layer[: width * width].view(width, width)[: W.shape[0], : W.shape[1]],
                    layer[width * width:][: b.shape[0]]))
    feature = flat[len(hidden) * lw:].view(-1, lw)
    chunks = feature.shape[0]
    WF_bar = feature[:, : width * width].reshape(chunks, width, width).transpose(0, 1).reshape(width, -1)
    out.append((WF_bar[: WF.shape[0], : WF.shape[1]], feature[:, width * width:].reshape(-1)[: WF.shape[1]]))
    return out


def pad_k5(mids: Layers, width: int):
    """The square-head chain `mids` zero-padded for k5_kernel: (flat weights,
    every hidden (W_k [width, width], b_k) then W_F [width, F4] row-major and
    b_F [F4], F4 the feature width rounded up to K5_CHUNK; the padded
    layers)."""
    padded = _pad_chain(mids, width, -(-mids[-1][0].shape[1] // K5_CHUNK) * K5_CHUNK)
    return torch.cat([x.reshape(-1) for W, b in padded for x in (W, b)]), padded


def k7_splits(nt: int, n: int, m: int, threads: int, resident: int) -> int:
    """Ref splits of K7: the fewest that minimise the wave-rounded work,
    ceil(splits x blocks / resident) x ceil(m / splits), where blocks =
    nt x ceil(n / threads) point blocks and `resident` blocks run at once;
    at most one split per ref and about 2 x _WAVES waves."""
    blocks = nt * -(-n // threads)
    best, best_cost = 1, None
    for splits in range(1, max(1, min(m, -(-2 * _WAVES * resident // blocks))) + 1):
        cost = -(-splits * blocks // resident) * -(-m // splits)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
    return best


def ref_splits(plan: Plan, act_name: str, widths: Sequence[int], nt: int, n: int, m: int, device: int) -> int:
    """Ref splits of a launch of `plan` on the chain `widths` on the card
    `device`, from the blocks an SM holds (one occupancy query): for the
    tile kernels enough blocks for about _WAVES waves of resident blocks,
    at most one split per ref; for the others ``k7_splits`` over the plan's
    points a block."""
    per_sm = ctypes.c_int(0)
    _raise(_library().pw_max_blocks(device, _KERNEL_IDS[plan.kernel], _ACTS[act_name], plan.width, plan.threads,
                                    len(widths) - 1, (ctypes.c_int * len(widths))(*widths), plan.chunks,
                                    ctypes.byref(per_sm)), f"{plan.kernel} occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"{plan.kernel}: no block fits on an SM at widths {list(widths)}")
    resident = per_sm.value * torch.cuda.get_device_properties(device).multi_processor_count
    if not KERNELS[plan.kernel].widths:
        return max(1, min(m, -(-_WAVES * resident // (nt * -(-n // plan.points)))))
    return k7_splits(nt, n, m, plan.points, resident)


def pad_collapsed(mids_m: Layers, M, u, width: int):
    """The hidden layers, M and u zero-padded to `width`, as views into one
    flat buffer in K7's weight layout: (flat, [(W_k [width, width],
    b_k [width])], M [width, width], u [width])."""
    pieces = [x for W, b in mids_m for x in (W, b)] + [M, u]
    flat = torch.zeros(sum(width ** t.ndim for t in pieces), dtype=M.dtype, device=M.device)
    views, off = [], 0
    for t in pieces:
        view = flat[off: off + width ** t.ndim].view((width,) * t.ndim)
        view[tuple(slice(0, k) for k in t.shape)] = t
        views.append(view)
        off += width ** t.ndim
    return flat, list(zip(views[:-2:2], views[1:-2:2])), views[-2], views[-1]


def unpad_collapsed(flat, mids_m: Layers, M, width: int):
    """The gradients of the unpadded chain out of a flat buffer in the
    layout of ``pad_collapsed`` at `width`: ([(Wbar, bbar)], M_bar, u_bar),
    the padded entries dropped."""
    out, off = [], 0
    for t in [x for W, b in mids_m for x in (W, b)] + [M, M[0]]:
        view = flat[off: off + width ** t.ndim].view((width,) * t.ndim)
        out.append(view[tuple(slice(0, k) for k in t.shape)])
        off += width ** t.ndim
    return list(zip(out[:-2:2], out[1:-2:2])), out[-2], out[-1]


def _raise(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _with_m_layer(mids_m: Layers, M):
    """The collapsed head's M as one more layer with a zero bias."""
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"M must be square, got {tuple(M.shape)}")
    return [*mids_m, (M, torch.zeros(M.shape[0], dtype=M.dtype, device=M.device))]


class _Launch:
    """Validated inputs of one launch: the layers (K7/K8: the hidden layers
    and the collapsed head (M, u)), the chain's widths, and the points,
    refs, mask and cotangents, contiguous."""

    def __init__(self, name, layers, act_name, ax, av, ar, mask, head=None, cot=()):
        if not supported_activation(act_name):
            raise ValueError(f"{name}: activation {act_name!r} has no derivative table")
        chain, extra = list(layers), list(cot)
        if head is not None:
            M, u = head
            if tuple(u.shape) != (M.shape[0],):
                raise ValueError(f"{name}: u must be [{M.shape[0]}], got {tuple(u.shape)}")
            chain, extra = _with_m_layer(layers, M), [u, *cot]
        n_layers = len(chain) - (head is not None)  # the collapsed head's M is no layer of the net
        least = 0 if head is not None else 1
        if not least <= n_layers <= MAX_MID:
            raise ValueError(f"{name} takes at most {MAX_MID} layers after the first, got {n_layers}")
        if ax.ndim != 3 or tuple(av.shape) != tuple(ax.shape) or ar.ndim != 3 \
                or ar.shape[0] != ax.shape[0] or ar.shape[2] != ax.shape[2]:
            raise ValueError(f"{name}: need ax, av [nt, n, w0] and ar [nt, m, w0], got "
                             f"{tuple(ax.shape)}, {tuple(av.shape)}, {tuple(ar.shape)}")
        self.nt, self.n, w0 = ax.shape
        self.m = ar.shape[1]
        if tuple(mask.shape) != (self.m,):
            raise ValueError(f"{name}: mask must be [{self.m}], got {tuple(mask.shape)}")
        widths = [w0]
        for W, b in chain:
            if W.ndim != 2 or W.shape[0] != widths[-1] or tuple(b.shape) != (W.shape[1],):
                raise ValueError(f"{name}: layer shapes {tuple(W.shape)}, {tuple(b.shape)} do not chain")
            widths.append(W.shape[1])
        dev = ax.device
        for t in [ax, av, ar, mask, *extra, *(x for pair in chain for x in pair)]:
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name}: every input must be float32 on {dev}, got {t.dtype} on {t.device}")
        if not (1 <= self.n and 1 <= self.m and self.nt * self.n * (2 + w0) < 2**31
                and -(-self.n // _TILE) * self.nt * self.m * w0 < 2**31):
            raise ValueError(f"{name}: sizes nt={self.nt}, n={self.n}, m={self.m} out of range")
        if cot and (tuple(cot[0].shape) != (self.nt, self.n) or tuple(cot[1].shape) != (self.nt, self.n)
                    or tuple(cot[2].shape) != tuple(ax.shape)):
            raise ValueError(f"{name}: cotangents must be [{self.nt}, {self.n}] and {tuple(ax.shape)}")
        self.name, self.layers, self.head, self.widths, self.dev = name, layers, head, widths, dev
        self.tensors = [t.contiguous() for t in (ax, av, ar, mask, *cot)]
        self.act_name, self.act = act_name, _ACTS[act_name]
        self.c_widths = (ctypes.c_int * len(widths))(*widths)

    @property
    def device(self) -> int:
        return device_index(self.tensors[0])

    def weights(self, plan: Plan):
        """(weights, weights_t) in the layout plan.kernel reads: the chain
        zero-padded to the plan's width (k5: ``pad_k5``; k6: ``pad_square``;
        k7, k8: ``pad_collapsed``), or the tile kernels' params [W_k, b_k]
        and params_t [W_k^T] of every layer, packed."""
        if plan.kernel == "k5":
            return pad_k5(self.layers, plan.width)[0], None
        if plan.kernel == "k6":
            return pad_square(self.layers, plan.width)[0], None
        if self.head is not None:
            return pad_collapsed(self.layers, *self.head, plan.width)[0], None
        return (torch.cat([x for W, b in self.layers for x in (W.reshape(-1), b)]),
                torch.cat([W.t().reshape(-1) for W, _ in self.layers]).contiguous())

    def weight_grads(self, plan: Plan, grads: torch.Tensor) -> tuple:
        """The layers' gradients out of `grads` in the layout of
        ``weights``, the padded entries dropped: ([(Wbar, bbar)],), K8's
        ([(Wbar, bbar)], M_bar, u_bar)."""
        if plan.kernel == "k6":
            return (unpad_square(grads, self.layers, plan.width),)
        if self.head is not None:
            return unpad_collapsed(grads, self.layers, self.head[0], plan.width)
        out, off = [], 0
        for W, b in self.layers:
            out.append((grads[off: off + W.numel()].view(W.shape),
                        grads[off + W.numel(): off + W.numel() + b.numel()]))
            off += W.numel() + b.numel()
        return (out,)

    def empty(self, *shape):
        return torch.empty(shape, dtype=torch.float32, device=self.dev)


def _call(L: _Launch, entry, plan: Plan, n_split: int, *pointers) -> None:
    """entry (pw_forward or pw_backward) of the plan, adding the sum_rows
    launches it made, as the library counts them, to ``sum_rows.launches``."""
    lib, device = _library(), L.device
    before = lib.pw_sum_rows_launches()
    err = entry(device, _KERNEL_IDS[plan.kernel], L.act, plan.width, plan.threads, len(L.widths) - 1,
                L.c_widths, plan.chunks, L.nt, L.n, L.m, n_split, *pointers, current_stream(device))
    sum_rows.launches += lib.pw_sum_rows_launches() - before
    _raise(err, L.name)


def _launch_fwd(plan: Plan, L: _Launch, n_split: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The sums by plan.kernel (k5, pw_fwd or k7): the refs split by
    ``ref_splits`` unless `n_split` is given, the splits' partial rows
    summed by sum_rows in a fixed order."""
    ax, av, ar, mask = L.tensors
    if n_split is None:
        n_split = ref_splits(plan, L.act_name, L.widths, L.nt, L.n, L.m, L.device)
    weights, weights_t = L.weights(plan)
    w0, tn = L.widths[0], L.nt * L.n
    partials = L.empty(n_split, tn * (2 + w0))
    out = L.empty(tn * (2 + w0))
    _call(L, _library().pw_forward, plan, n_split, ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(),
          weights.data_ptr(), None if weights_t is None else weights_t.data_ptr(), partials.data_ptr(),
          out.data_ptr())
    return {"value": out[:tn].view(L.nt, L.n), "hess": out[tn: 2 * tn].view(L.nt, L.n),
            "s_dz0": out[2 * tn:].view(L.nt, L.n, w0)}


def _launch_bwd(plan: Plan, L: _Launch, n_split: Optional[int] = None) -> tuple:
    """The VJP by plan.kernel (k6, pw_bwd or k8): the refs split by
    ``ref_splits`` unless `n_split` is given, the per-block partial rows
    summed by sum_rows in a fixed order; (*``_Launch.weight_grads``,
    ax_bar, av_bar, ar_bar)."""
    w0, n_blk = L.widths[0], -(-L.n // plan.points)
    if n_blk * L.nt * L.m * w0 >= 2**31:
        raise ValueError(f"{L.name}: sizes nt={L.nt}, n={L.n}, m={L.m} out of range")
    ax, av, ar, mask, g_val, g_hess, g_dz0 = L.tensors
    if n_split is None:
        n_split = ref_splits(plan, L.act_name, L.widths, L.nt, L.n, L.m, L.device)
    weights, weights_t = L.weights(plan)
    w_partials = L.empty(n_split * L.nt * n_blk, weights.numel())
    grads = L.empty(weights.numel())
    x_partials = L.empty(n_split, 2 * L.nt * L.n * w0)
    axv_bar = L.empty(2, L.nt, L.n, w0)
    ar_partials = L.empty(n_blk, L.nt * L.m * w0)
    ar_bar = L.empty(L.nt, L.m, w0)
    _call(L, _library().pw_backward, plan, n_split, ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(),
          g_val.data_ptr(), g_hess.data_ptr(), g_dz0.data_ptr(), weights.data_ptr(),
          None if weights_t is None else weights_t.data_ptr(), w_partials.data_ptr(), grads.data_ptr(),
          x_partials.data_ptr(), axv_bar.data_ptr(), ar_partials.data_ptr(), ar_bar.data_ptr())
    return (*L.weight_grads(plan, grads), axv_bar[0], axv_bar[1], ar_bar)


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one; raises
    for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA or CPU tensors, got {t.device}")
    return True


def mlp_pairwise_sums(mids: Layers, act_name: str, ax, av, ar, mask):
    """K5: {value, hess, s_dz0}.  CUDA tensors: the forward kernel that
    ``choose`` gives under "on" (k5_kernel or pw_fwd_kernel); per-split
    partials summed in a fixed order, so two calls give bitwise-equal
    results.  CPU tensors: ``mlp_pairwise_sums_plain``."""
    if not _on_cuda("K5", ax):
        return mlp_pairwise_sums_plain(mids, act_name, ax, av, ar, mask)
    L = _Launch("K5", mids, act_name, ax, av, ar, mask)
    out = _launch_fwd(plan(choose(L.widths, "on")[0], L.widths), L)
    mlp_pairwise_sums.launches += 1
    return out


def mlp_pairwise_sums_bwd(mids: Layers, act_name: str, ax, av, ar, mask, g_val, g_hess, g_dz0):
    """K6: ([(Wbar, bbar)], ax_bar, av_bar, ar_bar).  CUDA tensors: the
    backward kernel that ``choose`` gives under "on" (k6_kernel or
    pw_bwd_kernel); per-block partials summed in a fixed order, so two calls
    give bitwise-equal results.  CPU tensors: ``mlp_pairwise_sums_bwd_plain``."""
    if not _on_cuda("K6", ax):
        return mlp_pairwise_sums_bwd_plain(mids, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0)
    L = _Launch("K6", mids, act_name, ax, av, ar, mask, cot=(g_val, g_hess, g_dz0))
    out = _launch_bwd(plan(choose(L.widths, "on")[1], L.widths), L)
    mlp_pairwise_sums_bwd.launches += 1
    return out


def mlp_pairwise_sums_packed(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask):
    """K7: {value (without c), hess, s_dz0}.  CUDA tensors: k7_kernel; CPU
    tensors: ``mlp_pairwise_sums_packed_plain``."""
    if not _on_cuda("K7", ax):
        return mlp_pairwise_sums_packed_plain(mids_m, M, u, act_name, ax, av, ar, mask)
    L = _Launch("K7", mids_m, act_name, ax, av, ar, mask, head=(M, u))
    out = _launch_fwd(plan("k7", L.widths), L)
    mlp_pairwise_sums_packed.launches += 1
    return out


def mlp_pairwise_sums_packed_bwd(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask,
                                 g_val, g_hess, g_dz0):
    """K8: ([(Wbar, bbar)], M_bar, u_bar, ax_bar, av_bar, ar_bar).  CUDA
    tensors: k8_kernel (bitwise repeatable, as K6); CPU tensors:
    ``mlp_pairwise_sums_packed_bwd_plain``."""
    if not _on_cuda("K8", ax):
        return mlp_pairwise_sums_packed_bwd_plain(mids_m, M, u, act_name, ax, av, ar, mask,
                                                  g_val, g_hess, g_dz0)
    L = _Launch("K8", mids_m, act_name, ax, av, ar, mask, head=(M, u), cot=(g_val, g_hess, g_dz0))
    out = _launch_bwd(plan("k8", L.widths), L)
    mlp_pairwise_sums_packed_bwd.launches += 1
    return out


# -- S1: checks of the constructs K5/K6 run; K7/K8 unsplit ----------------------------


def s1_pair_rows_plain(ax, av, ar):
    """(z, dz) [m, n, w0]: z = ax_i - ar_j and dz = av_i for every ref j."""
    return ax[None] - ar[:, None], av[None].expand(ar.shape[0], *av.shape).contiguous()


def _checked(name: str, *tensors: torch.Tensor):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: every input must be float32 on {dev}, got {t.dtype} on {t.device}")
    return [t.contiguous() for t in tensors]


def s1_pair_rows(ax, av, ar):
    """S1's pair rows of n <= 32 points ax, av [n, w0] against refs ar
    [m, w0], a block a ref, through K5/K6's ``pair_rows``: (z, dz)
    [m, n, w0].  CPU tensors: ``s1_pair_rows_plain``."""
    if not _on_cuda("S1", ax):
        return s1_pair_rows_plain(ax, av, ar)
    ax, av, ar = _checked("S1 pair rows", ax, av, ar)
    (n, w0), m = ax.shape, ar.shape[0]
    if not 1 <= n <= _TILE or tuple(av.shape) != (n, w0) or ar.shape[1] != w0:
        raise ValueError(f"S1 pair rows: need ax, av [n <= {_TILE}, w0] and ar [m, w0]")
    out = torch.empty((2, m, n, w0), dtype=torch.float32, device=ax.device)  # z | dz
    z_ptr = out.data_ptr()
    _raise(_library().s1_pair_rows(device_index(ax), w0, n, m, ax.data_ptr(), av.data_ptr(),
                                   ar.data_ptr(), z_ptr, z_ptr + 4 * m * n * w0,
                                   current_stream(device_index(ax))), "S1 pair rows")
    s1_pair_rows.launches += 1
    return out.unbind(0)


def s1_m_layer_plain(g3, M):
    """The collapsed head's M layer on the streams g3 [3, n, w]: g3 @ M."""
    return g3 @ M


def s1_m_layer(g3, M):
    """S1's M layer on (g, gp, gq) [3, n <= 32, w] in one block, through
    K5/K6's ``forward_product`` with M's zero bias: [3, n, w].  CPU tensors:
    ``s1_m_layer_plain``."""
    if not _on_cuda("S1", g3):
        return s1_m_layer_plain(g3, M)
    g3, M = _checked("S1 M layer", g3, M)
    _, n, w = g3.shape
    if g3.shape[0] != 3 or not 1 <= n <= _TILE or tuple(M.shape) != (w, w):
        raise ValueError(f"S1 M layer: need g3 [3, n <= {_TILE}, w] and M [w, w]")
    params = torch.cat([M.reshape(-1), torch.zeros(w, dtype=M.dtype, device=M.device)])
    out = torch.empty_like(g3)
    _raise(_library().s1_m_layer(device_index(g3), w, n, g3.data_ptr(), params.data_ptr(),
                                 out.data_ptr(), current_stream(device_index(g3))),
           "S1 M layer")
    s1_m_layer.launches += 1
    return out


def sum_rows_plain(part):
    """out[e] = sum over rows r of part[r][e] (part [rows, ...]) in the
    kernel's order (``sum_rows_plan``, ``chunked_sum``), in the input's
    precision."""
    rows = part.shape[0]
    flat = part.reshape(rows, -1)
    return chunked_sum([flat], sum_rows_plan(rows, flat.shape[1]).chunk).view(part.shape[1:])


def sum_rows(part):
    """The fixed-order row sum of K5-K8's partial rows: part [rows, len] ->
    [len], in the order of ``row_chunks.sum_rows_plan``.  CPU tensors:
    ``sum_rows_plain``.  ``sum_rows.launches`` also counts the launches
    inside K5-K8's calls (one for K5 and K7, three for K6 and K8), read
    from the library's own count (``pw_sum_rows_launches``)."""
    if not _on_cuda("sum_rows", part):
        return sum_rows_plain(part)
    (part,) = _checked("sum_rows", part)
    if part.ndim != 2 or part.shape[0] < 1 or part.shape[1] < 1:
        raise ValueError(f"sum_rows: need part [rows, len], got {tuple(part.shape)}")
    out = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    _raise(_library().pw_sum_rows(device_index(part), part.data_ptr(), out.data_ptr(), part.shape[0], part.shape[1],
                                  current_stream(device_index(part))), "sum_rows")
    sum_rows.launches += 1
    return out


def sum_rows_plan_c(rows: int, len_: int, slab: int = 32) -> SumRowsPlan:
    """The kernel's own plan (``sum_rows_plan_c`` in csrc/pairwise.cu);
    builds the library."""
    out = (ctypes.c_longlong * 6)()
    _library().sum_rows_plan_c(rows, len_, slab, out)
    return SumRowsPlan(*out)


def s1_packed_sums(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask):
    """K7 with the refs unsplit (one split): S1's full-kernel check.  CPU
    tensors: ``mlp_pairwise_sums_packed_plain``."""
    if not _on_cuda("S1", ax):
        return mlp_pairwise_sums_packed_plain(mids_m, M, u, act_name, ax, av, ar, mask)
    L = _Launch("S1 K7", mids_m, act_name, ax, av, ar, mask, head=(M, u))
    out = _launch_fwd(plan("k7", L.widths), L, n_split=1)
    s1_packed_sums.launches += 1
    return out


def s1_packed_sums_bwd(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask, g_val, g_hess, g_dz0):
    """K8 with the refs unsplit (one split): S1's full-kernel check of the
    VJP.  CPU tensors: ``mlp_pairwise_sums_packed_bwd_plain``."""
    if not _on_cuda("S1", ax):
        return mlp_pairwise_sums_packed_bwd_plain(mids_m, M, u, act_name, ax, av, ar, mask,
                                                  g_val, g_hess, g_dz0)
    L = _Launch("S1 K8", mids_m, act_name, ax, av, ar, mask, head=(M, u), cot=(g_val, g_hess, g_dz0))
    out = _launch_bwd(plan("k8", L.widths), L, n_split=1)
    s1_packed_sums_bwd.launches += 1
    return out


S1_WRAPPERS = (s1_pair_rows, s1_m_layer, sum_rows, s1_packed_sums, s1_packed_sums_bwd)
for _fn in S1_WRAPPERS:
    _fn.launches = 0
mlp_pairwise_sums.launches = 0
mlp_pairwise_sums_bwd.launches = 0
mlp_pairwise_sums_packed.launches = 0
mlp_pairwise_sums_packed_bwd.launches = 0
