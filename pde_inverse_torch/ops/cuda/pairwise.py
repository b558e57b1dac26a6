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
  Phi = |f_L|^2; where every width before the feature layer is <= 32, K5
  runs k5_kernel (K7's thread per point, the feature layer streamed in
  chunks of 4, ``k5_plan``), else pw_fwd_kernel; where every such width is
  <= 64 and its plan fits, K6 runs k6_kernel (K8's lane quads at widths <=
  32, lane octets at 48 and 64, the feature layer streamed in chunks,
  ``k6_plan``), else pw_bwd_kernel;
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

For a CUDA tensor each wrapper launches its kernel on the current stream
and raises if the build or the launch fails; for a CPU tensor it runs its
plain version.  ``<wrapper>.launches`` counts kernel launches (CPU calls do
not count).  The plain versions process the refs in chunks of at most
``ROWS_PER_CHUNK`` pairs, so they also run at the full main-path width.
All arithmetic is float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from pde_inverse_torch.ops.activations import ACT_D012, ACT_D0123, supported_activation
from pde_inverse_torch.ops.cuda import build, current_stream, device_index
from pde_inverse_torch.ops.cuda.row_chunks import SumRowsPlan, chunked_sum, sum_rows_plan

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]

ROWS_PER_CHUNK = 1 << 20  # pairs per chunk of the plain versions
MAX_MID = 16  # layers after the first that the kernels take
_ACTS = {"tanh": 0, "silu": 1, "softplus": 2}
_TILE = 32  # points per tile, csrc/pairwise.cu kTile
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


def _library() -> ctypes.CDLL:
    lib = build.load("pairwise")
    if lib.pw_sums.argtypes is None:
        vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.pw_sums.argtypes = [ci, ci, ci, pi, ci, ci, ci, ci] + [vp] * 9
        lib.pw_sums_bwd.argtypes = [ci, ci, ci, pi, ci, ci, ci, ci] + [vp] * 16
        lib.pw_max_blocks.argtypes = [ci, ci, ci, ci, pi, pi]
        lib.k7_sums.argtypes = [ci] * 10 + [vp] * 8
        lib.k8_sums_bwd.argtypes = [ci] * 10 + [vp] * 15
        lib.k6_sums_bwd.argtypes = [ci] * 11 + [vp] * 15
        lib.k5_sums.argtypes = [ci] * 11 + [vp] * 8
        for fn in (lib.k5_max_blocks, lib.k6_max_blocks):
            fn.argtypes = [ci] * 6 + [pi]
        for fn in (lib.k5_shared_bytes_c, lib.k6_shared_bytes_c):
            fn.argtypes = [ci] * 4
            fn.restype = ctypes.c_longlong
        for fn in (lib.k7_max_blocks, lib.k8_max_blocks):
            fn.argtypes = [ci] * 5 + [pi]
        for fn in (lib.k7_shared_bytes_c, lib.k8_shared_bytes_c):
            fn.argtypes = [ci] * 3
            fn.restype = ctypes.c_longlong
        lib.s1_pair_rows.argtypes = [ci, ci, ci, ci] + [vp] * 6
        lib.s1_m_layer.argtypes = [ci, ci, ci] + [vp] * 4
        lib.pw_sum_rows.argtypes = [ci, vp, vp, ci, ctypes.c_longlong, vp]
        lib.sum_rows_plan_c.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ci,
                                        ctypes.POINTER(ctypes.c_longlong)]
        lib.sum_rows_plan_c.restype = None
        lib.pw_sum_rows_launches.argtypes = []
        lib.pw_sum_rows_launches.restype = ctypes.c_longlong
        for fn in (lib.pw_sums, lib.pw_sums_bwd, lib.pw_max_blocks, lib.k5_sums, lib.k5_max_blocks,
                   lib.k7_sums, lib.k7_max_blocks, lib.k8_sums_bwd, lib.k8_max_blocks, lib.k6_sums_bwd,
                   lib.k6_max_blocks, lib.s1_pair_rows, lib.s1_m_layer, lib.pw_sum_rows):
            fn.restype = ci
    return lib


def _counting_sum_rows(lib: ctypes.CDLL, entry, *args) -> int:
    """entry(*args), adding the sum_rows launches it made, as the library
    counts them where it launches, to ``sum_rows.launches``."""
    before = lib.pw_sum_rows_launches()
    err = entry(*args)
    sum_rows.launches += lib.pw_sum_rows_launches() - before
    return err


def shared_bytes(widths: Sequence[int], n_streams: int) -> int:
    """Dynamic shared memory of one block: every layer's streams of a tile,
    the activated copy of the widest layer input, the cached tile inputs and
    the block's accumulators."""
    rows = sum(widths)
    tmp_rows = -(-max(widths[:-1]) // 4) * 4
    return (n_streams * (rows + tmp_rows) + 5 * widths[0] + 4) * _ROW * 4


class K7Plan(NamedTuple):
    """How K7 or K8 runs a chain: every layer, M and u zero-padded to `width`
    (a k7_kernel / k8_kernel instantiation), `threads` a block (K7: one a
    point; K8: four), `shared_bytes` of dynamic shared memory a block."""

    width: int
    threads: int
    shared_bytes: int


def k7_shared_bytes(width: int, threads: int, n_layers: int) -> int:
    """K7's shared memory a block (csrc/pairwise.cu): the padded weights,
    n_layers x (W_k, b_k) then M and u, and for each of the block's points
    act'(z_k) of every hidden layer and the s_dz0 sums, in rows of width
    floats (width + 4 where width is a multiple of 8)."""
    weights = n_layers * (width * width + width) + width * width + width
    row = width + 4 if width % 8 == 0 else width
    return 4 * (weights + (n_layers + 1) * threads * row)


def _plan(name: str, widths: Sequence[int], candidates: Sequence[int], shared_bytes_of) -> K7Plan:
    n_layers = len(widths) - 2
    if n_layers < 0 or min(widths) < 1:
        raise ValueError(f"{name}: widths {list(widths)} are not a chain ending with M's width")
    width = next((w for w in K7_WIDTHS if w >= max(widths)), None)
    if width is None:
        raise ValueError(f"{name} takes widths <= {K7_WIDTHS[-1]}, got {list(widths)}")
    for threads in candidates:
        smem = shared_bytes_of(width, threads, n_layers)
        if smem <= _MAX_SHARED_BYTES:
            return K7Plan(width, threads, smem)
    raise ValueError(f"{name}: widths {list(widths)} need more than {_MAX_SHARED_BYTES} B of shared memory")


def k7_plan(widths: Sequence[int]) -> K7Plan:
    """K7's plan for the chain `widths` = [w0, the hidden layers' output
    widths..., M's width]: the least instantiated width that holds every
    one of them, and the most points a block whose shared memory fits."""
    return _plan("K7", widths, K7_THREADS, k7_shared_bytes)


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


def k8_plan(widths: Sequence[int]) -> K7Plan:
    """K8's plan for the chain `widths` (as ``k7_plan``): K7's width, and
    the most lanes a block (four a point) whose shared memory fits."""
    return _plan("K8", widths, K8_THREADS, k8_shared_bytes)


def k6_rows(n_layers: int) -> int:
    """Row sets of a k6_kernel block in shared memory: the saved inputs of
    the layers 1 .. n_layers - 1, the set H and the two sets S."""
    return max(n_layers, 1) + 2


def k6_lanes(width: int) -> int:
    """Lanes a pair of k6_kernel at an instantiated width: four (K8's
    quads) up to 32, eight at 48 and 64 (csrc/pairwise.cu k8_lanes)."""
    return 8 if width > 32 else 4


class K6Plan(NamedTuple):
    """How k6_kernel runs a square-head chain: the hidden layers zero-padded
    to `width`, the feature layer to `chunks` chunks of `width` features,
    `threads` lanes a block (``k6_lanes(width)`` a point), `shared_bytes` a
    block."""

    width: int
    threads: int
    shared_bytes: int
    chunks: int

    @property
    def points(self) -> int:
        """Points (pairs at one ref) a block."""
        return self.threads // k6_lanes(self.width)


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


def _k6_fit(widths: Sequence[int]) -> Optional[K6Plan]:
    """k6_kernel's plan for the chain `widths`, or None where no block's
    shared memory fits; raises for a width past 64 or a non-chain."""
    n_layers = len(widths) - 2
    if n_layers < 0 or min(widths) < 1:
        raise ValueError(f"K6: widths {list(widths)} are not a chain ending with the feature width")
    width = next((w for w in K6_WIDTHS if w >= max(widths[:-1])), None)
    if width is None:
        raise ValueError(f"K6 takes widths <= {K6_WIDTHS[-1]} before the feature layer, got {list(widths)}")
    chunks = -(-widths[-1] // width)
    threads = next((t for t in K6_THREADS if k6_shared_bytes(width, t, n_layers, chunks) <= _MAX_SHARED_BYTES),
                   None)
    return None if threads is None else K6Plan(width, threads, k6_shared_bytes(width, threads, n_layers, chunks),
                                               chunks)


def k6_takes(widths: Sequence[int]) -> bool:
    """Whether the square-head chain `widths` = [w0, the hidden layers'
    output widths..., the feature width] runs through k6_kernel rather than
    pw_bwd_kernel: every width before the feature layer <= 32 (on lane
    quads; ``k6_plan`` raises where the plan does not fit), or <= 64 where
    the plan on eight lanes a pair fits.  pw_bwd_kernel keeps the wider
    chains, and those at 33-64 that its 32-point tile holds and the octets,
    which pad every layer to the widest, do not (e.g. [1] + [56] x 6 + [8])."""
    if len(widths) < 2 or min(widths) < 1 or max(widths[:-1]) > K6_WIDTHS[-1]:
        return False
    return max(widths[:-1]) <= K7_WIDTHS[-1] or _k6_fit(widths) is not None


def k6_plan(widths: Sequence[int]) -> K6Plan:
    """k6_kernel's plan for the chain `widths` (as ``k6_takes``): the least
    instantiated width (of K6_WIDTHS) that holds every width before the
    feature layer, the feature layer in chunks of that width, and the most
    lanes a block (of K6_THREADS) whose shared memory fits."""
    plan = _k6_fit(widths)
    if plan is None:
        raise ValueError(f"K6: widths {list(widths)} need more than {_MAX_SHARED_BYTES} B of shared memory")
    return plan


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


class K5Plan(NamedTuple):
    """How k5_kernel runs a square-head chain: the hidden layers zero-padded
    to `width`, the feature layer to `chunks` chunks of K5_CHUNK features,
    `threads` points a block (one a thread), `shared_bytes` a block."""

    width: int
    threads: int
    shared_bytes: int
    chunks: int


def k5_shared_bytes(width: int, threads: int, n_layers: int, chunks: int) -> int:
    """k5_kernel's shared memory a block (csrc/pairwise.cu): the padded
    weights, n_layers x (W_k, b_k) then W_F [width, F4] and b_F [F4] (F4 =
    K5_CHUNK x chunks), and K7's rows of act' and of the s_dz0 sums."""
    weights = n_layers * (width * width + width) + (width + 1) * K5_CHUNK * chunks
    row = width + 4 if width % 8 == 0 else width
    return 4 * (weights + (n_layers + 1) * threads * row)


def k5_takes(widths: Sequence[int]) -> bool:
    """Whether the square-head chain `widths` runs through k5_kernel rather
    than pw_fwd_kernel: every width before the feature layer <= 32 (k5_kernel
    has no instantiation past 32; ``k6_takes`` also takes 48 and 64)."""
    return len(widths) >= 2 and max(widths[:-1]) <= K7_WIDTHS[-1]


def k5_plan(widths: Sequence[int]) -> K5Plan:
    """k5_kernel's plan for the chain `widths` (as ``k5_takes``): the least
    instantiated width that holds every width before the feature layer, the
    feature layer in chunks of K5_CHUNK features, and the most points a
    block (of K7_THREADS) whose shared memory fits."""
    n_layers = len(widths) - 2
    if n_layers < 0 or min(widths) < 1:
        raise ValueError(f"K5: widths {list(widths)} are not a chain ending with the feature width")
    width = next((w for w in K7_WIDTHS if w >= max(widths[:-1])), None)
    if width is None:
        raise ValueError(f"K5 takes widths <= {K7_WIDTHS[-1]} before the feature layer, got {list(widths)}")
    chunks = -(-widths[-1] // K5_CHUNK)
    for threads in K7_THREADS:
        smem = k5_shared_bytes(width, threads, n_layers, chunks)
        if smem <= _MAX_SHARED_BYTES:
            return K5Plan(width, threads, smem, chunks)
    raise ValueError(f"K5: widths {list(widths)} need more than {_MAX_SHARED_BYTES} B of shared memory")


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


class _Launch:
    """Validated inputs of one launch: widths, layers, device, stream."""

    def __init__(self, name, layers, act_name, ax, av, ar, mask, extra=(), head=None):
        if not supported_activation(act_name):
            raise ValueError(f"{name}: activation {act_name!r} has no derivative table")
        n_layers = len(layers) - (head is not None)  # the collapsed head's M is no layer of the net
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
        for W, b in layers:
            if W.ndim != 2 or W.shape[0] != widths[-1] or tuple(b.shape) != (W.shape[1],):
                raise ValueError(f"{name}: layer shapes {tuple(W.shape)}, {tuple(b.shape)} do not chain")
            widths.append(W.shape[1])
        dev = ax.device
        for t in [ax, av, ar, mask, *extra, *(x for pair in layers for x in pair)]:
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name}: every input must be float32 on {dev}, got {t.dtype} on {t.device}")
        if not (1 <= self.n and 1 <= self.m and self.nt * self.n * (2 + w0) < 2**31
                and -(-self.n // _TILE) * self.nt * self.m * w0 < 2**31):
            raise ValueError(f"{name}: sizes nt={self.nt}, n={self.n}, m={self.m} out of range")
        self.name, self.layers, self.widths, self.dev = name, layers, widths, dev
        self.act = _ACTS[act_name]
        self.device = device_index(ax)
        self.c_widths = (ctypes.c_int * len(widths))(*widths)
        self.stream = current_stream(self.device)

    def params(self):
        """(params, params_t): [W_k, b_k] and [W_k^T] of every layer, packed."""
        return (torch.cat([x for W, b in self.layers for x in (W.reshape(-1), b)]),
                torch.cat([W.t().reshape(-1) for W, _ in self.layers]).contiguous())

    def splits(self, lib, bwd: bool) -> int:
        """Ref splits: enough blocks for about _WAVES waves of resident
        blocks, at most one split per ref."""
        smem = shared_bytes(self.widths, 4 if bwd else 3)
        if smem > _MAX_SHARED_BYTES:
            raise ValueError(f"{self.name}: widths {self.widths} need {smem} B of shared memory "
                             f"per block, more than {_MAX_SHARED_BYTES}")
        per_sm = ctypes.c_int(0)
        _raise(lib.pw_max_blocks(self.device, self.act, int(bwd), len(self.widths) - 1,
                                 self.c_widths, ctypes.byref(per_sm)), f"{self.name} occupancy query")
        resident = self.resident(per_sm.value)
        base = self.nt * -(-self.n // _TILE)
        return max(1, min(self.m, -(-_WAVES * resident // base)))

    def resident(self, blocks_per_sm: int) -> int:
        """Blocks the card runs at once, from the blocks an SM holds."""
        if blocks_per_sm < 1:
            raise RuntimeError(f"{self.name}: no block fits on an SM at widths {self.widths}")
        return blocks_per_sm * torch.cuda.get_device_properties(self.dev).multi_processor_count

    def empty(self, *shape):
        return torch.empty(shape, dtype=torch.float32, device=self.dev)


def _grads_of(grads: torch.Tensor, layers: Layers):
    """The packed gradient vector as [(Wbar, bbar)] in the layers' shapes."""
    out, off = [], 0
    for W, b in layers:
        out.append((grads[off: off + W.numel()].view(W.shape), grads[off + W.numel(): off + W.numel() + b.numel()]))
        off += W.numel() + b.numel()
    return out


def _sums_out(L: _Launch, out: torch.Tensor) -> Dict[str, torch.Tensor]:
    tn = L.nt * L.n
    return {"value": out[:tn].view(L.nt, L.n), "hess": out[tn: 2 * tn].view(L.nt, L.n),
            "s_dz0": out[2 * tn:].view(L.nt, L.n, L.widths[0])}


def _fwd_launch(name, layers, act_name, ax, av, ar, mask) -> Dict[str, torch.Tensor]:
    """K5 through pw_fwd_kernel (hidden widths > 32)."""
    L = _Launch(name, layers, act_name, ax, av, ar, mask)
    ax, av, ar, mask = ax.contiguous(), av.contiguous(), ar.contiguous(), mask.contiguous()
    lib = _library()
    n_split = L.splits(lib, bwd=False)
    w0 = L.widths[0]
    tn = L.nt * L.n
    partials = L.empty(n_split, tn * (2 + w0))
    out = L.empty(tn * (2 + w0))
    params, params_t = L.params()
    _raise(_counting_sum_rows(lib, lib.pw_sums,
        L.device, L.act, len(L.widths) - 1, L.c_widths, L.nt, L.n, L.m, n_split,
        ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(), params.data_ptr(),
        params_t.data_ptr(), partials.data_ptr(), out.data_ptr(), L.stream,
    ), name)
    return _sums_out(L, out)


def _k5_launch(name, mids, act_name, ax, av, ar, mask) -> Dict[str, torch.Tensor]:
    """K5 through k5_kernel: the chain padded to its plan's width, the
    feature layer to whole chunks, the refs split by ``k7_splits`` over the
    plan's points a block."""
    L = _Launch(name, mids, act_name, ax, av, ar, mask)
    plan = k5_plan(L.widths)
    ax, av, ar, mask = ax.contiguous(), av.contiguous(), ar.contiguous(), mask.contiguous()
    lib = _library()
    n_layers = len(mids) - 1
    per_sm = ctypes.c_int(0)
    _raise(lib.k5_max_blocks(L.device, L.act, plan.width, plan.threads, n_layers, plan.chunks,
                             ctypes.byref(per_sm)), f"{name} occupancy query")
    n_split = k7_splits(L.nt, L.n, L.m, plan.threads, L.resident(per_sm.value))
    weights = pad_k5(mids, plan.width)[0]
    w0 = L.widths[0]
    tn = L.nt * L.n
    partials = L.empty(n_split, tn * (2 + w0))
    out = L.empty(tn * (2 + w0))
    _raise(_counting_sum_rows(lib, lib.k5_sums,
        L.device, L.act, plan.width, plan.threads, n_layers, plan.chunks, w0, L.nt, L.n, L.m, n_split,
        ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(), weights.data_ptr(),
        partials.data_ptr(), out.data_ptr(), L.stream,
    ), name)
    return _sums_out(L, out)


def _k7_launch(name, mids_m, M, u, act_name, ax, av, ar, mask, n_split=None) -> Dict[str, torch.Tensor]:
    """K7: the chain padded to its plan's width, the refs split by
    ``k7_splits`` unless `n_split` is given."""
    if tuple(u.shape) != (M.shape[0],):
        raise ValueError(f"{name}: u must be [{M.shape[0]}], got {tuple(u.shape)}")
    L = _Launch(name, _with_m_layer(mids_m, M), act_name, ax, av, ar, mask, (u,), head=(M, u))
    plan = k7_plan(L.widths)
    ax, av, ar, mask = ax.contiguous(), av.contiguous(), ar.contiguous(), mask.contiguous()
    lib = _library()
    n_layers = len(mids_m)
    if n_split is None:
        per_sm = ctypes.c_int(0)
        _raise(lib.k7_max_blocks(L.device, L.act, plan.width, plan.threads, n_layers,
                                 ctypes.byref(per_sm)), f"{name} occupancy query")
        n_split = k7_splits(L.nt, L.n, L.m, plan.threads, L.resident(per_sm.value))
    weights = pad_collapsed(mids_m, M, u, plan.width)[0]
    w0 = L.widths[0]
    tn = L.nt * L.n
    partials = L.empty(n_split, tn * (2 + w0))
    out = L.empty(tn * (2 + w0))
    _raise(_counting_sum_rows(lib, lib.k7_sums,
        L.device, L.act, plan.width, plan.threads, n_layers, w0, L.nt, L.n, L.m, n_split,
        ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(), weights.data_ptr(),
        partials.data_ptr(), out.data_ptr(), L.stream,
    ), name)
    return _sums_out(L, out)


def _check_cotangents(L: _Launch, ax, g_val, g_hess, g_dz0) -> None:
    if tuple(g_val.shape) != (L.nt, L.n) or tuple(g_hess.shape) != (L.nt, L.n) \
            or tuple(g_dz0.shape) != tuple(ax.shape):
        raise ValueError(f"{L.name}: cotangents must be [{L.nt}, {L.n}] and {tuple(ax.shape)}")


def _k6_launch(name, mids, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0):
    """K6 through k6_kernel: the chain padded to its plan's width, the
    feature layer in the plan's chunks, the refs split by ``k7_splits`` over
    the plan's points a block; the gradients of the padded entries are
    dropped."""
    L = _Launch(name, mids, act_name, ax, av, ar, mask, (g_val, g_hess, g_dz0))
    _check_cotangents(L, ax, g_val, g_hess, g_dz0)
    plan = k6_plan(L.widths)
    points = plan.points
    w0, n_blk = L.widths[0], -(-L.n // points)
    if n_blk * L.nt * L.m * w0 >= 2**31:
        raise ValueError(f"{name}: sizes nt={L.nt}, n={L.n}, m={L.m} out of range")
    ax, av, ar, mask = ax.contiguous(), av.contiguous(), ar.contiguous(), mask.contiguous()
    g_val, g_hess, g_dz0 = g_val.contiguous(), g_hess.contiguous(), g_dz0.contiguous()
    lib = _library()
    n_layers = len(mids) - 1
    per_sm = ctypes.c_int(0)
    _raise(lib.k6_max_blocks(L.device, L.act, plan.width, plan.threads, n_layers, plan.chunks,
                             ctypes.byref(per_sm)), f"{name} occupancy query")
    n_split = k7_splits(L.nt, L.n, L.m, points, L.resident(per_sm.value))
    weights = pad_square(mids, plan.width)[0]
    w_partials = L.empty(n_split * L.nt * n_blk, weights.numel())
    grads = L.empty(weights.numel())
    x_partials = L.empty(n_split, 2 * L.nt * L.n * w0)
    axv_bar = L.empty(2, L.nt, L.n, w0)
    ar_partials = L.empty(n_blk, L.nt * L.m * w0)
    ar_bar = L.empty(L.nt, L.m, w0)
    _raise(_counting_sum_rows(lib, lib.k6_sums_bwd,
        L.device, L.act, plan.width, plan.threads, n_layers, plan.chunks, w0, L.nt, L.n, L.m, n_split,
        ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(), g_val.data_ptr(),
        g_hess.data_ptr(), g_dz0.data_ptr(), weights.data_ptr(), w_partials.data_ptr(),
        grads.data_ptr(), x_partials.data_ptr(), axv_bar.data_ptr(), ar_partials.data_ptr(),
        ar_bar.data_ptr(), L.stream,
    ), name)
    return unpad_square(grads, mids, plan.width), axv_bar[0], axv_bar[1], ar_bar


def _bwd_launch(name, layers, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0):
    """K6 through pw_bwd_kernel (the chains ``k6_takes`` refuses)."""
    L = _Launch(name, layers, act_name, ax, av, ar, mask, (g_val, g_hess, g_dz0))
    _check_cotangents(L, ax, g_val, g_hess, g_dz0)
    ax, av, ar, mask = ax.contiguous(), av.contiguous(), ar.contiguous(), mask.contiguous()
    g_val, g_hess, g_dz0 = g_val.contiguous(), g_hess.contiguous(), g_dz0.contiguous()
    lib = _library()
    n_split = L.splits(lib, bwd=True)
    w0 = L.widths[0]
    n_blk = -(-L.n // _TILE)
    params, params_t = L.params()
    n_params = params.numel()
    w_partials = L.empty(n_split * L.nt * n_blk, n_params)
    grads = L.empty(n_params)
    x_partials = L.empty(n_split, 2 * L.nt * L.n * w0)
    axv_bar = L.empty(2, L.nt, L.n, w0)
    ar_partials = L.empty(n_blk, L.nt * L.m * w0)
    ar_bar = L.empty(L.nt, L.m, w0)
    _raise(_counting_sum_rows(lib, lib.pw_sums_bwd,
        L.device, L.act, len(L.widths) - 1, L.c_widths, L.nt, L.n, L.m, n_split,
        ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(), g_val.data_ptr(),
        g_hess.data_ptr(), g_dz0.data_ptr(), params.data_ptr(), params_t.data_ptr(),
        w_partials.data_ptr(), grads.data_ptr(),
        x_partials.data_ptr(), axv_bar.data_ptr(), ar_partials.data_ptr(), ar_bar.data_ptr(),
        L.stream,
    ), name)
    return _grads_of(grads, layers), axv_bar[0], axv_bar[1], ar_bar


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one; raises
    for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA or CPU tensors, got {t.device}")
    return True


def mlp_pairwise_sums(mids: Layers, act_name: str, ax, av, ar, mask):
    """K5: {value, hess, s_dz0}.  CUDA tensors: by shape (``k5_takes``),
    k5_kernel where every width before the feature layer is <= 32 (counted
    in ``.launches``), else pw_fwd_kernel (counted in ``.launches_wide``);
    per-split partials summed in a fixed order, so two calls give
    bitwise-equal results.  CPU tensors: ``mlp_pairwise_sums_plain``."""
    if not _on_cuda("K5", ax):
        return mlp_pairwise_sums_plain(mids, act_name, ax, av, ar, mask)
    if k5_takes([ax.shape[-1]] + [W.shape[1] for W, _ in mids]):
        out = _k5_launch("K5", mids, act_name, ax, av, ar, mask)
        mlp_pairwise_sums.launches += 1
    else:
        out = _fwd_launch("K5", mids, act_name, ax, av, ar, mask)
        mlp_pairwise_sums.launches_wide += 1
    return out


def mlp_pairwise_sums_bwd(mids: Layers, act_name: str, ax, av, ar, mask, g_val, g_hess, g_dz0):
    """K6: ([(Wbar, bbar)], ax_bar, av_bar, ar_bar).  CUDA tensors: by shape
    (``k6_takes``), k6_kernel where every width before the feature layer is
    <= 64 and its plan fits (counted in ``.launches``), else pw_bwd_kernel
    (counted in ``.launches_wide``); per-block partials summed
    in a fixed order, so two calls give bitwise-equal results.  CPU tensors:
    ``mlp_pairwise_sums_bwd_plain``."""
    if not _on_cuda("K6", ax):
        return mlp_pairwise_sums_bwd_plain(mids, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0)
    if k6_takes([ax.shape[-1]] + [W.shape[1] for W, _ in mids]):
        out = _k6_launch("K6", mids, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0)
        mlp_pairwise_sums_bwd.launches += 1
    else:
        out = _bwd_launch("K6", mids, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0)
        mlp_pairwise_sums_bwd.launches_wide += 1
    return out


def _with_m_layer(mids_m: Layers, M):
    """The collapsed head's M as one more layer with a zero bias."""
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"M must be square, got {tuple(M.shape)}")
    return [*mids_m, (M, torch.zeros(M.shape[0], dtype=M.dtype, device=M.device))]


def mlp_pairwise_sums_packed(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask):
    """K7: {value (without c), hess, s_dz0}.  CUDA tensors: the kernel; CPU
    tensors: ``mlp_pairwise_sums_packed_plain``."""
    if not _on_cuda("K7", ax):
        return mlp_pairwise_sums_packed_plain(mids_m, M, u, act_name, ax, av, ar, mask)
    out = _k7_launch("K7", mids_m, M, u, act_name, ax, av, ar, mask)
    mlp_pairwise_sums_packed.launches += 1
    return out


def _k8_launch(name, mids_m, M, u, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0, n_split=None):
    """K8: the chain padded to its plan's width, the refs split by
    ``k7_splits`` over the plan's points a block unless `n_split` is given;
    the gradients of the padded entries are dropped."""
    if tuple(u.shape) != (M.shape[0],):
        raise ValueError(f"{name}: u must be [{M.shape[0]}], got {tuple(u.shape)}")
    L = _Launch(name, _with_m_layer(mids_m, M), act_name, ax, av, ar, mask, (u, g_val, g_hess, g_dz0),
                head=(M, u))
    _check_cotangents(L, ax, g_val, g_hess, g_dz0)
    plan = k8_plan(L.widths)
    ax, av, ar, mask = ax.contiguous(), av.contiguous(), ar.contiguous(), mask.contiguous()
    g_val, g_hess, g_dz0 = g_val.contiguous(), g_hess.contiguous(), g_dz0.contiguous()
    lib = _library()
    n_layers, points = len(mids_m), plan.threads // 4
    if n_split is None:
        per_sm = ctypes.c_int(0)
        _raise(lib.k8_max_blocks(L.device, L.act, plan.width, plan.threads, n_layers,
                                 ctypes.byref(per_sm)), f"{name} occupancy query")
        n_split = k7_splits(L.nt, L.n, L.m, points, L.resident(per_sm.value))
    weights = pad_collapsed(mids_m, M, u, plan.width)[0]
    w0 = L.widths[0]
    n_blk = -(-L.n // points)
    w_partials = L.empty(n_split * L.nt * n_blk, weights.numel())
    grads = L.empty(weights.numel())
    x_partials = L.empty(n_split, 2 * L.nt * L.n * w0)
    axv_bar = L.empty(2, L.nt, L.n, w0)
    ar_partials = L.empty(n_blk, L.nt * L.m * w0)
    ar_bar = L.empty(L.nt, L.m, w0)
    _raise(_counting_sum_rows(lib, lib.k8_sums_bwd,
        L.device, L.act, plan.width, plan.threads, n_layers, w0, L.nt, L.n, L.m, n_split,
        ax.data_ptr(), av.data_ptr(), ar.data_ptr(), mask.data_ptr(), g_val.data_ptr(),
        g_hess.data_ptr(), g_dz0.data_ptr(), weights.data_ptr(), w_partials.data_ptr(),
        grads.data_ptr(), x_partials.data_ptr(), axv_bar.data_ptr(), ar_partials.data_ptr(),
        ar_bar.data_ptr(), L.stream,
    ), name)
    return (*unpad_collapsed(grads, mids_m, M, plan.width), axv_bar[0], axv_bar[1], ar_bar)


def mlp_pairwise_sums_packed_bwd(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask,
                                 g_val, g_hess, g_dz0):
    """K8: ([(Wbar, bbar)], M_bar, u_bar, ax_bar, av_bar, ar_bar).  CUDA
    tensors: the kernel (bitwise repeatable, as K6); CPU tensors:
    ``mlp_pairwise_sums_packed_bwd_plain``."""
    if not _on_cuda("K8", ax):
        return mlp_pairwise_sums_packed_bwd_plain(mids_m, M, u, act_name, ax, av, ar, mask,
                                                  g_val, g_hess, g_dz0)
    out = _k8_launch("K8", mids_m, M, u, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0)
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
    lib = _library()
    _raise(_counting_sum_rows(lib, lib.pw_sum_rows, device_index(part), part.data_ptr(), out.data_ptr(),
                              part.shape[0], part.shape[1],
                              current_stream(device_index(part))), "sum_rows")
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
    out = _k7_launch("S1 K7", mids_m, M, u, act_name, ax, av, ar, mask, n_split=1)
    s1_packed_sums.launches += 1
    return out


def s1_packed_sums_bwd(mids_m: Layers, M, u, act_name: str, ax, av, ar, mask, g_val, g_hess, g_dz0):
    """K8 with the refs unsplit (one split): S1's full-kernel check of the
    VJP.  CPU tensors: ``mlp_pairwise_sums_packed_bwd_plain``."""
    if not _on_cuda("S1", ax):
        return mlp_pairwise_sums_packed_bwd_plain(mids_m, M, u, act_name, ax, av, ar, mask,
                                                  g_val, g_hess, g_dz0)
    out = _k8_launch("S1 K8", mids_m, M, u, act_name, ax, av, ar, mask, g_val, g_hess, g_dz0, n_split=1)
    s1_packed_sums_bwd.launches += 1
    return out


S1_WRAPPERS = (s1_pair_rows, s1_m_layer, sum_rows, s1_packed_sums, s1_packed_sums_bwd)
for _fn in S1_WRAPPERS:
    _fn.launches = 0
mlp_pairwise_sums.launches = 0
mlp_pairwise_sums.launches_wide = 0
mlp_pairwise_sums_bwd.launches = 0
mlp_pairwise_sums_bwd.launches_wide = 0
mlp_pairwise_sums_packed.launches = 0
mlp_pairwise_sums_packed_bwd.launches = 0
