"""K5-K8, the CUDA pairwise kernels, against their plain PyTorch versions on
the card, with ragged n and m and masks, K7, K8, K6's k6_kernel and K5's
k5_kernel at each of their width instantiations and paddings (k6_kernel and
k5_kernel also at ragged chunks of the feature layer, k5_kernel at depths
0, 7 and 15, k6_kernel's eight lanes a pair at widths 48 and 64 at depths
0-4), a hidden-64 chain through K5's pw_fwd_kernel and a chain wider than
64 through K6's pw_bwd_kernel.  The gates repeat ``chip_smoke.py``'s.  And
the whole KMV MLP training step at the benchmark cell's configuration: warm
steps make no host-device sync, and its losses are bitwise those of the
checking ``torch.linalg`` calls.

Without a CUDA device every test skips.  On the card:

    python -m pytest -q tests/test_torch_pairwise_cuda.py

This file imports neither JAX nor the JAX package; where JAX is not
installed, add ``--noconftest`` (the conftest imports JAX).
"""

import ctypes
import json
from pathlib import Path

import pytest
import torch

from pde_inverse_torch import config as config_lib
from pde_inverse_torch import rng
from pde_inverse_torch.device import setup_precision
from pde_inverse_torch.losses import pairwise_blockwise as bw
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.registry import get_method, get_pde_instance
from pde_inverse_torch.training.trainer import Trainer
from pde_inverse_torch.models.mlp import PotentialMLP
from pde_inverse_torch.ops.cuda import pairwise as pk

pytestmark = pytest.mark.cuda

# Each output of the kernel may be at most F64_FACTOR times as far from a
# float64 run of the plain version as the float32 plain version is, plus
# F64_FLOOR; distances are relative to the output's max-abs.  Both differ
# from the float64 run only by f32 rounding in another order.
F64_FACTOR, F64_FLOOR = 8.0, 1e-6

# the KMV MLP configuration's layers after the first: hidden 20 x 8, feature 128
FULL = (20,) * 8 + (128,)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, widths, nt, n, m, seed=0, dtype=torch.float32, zero_refs=()):
    """(mids, ax, av, ar, mask, cotangents) from a seed."""
    gen = torch.Generator().manual_seed(seed)
    mids = [(torch.randn((a, b), generator=gen) / a**0.5, torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    w0 = widths[0]
    ax = torch.randn((nt, n, w0), generator=gen)
    av = torch.randn((nt, n, w0), generator=gen) * 0.7
    ar = torch.randn((nt, m, w0), generator=gen)
    mask = torch.ones(m)
    mask[list(zero_refs)] = 0.0
    cot = [torch.randn((nt, n), generator=gen), torch.randn((nt, n), generator=gen),
           torch.randn((nt, n, w0), generator=gen)]
    to = lambda t: t.to(dev, dtype)
    return ([(to(W), to(b)) for W, b in mids], to(ax), to(av), to(ar), to(mask), [to(c) for c in cot])


def _collapse(mids):
    (WF, bF) = mids[-1]
    return list(mids[:-1]), WF @ WF.T, 2.0 * (WF @ bF)


def _flat(out):
    if isinstance(out, dict):
        return [out["value"], out["hess"], out["s_dz0"]]
    res = []
    for item in out:
        if isinstance(item, list):
            res += [t for pair in item for t in pair]
        else:
            res.append(item)
    return res


def _rel(a, b, scale):
    return float((a.double() - b.double()).abs().max()) / max(scale, 1e-30)


def _gate(kernel, plain, ref):
    for k, p, r in zip(_flat(kernel), _flat(plain), _flat(ref)):
        assert k.shape == r.shape and bool(torch.isfinite(k).all())
        scale = float(r.abs().max())
        err_k, err_p = _rel(k, r, scale), _rel(p, r, scale)
        assert err_k <= F64_FACTOR * err_p + F64_FLOOR, (tuple(k.shape), err_k, err_p)


def _c_shared_bytes(lib, kernel, width, threads, n_layers, chunks=0):
    """The library's shared memory a block of `kernel`'s plan on a chain of
    n_layers hidden layers at `width`."""
    widths = [width] * (n_layers + 2)
    return lib.pw_shared_bytes(pk._KERNEL_IDS[kernel], width, threads, len(widths) - 1,
                               (ctypes.c_int * len(widths))(*widths), chunks)


def _c_max_blocks(lib, plan, widths, act=0):
    """(error, resident blocks an SM) of the library's occupancy query for
    `plan` on the chain `widths`."""
    per_sm = ctypes.c_int(0)
    err = lib.pw_max_blocks(torch.cuda.current_device(), pk._KERNEL_IDS[plan.kernel], act, plan.width,
                            plan.threads, len(widths) - 1, (ctypes.c_int * len(widths))(*widths), plan.chunks,
                            ctypes.byref(per_sm))
    return err, per_sm.value


def _calls(packed, mids, act, ax, av, ar, mask, cot):
    """(forward, backward) of K7/K8 (packed) or K5/K6, kernel and plain."""
    if packed:
        mids_m, M, u = _collapse(mids)
        return ((lambda f: f(mids_m, M, u, act, ax, av, ar, mask)),
                (lambda f: f(mids_m, M, u, act, ax, av, ar, mask, *cot)))
    return (lambda f: f(mids, act, ax, av, ar, mask)), (lambda f: f(mids, act, ax, av, ar, mask, *cot))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("nt,n,m,zero_refs", [(1, 1, 1, ()), (2, 37, 37, (3, 20)), (3, 37, 1, ()),
                                              (2, 1, 37, (0,)), (2, 300, 200, (7, 8, 199))])
def test_kernels_match_plain_versions(cuda, packed, act, nt, n, m, zero_refs):
    args = _inputs(cuda, FULL, nt, n, m, zero_refs=zero_refs)
    args64 = _inputs(cuda, FULL, nt, n, m, zero_refs=zero_refs, dtype=torch.float64)
    mids, ax, av, ar, mask, cot = args
    mids64, ax64, av64, ar64, mask64, cot64 = args64
    fwd, bwd = _calls(packed, mids, act, ax, av, ar, mask, cot)
    fwd64, bwd64 = _calls(packed, mids64, act, ax64, av64, ar64, mask64, cot64)
    names = (("mlp_pairwise_sums_packed", "mlp_pairwise_sums_packed_bwd") if packed
             else ("mlp_pairwise_sums", "mlp_pairwise_sums_bwd"))
    for name, call, call64 in ((names[0], fwd, fwd64), (names[1], bwd, bwd64)):
        kernel, plain = getattr(pk, name), getattr(pk, name + "_plain")
        _gate(call(kernel), call(plain), call64(plain))


@pytest.mark.parametrize("packed", [False, True])
def test_backward_kernels_are_bitwise_repeatable(cuda, packed):
    mids, ax, av, ar, mask, cot = _inputs(cuda, FULL, 3, 500, 400, zero_refs=(5,))
    _, bwd = _calls(packed, mids, "tanh", ax, av, ar, mask, cot)
    kernel = pk.mlp_pairwise_sums_packed_bwd if packed else pk.mlp_pairwise_sums_bwd
    a, b = _flat(bwd(kernel)), _flat(bwd(kernel))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# K7's width instantiations and padding: (widths incl. the feature layer,
# nt, n, m, masked refs).  n = 300 and 129 are not multiples of a block's 128
# points; m = 5 is fewer refs than the splits the plan would take, m = 1
# one; (20, 48) has no hidden layer after the first; w0 = 12 is padded to 20
# in registers; 20 -> 32 -> 8 -> 20 is padded to 32.
K7_CASES = [((8,) * 5 + (48,), 2, 300, 97, (3,)), ((16,) * 5 + (48,), 2, 300, 97, (3,)),
            (FULL, 2, 300, 97, (3,)), ((24,) * 5 + (48,), 2, 300, 97, (3,)),
            ((32,) * 5 + (48,), 2, 300, 97, (3,)), ((20, 32, 8, 20, 48), 2, 300, 97, (3, 50)),
            ((20,) * 4 + (48,), 3, 130, 5, ()), ((20,) * 4 + (48,), 2, 129, 1, ()),
            ((20, 48), 2, 50, 9, (2,)), ((12, 20, 20, 48), 2, 70, 33, ())]


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("widths,nt,n,m,zero_refs", K7_CASES)
def test_k7_widths_and_padding_match_the_f64_plain_version(cuda, act, widths, nt, n, m, zero_refs):
    mids, ax, av, ar, mask, _ = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs)
    mids64, ax64, av64, ar64, mask64, _ = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs,
                                                  dtype=torch.float64)
    args, args64 = _collapse(mids), _collapse(mids64)
    _gate(pk.mlp_pairwise_sums_packed(*args, act, ax, av, ar, mask),
          pk.mlp_pairwise_sums_packed_plain(*args, act, ax, av, ar, mask),
          pk.mlp_pairwise_sums_packed_plain(*args64, act, ax64, av64, ar64, mask64))


def test_k7_forward_is_bitwise_repeatable(cuda):
    mids, ax, av, ar, mask, _ = _inputs(cuda, FULL, 3, 500, 400, zero_refs=(5,))
    fwd, _ = _calls(True, mids, "tanh", ax, av, ar, mask, [])
    a, b = _flat(fwd(pk.mlp_pairwise_sums_packed)), _flat(fwd(pk.mlp_pairwise_sums_packed))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k7_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's, and two blocks of
    the main path's plan fit on an SM (the kernel's header comment)."""
    lib = pk._library()
    for width in pk.K7_WIDTHS:
        for threads, n_layers in ((128, 7), (64, 16), (32, 0)):
            assert _c_shared_bytes(lib, "k7", width, threads, n_layers) == \
                pk.k7_shared_bytes(width, threads, n_layers)
    err, per_sm = _c_max_blocks(lib, pk.plan("k7", [20] * 9), [20] * 9)
    assert err == 0 and per_sm >= 2


# K8's width instantiations and padding, as K7_CASES: n = 300 and 129 are not
# multiples of a block's 64 points (at these depths); the other cases as above,
# one hidden layer, where the head's and layer 0's rows share a row set, and 16
# hidden layers at width 32, whose plan is a block of one warp (8 points) that
# adds its sums to the accumulators without the scratch.
K8_CASES = K7_CASES + [((20, 20, 48), 2, 70, 33, (1,)), ((32,) * 17 + (48,), 2, 21, 9, (2,))]


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("widths,nt,n,m,zero_refs", K8_CASES)
def test_k8_widths_and_padding_match_the_f64_plain_version(cuda, act, widths, nt, n, m, zero_refs):
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs)
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs,
                                                      dtype=torch.float64)
    args, args64 = _collapse(mids), _collapse(mids64)
    kernel = pk.mlp_pairwise_sums_packed_bwd(*args, act, ax, av, ar, mask, *cot)
    assert all(g.shape == t.shape for pair, layer in zip(kernel[0], args[0]) for g, t in zip(pair, layer))
    _gate(kernel, pk.mlp_pairwise_sums_packed_bwd_plain(*args, act, ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_packed_bwd_plain(*args64, act, ax64, av64, ar64, mask64, *cot64))


def test_k8_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's, and the main
    path's plan (256 lanes, 64 points a block) fits on an SM."""
    lib = pk._library()
    for width in pk.K7_WIDTHS:
        for threads, n_layers in ((256, 7), (128, 7), (64, 16), (32, 16), (96, 1), (192, 0)):
            assert _c_shared_bytes(lib, "k8", width, threads, n_layers) == \
                pk.k8_shared_bytes(width, threads, n_layers)
    err, per_sm = _c_max_blocks(lib, pk.plan("k8", [20] * 9), [20] * 9)
    assert err == 0 and per_sm >= 1


def test_k8_main_path_is_bitwise_repeatable(cuda):
    """K8 at the KMV MLP's main path (7 x 2,000 x 2,000 pairs, hidden 20 x
    8: 256 lanes a block, 4 ref splits, the warps' sums added over the
    warps in a fixed order), called twice: every output bitwise equal."""
    mids, ax, av, ar, mask, cot = _inputs(cuda, FULL, 7, 2_000, 2_000, zero_refs=(5, 1_999))
    assert pk.plan("k8", [20] * 9).threads == 256
    _, bwd = _calls(True, mids, "tanh", ax, av, ar, mask, cot)
    launches = pk.mlp_pairwise_sums_packed_bwd.launches
    a, b = _flat(bwd(pk.mlp_pairwise_sums_packed_bwd)), _flat(bwd(pk.mlp_pairwise_sums_packed_bwd))
    assert pk.mlp_pairwise_sums_packed_bwd.launches == launches + 2
    assert all(bool(torch.isfinite(x).all()) and torch.equal(x, y) for x, y in zip(a, b))


# k6_kernel at each width instantiation and at feature widths whose chunks of
# `width` features end ragged (100 at 8, 24, 32; 128 at 20, 24) or in one
# padded chunk (4): (w0, hidden layers, feature width) chains
K6_CHAINS = [(h,) * 3 + (f,) for h in pk.K7_WIDTHS for f in (128, 100, 4)]


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("widths", K6_CHAINS)
def test_k6_widths_and_feature_chunks_match_the_f64_plain_version(cuda, act, widths):
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, 2, 70, 33, zero_refs=(3,))
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, widths, 2, 70, 33, zero_refs=(3,),
                                                      dtype=torch.float64)
    assert pk.choose(list(widths), "on")[1] == "k6"
    before = pk.mlp_pairwise_sums_bwd.launches
    kernel = pk.mlp_pairwise_sums_bwd(mids, act, ax, av, ar, mask, *cot)
    assert pk.mlp_pairwise_sums_bwd.launches == before + 1
    assert all(g.shape == t.shape for pair, layer in zip(kernel[0], mids) for g, t in zip(pair, layer))
    _gate(kernel, pk.mlp_pairwise_sums_bwd_plain(mids, act, ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids64, act, ax64, av64, ar64, mask64, *cot64))


@pytest.mark.parametrize("widths,nt,n,m,zero_refs", [((12, 20, 20, 100), 2, 70, 33, ()),
                                                     ((20, 32, 8, 20, 128), 2, 129, 37, (0, 36)),
                                                     ((20, 128), 3, 57, 5, (2,)),
                                                     ((20, 20, 128), 1, 1, 1, ())])
def test_k6_padding_and_depths_match_the_f64_plain_version(cuda, widths, nt, n, m, zero_refs):
    """w0 = 12 padded to 20; an unequal chain padded to 32; no hidden layer
    (the feature layer right after the first, layer 0's rows in H); one
    point and one ref."""
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs)
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs,
                                                      dtype=torch.float64)
    before = pk.mlp_pairwise_sums_bwd.launches
    _gate(pk.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids, "tanh", ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids64, "tanh", ax64, av64, ar64, mask64, *cot64))
    assert pk.mlp_pairwise_sums_bwd.launches == before + 1


def test_k6_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's, and the main
    path's plan (224 lanes, 56 points a block) fits on an SM."""
    lib = pk._library()
    for width in pk.K7_WIDTHS:
        for threads, n_layers, chunks in ((224, 7, 7), (256, 0, 1), (96, 15, 16), (32, 1, 4)):
            assert _c_shared_bytes(lib, "k6", width, threads, n_layers, chunks) == \
                pk.k6_shared_bytes(width, threads, n_layers, chunks)
    for widths in ([20] * 8 + [128], [8] * 4 + [100], [32] * 8 + [128], [24, 128]):
        plan = pk.plan("k6", widths)
        for act in range(3):
            err, per_sm = _c_max_blocks(lib, plan, widths, act)
            assert err == 0 and per_sm >= 1, (widths, act)


# a chain with a hidden width above 32: K5 through pw_fwd_kernel, K5's first
# design (64 -> 64 -> 128 is the chain of the KMV MLP at hidden 64 x 2;
# pw_fwd_kernel's tile holds up to 3 hidden 64-wide layers)
WIDE = (64, 64, 128)
# a chain with a width above 64 before the feature layer: K6 through
# pw_bwd_kernel, K6's first design, which k6_kernel does not take
WIDER = (72, 72, 16)
# a deep chain at widths 33-64 that pw_bwd_kernel's tile holds and the
# octets of k6_kernel, which pad every layer to 64, do not
DEEP = (1,) + (56,) * 6 + (8,)


@pytest.mark.parametrize("widths", [WIDER, DEEP])
def test_wide_chain_runs_pw_bwd_kernel(cuda, widths):
    assert pk.choose(list(widths), "on")[1] == "pw_bwd"
    plan, c_widths = pk.plan("pw_bwd", list(widths)), (ctypes.c_int * len(widths))(*widths)
    assert pk._library().pw_shared_bytes(pk._KERNEL_IDS["pw_bwd"], 0, plan.threads, len(widths) - 1, c_widths,
                                         0) == plan.shared_bytes == pk.shared_bytes(list(widths), 4)
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, 2, 70, 33, zero_refs=(3,))
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, widths, 2, 70, 33, zero_refs=(3,),
                                                      dtype=torch.float64)
    before = pk.mlp_pairwise_sums_bwd.launches
    kernel = pk.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *cot)
    assert pk.mlp_pairwise_sums_bwd.launches == before + 1
    _gate(kernel, pk.mlp_pairwise_sums_bwd_plain(mids, "tanh", ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids64, "tanh", ax64, av64, ar64, mask64, *cot64))
    again = pk.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *cot)
    assert all(torch.equal(x, y) for x, y in zip(_flat(kernel), _flat(again)))


def test_k6_launch_counts_are_one_a_kernel(cuda):
    """K6 runs the kernel ``choose`` gives, k6_kernel (also at widths 33-64,
    on eight lanes a pair) or pw_bwd_kernel (widths past 64), and counts
    one launch in ``.launches`` with one call of the library's sum_rows a
    partial; a CPU call counts in neither."""
    fn = pk.mlp_pairwise_sums_bwd
    for widths, kernel in (((8, 8, 4), "k6"), ((40, 40, 8), "k6"), ((32, 33, 8), "k6"), ((72, 72, 8), "pw_bwd"),
                           ((20, 65, 8), "pw_bwd")):
        assert pk.choose(list(widths), "on")[1] == kernel, widths
        mids, ax, av, ar, mask, cot = _inputs(cuda, widths, 1, 10, 9)
        before = (fn.launches, pk.sum_rows.launches)
        fn(mids, "tanh", ax, av, ar, mask, *cot)
        assert (fn.launches - before[0], pk.sum_rows.launches - before[1]) == (1, 3), widths
    cpu = lambda ts: [t.cpu() for t in ts]
    before = (fn.launches, pk.sum_rows.launches)
    fn([(W.cpu(), b.cpu()) for W, b in mids], "tanh", *cpu((ax, av, ar, mask)), *cpu(cot))
    assert (fn.launches, pk.sum_rows.launches) == before


# k6_kernel on eight lanes a pair (W = 48, 64) at depths 0-4 (hidden layers
# after the first) and feature widths in one padded chunk (4), ragged chunks
# (100; 130 at W = 64, 128 at W = 48) and whole chunks (128 at W = 64); n =
# 70 is not a multiple of a block's points, refs 3 and 32 are masked.  Where
# the plan does not fit (W = 64 with 4 hidden layers and 130 features),
# neither kernel holds the chain and the wrapper raises.
K6_OCTET_CHAINS = [(w,) * (d + 1) + (f,) for w in (48, 64) for d in range(5) for f in (4, 100, 128, 130)]


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("widths", K6_OCTET_CHAINS)
def test_k6_octets_match_the_f64_plain_version(cuda, act, widths):
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, 2, 70, 33, zero_refs=(3, 32))
    fn = pk.mlp_pairwise_sums_bwd
    if pk.choose(list(widths), "on")[1] != "k6":
        assert widths == (64,) * 5 + (130,)
        with pytest.raises(ValueError, match="shared memory"):
            fn(mids, act, ax, av, ar, mask, *cot)
        return
    assert pk.plan("k6", list(widths)).width == widths[0]
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, widths, 2, 70, 33, zero_refs=(3, 32),
                                                      dtype=torch.float64)
    before = fn.launches
    kernel = fn(mids, act, ax, av, ar, mask, *cot)
    assert fn.launches == before + 1
    assert all(g.shape == t.shape for pair, layer in zip(kernel[0], mids) for g, t in zip(pair, layer))
    _gate(kernel, pk.mlp_pairwise_sums_bwd_plain(mids, act, ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids64, act, ax64, av64, ar64, mask64, *cot64))


@pytest.mark.parametrize("widths,nt,n,m,zero_refs", [((40, 33, 130), 2, 129, 37, (0, 36)),
                                                     ((50, 64, 40, 64, 4), 3, 57, 5, (2,)),
                                                     ((64, 64, 128), 1, 1, 1, ()),
                                                     ((2, 64, 64, 64, 128), 2, 33, 9, (4,))])
def test_k6_octet_padding_matches_the_f64_plain_version(cuda, widths, nt, n, m, zero_refs):
    """An unequal chain padded to 48 and one padded to 64 (one hidden layer
    past the first with 4 features: one padded chunk); one point and one
    ref; w0 = 2 padded to 64 before three hidden layers (64 lanes a block)."""
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs)
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs,
                                                      dtype=torch.float64)
    before = pk.mlp_pairwise_sums_bwd.launches
    _gate(pk.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids, "tanh", ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_bwd_plain(mids64, "tanh", ax64, av64, ar64, mask64, *cot64))
    assert pk.mlp_pairwise_sums_bwd.launches == before + 1


@pytest.mark.parametrize("widths", [WIDE, (48, 48, 48, 100)])
def test_k6_octets_are_bitwise_repeatable_and_masked_refs_add_exactly_zero(cuda, widths):
    """Two calls are bitwise equal; with refs 5 and 9 of 37 masked, the ax,
    av and ar cotangents equal those over the 35 others, bit for bit.  30
    points fit one block of 32, so that the splits (``k7_splits``) give every
    ref its own, as ``test_masked_refs_add_exactly_zero``'s shape does, and
    the 37 or 35 split rows of ax and av add in row order.  The weight
    gradients' 74 and 70 block rows add in chunks of 64 (``sum_rows``), which
    group the refs differently, as in that test, which holds the backward
    kernels' ar rows alone."""
    mids, ax, av, ar, mask, cot = _inputs(cuda, widths, 2, 30, 37, zero_refs=(5, 9))
    fn = pk.mlp_pairwise_sums_bwd
    a, b = _flat(fn(mids, "tanh", ax, av, ar, mask, *cot)), _flat(fn(mids, "tanh", ax, av, ar, mask, *cot))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    keep = [j for j in range(37) if j not in (5, 9)]
    full = fn(mids, "tanh", ax, av, ar, mask, *cot)
    kept = fn(mids, "tanh", ax, av, ar[:, keep].contiguous(), mask[keep], *cot)
    assert torch.equal(full[1], kept[1]) and torch.equal(full[2], kept[2])
    assert torch.equal(full[-1][:, keep], kept[-1]) and not bool(full[-1][:, [5, 9]].any())


def test_k6_octet_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's at W = 48 and 64,
    and the plans of the hidden-64 chains (256 lanes at 64 -> 64 -> 128, 160
    at 64 x 3 -> 128, 64 and 32 deeper) fit on an SM for every activation."""
    lib = pk._library()
    for width in (48, 64):
        for threads, n_layers, chunks in ((256, 1, 2), (160, 2, 2), (64, 3, 2), (32, 4, 2), (256, 0, 1),
                                          (96, 2, 3)):
            assert _c_shared_bytes(lib, "k6", width, threads, n_layers, chunks) == \
                pk.k6_shared_bytes(width, threads, n_layers, chunks)
    for widths, threads in (([64, 64, 128], 256), ([64] * 3 + [128], 160), ([64] * 4 + [128], 64),
                            ([64] * 5 + [128], 32), ([48, 48, 100], 256)):
        plan = pk.plan("k6", widths)
        assert plan.threads == threads and plan.points == threads // 8
        for act in range(3):
            err, per_sm = _c_max_blocks(lib, plan, widths, act)
            assert err == 0 and per_sm >= 1, (widths, act)


# k5_kernel at each width instantiation and depth (0, 7 and 15 hidden layers
# after the first) and at feature widths in one chunk of 4 (4), in whole
# chunks (100, 128) and padded to whole chunks (130 -> 132); n = 130 is not
# a multiple of a block's points, refs 3 and 32 are masked
K5_CHAINS = [(w,) * (d + 1) + (f,) for w in pk.K7_WIDTHS for d in (0, 7, 15) for f in (4, 100, 128, 130)]


def _k5_gate(cuda, widths, act, nt, n, m, zero_refs):
    """K5 through k5_kernel (as ``choose`` gives, one launch in
    ``.launches``) against the f64 plain version."""
    assert pk.choose(list(widths), "on")[0] == "k5"
    mids, ax, av, ar, mask, _ = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs)
    mids64, ax64, av64, ar64, mask64, _ = _inputs(cuda, widths, nt, n, m, zero_refs=zero_refs,
                                                  dtype=torch.float64)
    fn = pk.mlp_pairwise_sums
    before = fn.launches
    kernel = fn(mids, act, ax, av, ar, mask)
    assert fn.launches == before + 1
    _gate(kernel, pk.mlp_pairwise_sums_plain(mids, act, ax, av, ar, mask),
          pk.mlp_pairwise_sums_plain(mids64, act, ax64, av64, ar64, mask64))


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("widths", K5_CHAINS)
def test_k5_widths_depths_and_feature_chunks_match_the_f64_plain_version(cuda, act, widths):
    _k5_gate(cuda, widths, act, 2, 130, 33, (3, 32))


@pytest.mark.parametrize("widths,nt,n,m,zero_refs", [((12, 20, 20, 100), 2, 70, 33, ()),
                                                     ((20, 32, 8, 20, 128), 2, 129, 37, (0, 36)),
                                                     ((20, 128), 3, 57, 5, (2,)),
                                                     ((20,) * 4 + (48,), 2, 129, 1, ()),
                                                     ((20, 20, 128), 1, 1, 1, ())])
def test_k5_padding_and_depths_match_the_f64_plain_version(cuda, widths, nt, n, m, zero_refs):
    """w0 = 12 padded to 20 in registers; an unequal chain padded to 32; no
    hidden layer (the feature layer right after the first); a ragged n
    against one ref; one point and one ref."""
    _k5_gate(cuda, widths, "tanh", nt, n, m, zero_refs)


def test_k5_forward_is_bitwise_repeatable(cuda):
    mids, ax, av, ar, mask, _ = _inputs(cuda, FULL, 3, 500, 400, zero_refs=(5,))
    a = _flat(pk.mlp_pairwise_sums(mids, "tanh", ax, av, ar, mask))
    b = _flat(pk.mlp_pairwise_sums(mids, "tanh", ax, av, ar, mask))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k5_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's, and two blocks of
    the main path's plan (128 points, 104,432 B) fit on an SM for every
    activation, as the kernel's header comment says."""
    lib = pk._library()
    for width in pk.K7_WIDTHS:
        for threads, n_layers, chunks in ((128, 7, 32), (64, 15, 33), (32, 0, 1), (128, 1, 25)):
            assert _c_shared_bytes(lib, "k5", width, threads, n_layers, chunks) == \
                pk.k5_shared_bytes(width, threads, n_layers, chunks)
    plan = pk.plan("k5", list(FULL))
    for act in range(3):
        err, per_sm = _c_max_blocks(lib, plan, list(FULL), act)
        assert err == 0 and per_sm >= 2, act
    for widths in ([8] * 4 + [100], [32] * 16 + [130], [24, 4]):
        err, per_sm = _c_max_blocks(lib, pk.plan("k5", widths), widths)
        assert err == 0 and per_sm >= 1, widths


def test_wide_chain_runs_pw_fwd_kernel(cuda):
    """A hidden width above 32 takes pw_fwd_kernel (``choose``); it holds to
    the f64 plain version and repeats bitwise."""
    assert pk.choose(list(WIDE), "on")[0] == "pw_fwd"
    plan, c_widths = pk.plan("pw_fwd", list(WIDE)), (ctypes.c_int * 3)(*WIDE)
    assert pk._library().pw_shared_bytes(pk._KERNEL_IDS["pw_fwd"], 0, plan.threads, 2, c_widths, 0) == \
        plan.shared_bytes == pk.shared_bytes(list(WIDE), 3)
    mids, ax, av, ar, mask, _ = _inputs(cuda, WIDE, 2, 70, 33, zero_refs=(3,))
    mids64, ax64, av64, ar64, mask64, _ = _inputs(cuda, WIDE, 2, 70, 33, zero_refs=(3,), dtype=torch.float64)
    fn = pk.mlp_pairwise_sums
    before = fn.launches
    kernel = fn(mids, "tanh", ax, av, ar, mask)
    assert fn.launches == before + 1
    _gate(kernel, pk.mlp_pairwise_sums_plain(mids, "tanh", ax, av, ar, mask),
          pk.mlp_pairwise_sums_plain(mids64, "tanh", ax64, av64, ar64, mask64))
    again = fn(mids, "tanh", ax, av, ar, mask)
    assert all(torch.equal(x, y) for x, y in zip(_flat(kernel), _flat(again)))


def test_k5_launch_counts_are_one_a_kernel(cuda):
    """K5 runs the kernel ``choose`` gives, k5_kernel or pw_fwd_kernel, and
    counts one launch in ``.launches`` with one of the library's sum_rows;
    a CPU call counts in neither."""
    fn = pk.mlp_pairwise_sums
    for widths, kernel in (((8, 8, 4), "k5"), ((40, 40, 8), "pw_fwd"), ((32, 33, 8), "pw_fwd"),
                           ((32, 130), "k5")):
        assert pk.choose(list(widths), "on")[0] == kernel, widths
        mids, ax, av, ar, mask, _ = _inputs(cuda, widths, 1, 10, 9)
        before = (fn.launches, pk.sum_rows.launches)
        fn(mids, "tanh", ax, av, ar, mask)
        assert (fn.launches - before[0], pk.sum_rows.launches - before[1]) == (1, 1), widths
    before = (fn.launches, pk.sum_rows.launches)
    fn([(W.cpu(), b.cpu()) for W, b in mids], "tanh", ax.cpu(), av.cpu(), ar.cpu(), mask.cpu())
    assert (fn.launches, pk.sum_rows.launches) == before


def test_s1_packed_sums_bwd_runs_k8_with_one_split(cuda):
    mids, ax, av, ar, mask, cot = _inputs(cuda, FULL, 2, 70, 33, zero_refs=(4,))
    mids64, ax64, av64, ar64, mask64, cot64 = _inputs(cuda, FULL, 2, 70, 33, zero_refs=(4,),
                                                      dtype=torch.float64)
    args, args64 = _collapse(mids), _collapse(mids64)
    before = pk.s1_packed_sums_bwd.launches
    out = pk.s1_packed_sums_bwd(*args, "tanh", ax, av, ar, mask, *cot)
    assert pk.s1_packed_sums_bwd.launches == before + 1
    _gate(out, pk.mlp_pairwise_sums_packed_bwd_plain(*args, "tanh", ax, av, ar, mask, *cot),
          pk.mlp_pairwise_sums_packed_bwd_plain(*args64, "tanh", ax64, av64, ar64, mask64, *cot64))


def test_masked_refs_add_exactly_zero(cuda):
    """Refs with mask 0 change no output by a single bit: the sums over 37
    refs with refs 5 and 9 masked equal those over the 35 others."""
    mids, ax, av, ar, mask, cot = _inputs(cuda, FULL, 2, 40, 37, zero_refs=(5, 9))
    keep = [j for j in range(37) if j not in (5, 9)]
    for packed in (False, True):
        fwd, bwd = _calls(packed, mids, "tanh", ax, av, ar, mask, cot)
        fwd_k, bwd_k = _calls(packed, mids, "tanh", ax, av, ar[:, keep].contiguous(), mask[keep], cot)
        f_name = "mlp_pairwise_sums_packed" if packed else "mlp_pairwise_sums"
        for x, y in zip(_flat(fwd(getattr(pk, f_name))), _flat(fwd_k(getattr(pk, f_name)))):
            assert torch.equal(x, y)
        full, kept = bwd(getattr(pk, f_name + "_bwd")), bwd_k(getattr(pk, f_name + "_bwd"))
        assert torch.equal(full[-1][:, keep], kept[-1]) and not bool(full[-1][:, [5, 9]].any())


def test_launch_counters_count_kernel_launches_only(cuda):
    mids, ax, av, ar, mask, cot = _inputs(cuda, (8, 8, 4), 1, 10, 9)
    names = ("mlp_pairwise_sums", "mlp_pairwise_sums_bwd", "mlp_pairwise_sums_packed",
             "mlp_pairwise_sums_packed_bwd")
    before = [getattr(pk, n).launches for n in names]
    for packed in (False, True):
        fwd, bwd = _calls(packed, mids, "tanh", ax, av, ar, mask, cot)
        f_name = "mlp_pairwise_sums_packed" if packed else "mlp_pairwise_sums"
        fwd(getattr(pk, f_name))
        bwd(getattr(pk, f_name + "_bwd"))
    cpu = [(W.cpu(), b.cpu()) for W, b in mids]
    pk.mlp_pairwise_sums(cpu, "tanh", ax.cpu(), av.cpu(), ar.cpu(), mask.cpu())
    assert [getattr(pk, n).launches for n in names] == [b + 1 for b in before]


@pytest.mark.parametrize("mode", ["on", "fwd", "packed", "auto"])
def test_stats_on_the_card_match_the_cpu(cuda, mode):
    gen = torch.Generator().manual_seed(3)
    model = PotentialMLP(2, [20] * 8, feature_dim=128, quadratic_head=True, generator=gen)
    params = {k: p.detach() for k, p in model.named_parameters()}
    x, v, refs = (torch.randn((60, 3, 2), generator=gen) for _ in range(3))

    def grad(p, m, *xs):  # torch.autograd, as the KMV loss takes it
        leaves = {k: t.detach().requires_grad_() for k, t in p.items()}
        s = bw.mlp_pairwise_stats(model, leaves, *xs, pallas_mode=m)
        scal = torch.sum(torch.sin(s["value"])) + torch.sum(s["nabla"] ** 2) + torch.sum(torch.cos(s["hess"]))
        return dict(zip(leaves, torch.autograd.grad(scal, list(leaves.values()))))

    g_cpu = grad(params, "off", x, v, refs)
    g_gpu = grad({k: t.to(cuda) for k, t in params.items()}, mode, x.to(cuda), v.to(cuda), refs.to(cuda))
    for k, g in g_cpu.items():
        assert _rel(g_gpu[k].cpu(), g, float(g.abs().max())) < 3e-4, k


def test_wrappers_check_their_inputs(cuda):
    mids, ax, av, ar, mask, cot = _inputs(cuda, (8, 8, 4), 2, 10, 9)
    with pytest.raises(ValueError, match="float32"):
        pk.mlp_pairwise_sums(mids, "tanh", ax.double(), av, ar, mask)
    with pytest.raises(ValueError, match="chain"):
        pk.mlp_pairwise_sums([mids[1], mids[0]], "tanh", ax, av, ar, mask)
    with pytest.raises(ValueError, match="derivative table"):
        pk.mlp_pairwise_sums(mids, "gelu", ax, av, ar, mask)
    with pytest.raises(ValueError, match="mask"):
        pk.mlp_pairwise_sums(mids, "tanh", ax, av, ar, mask[:5])
    with pytest.raises(ValueError, match="shared memory"):  # k5_kernel: W_F alone is 288 KB
        pk.mlp_pairwise_sums([(torch.zeros((8, 8192), device=cuda), torch.zeros(8192, device=cuda))],
                             "tanh", ax, av, ar, mask)
    with pytest.raises(ValueError, match="shared memory"):  # pw_fwd_kernel
        pk.mlp_pairwise_sums([(torch.zeros((8, 64), device=cuda), torch.zeros(64, device=cuda)),
                              (torch.zeros((64, 4096), device=cuda), torch.zeros(4096, device=cuda))],
                             "tanh", ax, av, ar, mask)
    with pytest.raises(ValueError, match="shared memory"):  # past k6_kernel's octets and pw_bwd_kernel's tile
        wide = [(torch.zeros((8, 64), device=cuda), torch.zeros(64, device=cuda))] + \
            [(torch.zeros((64, 64), device=cuda), torch.zeros(64, device=cuda))] * 5 + \
            [(torch.zeros((64, 128), device=cuda), torch.zeros(128, device=cuda))]
        pk.mlp_pairwise_sums_bwd(wide, "tanh", ax, av, ar, mask, *cot)
    with pytest.raises(ValueError, match="cotangents"):
        pk.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, cot[0][:, :5], *cot[1:])


BENCH = Path(__file__).resolve().parents[1] / "benchmark"


def _kmv_cell_trainer(dev, seed: int) -> Trainer:
    """A Trainer of the benchmark cell kmv-mlp.pairs28m (its configuration
    and traffic files), built as ``pde_inverse_torch.main.run`` builds it."""
    spec = json.loads((BENCH / "configs" / "kmv-mlp.json").read_text())
    traffic = json.loads((BENCH / "workloads" / "kmv-mlp.pairs28m.json").read_text())["traffic"]
    cfg = config_lib.preset(spec["preset"], [*spec["overrides"], *(f"{k}={v}" for k, v in traffic.items()),
                                             f"seed={seed}"])
    setup_precision()
    key_problem, key_method, key_trainer, _ = rng.split(cfg.seed, 4)
    inst = get_pde_instance(cfg)(cfg, key_problem, dev)
    method = get_method(cfg)(inst, cfg, key_method, dev)
    model, params = method.create_model_fn()
    return Trainer(cfg, method, key_trainer, functional_forward(model), params)


def _steps(trainer: Trainer, steps):
    """(stacked [loss, grad_norm] of each step, parameters after them) from
    the trainer's initial parameters and a fresh optimizer state."""
    params = trainer.params
    opt_state = trainer.optimizer.init(params)
    ema = {k: torch.zeros_like(v) for k, v in params.items()}
    seen = []
    for s in steps:
        params, opt_state, ema, out = trainer._step(params, opt_state, ema, s)
        seen.append(torch.stack([out["loss"], out["grad_norm"]]))
    return torch.stack(seen), params


def test_kmv_mlp_steps_make_no_host_sync(cuda, monkeypatch):
    """After warm-up, two more steps under ``set_sync_debug_mode("error")``
    raise nothing; the first 3 steps' losses, gradient norms and the
    parameters after them are bitwise those of the same steps with each
    ``torch.linalg.*_ex`` call made the checking variant."""
    trainer = _kmv_cell_trainer(cuda, 2147483659)
    got, params = _steps(trainer, range(3))  # builds K7/K8 and warms every shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _steps(trainer, range(3, 5))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for name in ("cholesky", "solve", "inv"):
        def ex(*args, _checked=getattr(torch.linalg, name), **kwargs):
            out = _checked(*args, **kwargs)
            return out, torch.zeros(out.shape[:-2], dtype=torch.int32, device=out.device)

        monkeypatch.setattr(torch.linalg, f"{name}_ex", ex)
    want, want_params = _steps(trainer, range(3))
    assert torch.equal(got, want)
    for k, p in params.items():
        assert torch.equal(p, want_params[k]), k
