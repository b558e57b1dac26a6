"""K3 and K4, the CUDA pointwise kernels, and K9 and K10, the Fourier front
end's, against their plain PyTorch versions on the card, at small and
full-width shapes.  The gates repeat ``chip_smoke.py``'s.

Without a CUDA device every test skips.  On the card:

    python -m pytest -q tests/test_torch_pointwise_cuda.py

This file imports neither JAX nor the JAX package; where JAX is not
installed, add ``--noconftest`` (the conftest imports JAX).
"""

import ctypes

import pytest
import torch

from pde_inverse_torch.losses import fused_pointwise as fp
from pde_inverse_torch.models.mlp import PotentialMLP
from pde_inverse_torch.ops.cuda import pointwise as pt
from pde_inverse_torch.ops.cuda.pointwise import (
    front_streams,
    front_streams_bwd,
    front_streams_bwd_plain,
    front_streams_plain,
    mlp_grad_quad,
    mlp_grad_quad_bwd,
    mlp_grad_quad_bwd_plain,
    mlp_grad_quad_plain,
)

pytestmark = pytest.mark.cuda

# Each output of the kernel may be at most F64_FACTOR times as far from a
# float64 run of the plain version as the float32 plain version is, plus
# F64_FLOOR; distances are relative to the output's max-abs.  Both differ
# from the float64 run only by f32 rounding in another order (FMA in the
# kernel, blocked sums in cuBLAS).
F64_FACTOR, F64_FLOOR = 8.0, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, widths, n, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    mids = [((torch.randn((a, b), generator=gen) / a**0.5), torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    streams = [torch.randn((n, widths[0]), generator=gen) * s for s in (1.0, 0.7, 0.3)]
    cot = (torch.randn(n, generator=gen), torch.randn((n, widths[0]), generator=gen))
    to = lambda t: t.to(dev, dtype)
    return [(to(W), to(b)) for W, b in mids], [to(s) for s in streams], [to(c) for c in cot]


def _flat(out):
    """K3 (quad, delta), K4 (mids_bar, a, b, c), K9 (five tensors) or K10
    (three) -> list of tensors."""
    if len(out) != 4:
        return list(out)
    return [t for pair in out[0] for t in pair] + list(out[1:])


def _rel(a, b, scale):
    return float((a.double() - b.double()).abs().max()) / max(scale, 1e-30)


def _gate(kernel, plain, ref):
    for k, p, r in zip(_flat(kernel), _flat(plain), _flat(ref)):
        assert k.shape == r.shape and bool(torch.isfinite(k).all())
        scale = float(r.abs().max())
        err_k, err_p = _rel(k, r, scale), _rel(p, r, scale)
        assert err_k <= F64_FACTOR * err_p + F64_FLOOR, (tuple(k.shape), err_k, err_p)


FULL = (64, 64, 256)  # the KGMM-nonparametric-online preset's layers after the first
OFFLINE = (32, 32, 128)  # the KGMM-nonparametric preset's


# n on both sides of a boundary of K3's and K4's tile (32 points at the full
# width, 64 at the narrower preset's); a one-layer chain; a deep chain; chains
# the wrapper pads to multiples of 8
@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("widths,n", [(FULL, 1), (FULL, 37), (FULL, 4099), ((8, 8, 4), 29),
                                      ((20,) * 8 + (128,), 300), ((5, 7, 3), 50),
                                      (OFFLINE, 4_097), (OFFLINE, 63), (OFFLINE, 64), (OFFLINE, 65), ((64, 256), 33),
                                      (FULL, 31), (FULL, 32), (FULL, 33), (FULL, 20_000),
                                      ((16,) * 13, 41), ((6, 100), 70)])
def test_kernels_match_plain_versions(cuda, act, widths, n):
    mids, streams, cot = _inputs(cuda, widths, n)
    mids64, streams64, cot64 = _inputs(cuda, widths, n, dtype=torch.float64)
    _gate(mlp_grad_quad(mids, act, *streams), mlp_grad_quad_plain(mids, act, *streams),
          mlp_grad_quad_plain(mids64, act, *streams64))
    _gate(mlp_grad_quad_bwd(mids, act, *streams, *cot),
          mlp_grad_quad_bwd_plain(mids, act, *streams, *cot),
          mlp_grad_quad_bwd_plain(mids64, act, *streams64, *cot64))


def test_k4_takes_a_chain_of_16_layers(cuda):
    """16 layers of 64 leave K4 a tile of 8 points and no room for its sums,
    which it then keeps in its row of the partials in device memory (K3
    takes the chain too: test_k3_takes_a_chain_of_16_layers)."""
    widths = (64,) * 17
    assert pt.k4_plan(widths)[1:4] == (8, 64, False)
    mids, streams, cot = _inputs(cuda, widths, 19)
    mids64, streams64, cot64 = _inputs(cuda, widths, 19, dtype=torch.float64)
    _gate(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot),
          mlp_grad_quad_bwd_plain(mids, "tanh", *streams, *cot),
          mlp_grad_quad_bwd_plain(mids64, "tanh", *streams64, *cot64))


@pytest.mark.parametrize("act", ["tanh", "softplus"])
@pytest.mark.parametrize("n", [15, 16, 17, 4_099])
def test_k3_takes_a_chain_of_16_layers(cuda, act, n):
    """16 layers of 64 keep 1,024 rows of pre-activations: K3 takes them at a
    16-point tile, two blocks an SM; n on both sides of the tile."""
    widths = (64,) * 17
    assert pt.k3_plan(widths)[1:4] == (16, 64, 2)
    mids, streams, _ = _inputs(cuda, widths, n)
    mids64, streams64, _ = _inputs(cuda, widths, n, dtype=torch.float64)
    _gate(mlp_grad_quad(mids, act, *streams), mlp_grad_quad_plain(mids, act, *streams),
          mlp_grad_quad_plain(mids64, act, *streams64))


@pytest.mark.parametrize("widths,n", [(FULL, 20_011), (OFFLINE, 4_097), ((5, 7, 3), 50)])
def test_k3_is_bitwise_repeatable(cuda, widths, n):
    mids, streams, _ = _inputs(cuda, widths, n)
    a = mlp_grad_quad(mids, "tanh", *streams)
    b = mlp_grad_quad(mids, "tanh", *streams)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k3_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's for every tile at
    every chain the tests and the presets use, the kernel refuses a chain
    that is not padded, and as many blocks as the plan counts on are
    resident on an SM, for each activation."""
    lib = pt._library()
    chains = [FULL, OFFLINE, (20,) * 8 + (128,), (8, 8, 4), (5, 7, 3), (64,) * 17, (64, 256),
              (16,) * 13, (6, 100), (8, 4096)]
    for widths in chains:
        plan = pt.k3_plan(widths)
        c_widths = (ctypes.c_int * len(plan.widths))(*plan.widths)
        for tile in pt.K3_TILES:
            assert lib.k3_shared_bytes_c(len(widths) - 1, c_widths, tile, plan.chunk) == \
                pt.k3_shared_bytes(plan.widths, tile, plan.chunk)
        assert lib.k3_shared_bytes_c(len(widths) - 1, c_widths, plan.tile, plan.chunk) == plan.shared_bytes
    assert lib.k3_shared_bytes_c(2, (ctypes.c_int * 3)(5, 7, 3), 32, 8) == -1
    assert lib.k3_shared_bytes_c(2, (ctypes.c_int * 3)(64, 64, 256), 24, 64) == -1
    for widths in (FULL, OFFLINE, (64,) * 17):
        plan = pt.k3_plan(widths)
        for act in range(3):
            per_sm = ctypes.c_int(0)
            assert lib.k3_max_blocks(torch.cuda.current_device(), act, plan.shared_bytes,
                                     ctypes.byref(per_sm)) == 0
            assert per_sm.value == plan.blocks_per_sm, (widths, act, per_sm.value)


def test_k4_is_bitwise_repeatable(cuda):
    mids, streams, cot = _inputs(cuda, FULL, 20_011)
    a = _flat(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot))
    b = _flat(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k4_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory count is the kernel's for every plan the
    tests and the presets use, the kernel refuses a chain that is not padded,
    and a block of the full-width plan is resident on an SM."""
    lib = pt._library()
    chains = [FULL, OFFLINE, (20,) * 8 + (128,), (8, 8, 4), (5, 7, 3), (64,) * 17, (64, 256),
              (16,) * 13, (6, 100)]
    for widths in chains:
        plan = pt.k4_plan(widths)
        c_widths = (ctypes.c_int * len(plan.widths))(*plan.widths)
        for tile in pt.K4_TILES:
            for acc_shared in (True, False):
                want = pt.k4_shared_bytes(plan.widths, tile, plan.chunk, acc_shared)
                if (tile // 4) * (plan.widths[-2] // 4) > pt.K4_THREADS // 2:
                    want = -1
                assert lib.k4_shared_bytes_c(len(widths) - 1, c_widths, tile, plan.chunk,
                                             int(acc_shared)) == want
    assert lib.k4_shared_bytes_c(2, (ctypes.c_int * 3)(5, 7, 3), 32, 8, 1) == -1
    plan = pt.k4_plan(FULL)
    per_sm = ctypes.c_int(0)
    assert lib.k4_max_blocks(torch.cuda.current_device(), 0, plan.shared_bytes, ctypes.byref(per_sm)) == 0
    assert per_sm.value >= 1


FRONT = (4, 64, 64)  # the presets' (d, F, w0)


def _front_inputs(dev, n, seed=0, dtype=torch.float32, shape=FRONT, batch=False):
    """(x, v, B, W0, b0) and the cotangents of K9's five outputs, as the KGMM
    path draws them: |p| reaches tens.  With `batch`, x and v are the halves
    of one [n, 2d] batch (rows of stride 2d), as the loss passes them."""
    d, nf, w0 = shape
    gen = torch.Generator().manual_seed(seed)
    xv = torch.randn((n, 2 * d), generator=gen) * torch.tensor([2.0] * d + [0.32] * d)
    B = torch.randn((d, nf), generator=gen)
    W0 = torch.randn((d + 2 * nf, w0), generator=gen) / (d + 2 * nf) ** 0.5
    b0 = torch.randn(w0, generator=gen) * 0.1
    bars = [torch.randn((n, w), generator=gen) for w in (w0, w0, w0, nf, nf)]
    to = lambda t: t.to(dev, dtype)
    xv = to(xv)
    x, v = (xv[:, :d], xv[:, d:]) if batch else (xv[:, :d].contiguous(), xv[:, d:].contiguous())
    return (x, v, to(B), to(W0), to(b0)), [to(t) for t in bars]


# n on both sides of a tile (32 points) and of one pass of K10's persistent
# blocks, a point alone, and the loss's strided halves of a batch
@pytest.mark.parametrize("n,batch", [(1, False), (31, False), (32, False), (33, True), (4_099, False),
                                     (20_011, True), (250_000, True)])
def test_front_kernels_match_plain_versions(cuda, n, batch):
    args, bars = _front_inputs(cuda, n, batch=batch)
    args64, bars64 = _front_inputs(cuda, n, dtype=torch.float64)
    _gate(front_streams(*args), front_streams_plain(*args), front_streams_plain(*args64))
    _gate(front_streams_bwd(*args[:4], *bars), front_streams_bwd_plain(*args[:4], *bars),
          front_streams_bwd_plain(*args64[:4], *bars64))


def test_front_kernels_are_bitwise_repeatable(cuda):
    args, bars = _front_inputs(cuda, 20_011, batch=True)
    for fn, a in ((front_streams, args), (front_streams_bwd, (*args[:4], *bars))):
        first, again = fn(*a), fn(*a)
        assert all(torch.equal(p, q) for p, q in zip(first, again))


def test_front_padded_points_do_not_leak(cuda):
    """K10's gradients of n = 33 points (a ragged last tile) equal, bit for
    bit, those of the same points followed by 15 other points with zero
    cotangents, as the kernel's own padding adds exactly zero."""
    args, bars = _front_inputs(cuda, 33)
    extra, _ = _front_inputs(cuda, 15, seed=1)
    grow = lambda t, e: torch.cat([t, e])
    zero_pad = lambda t: torch.cat([t, torch.zeros((15,) + t.shape[1:], device=cuda)])
    want = front_streams_bwd(*args[:4], *bars)
    got = front_streams_bwd(grow(args[0], extra[0]), grow(args[1], extra[1]), *args[2:4],
                            *(zero_pad(t) for t in bars))
    assert all(torch.equal(p, q) for p, q in zip(want, got))


def test_front_shapes_match_the_kernel(cuda):
    """Two K10 blocks (the grid the wrapper sizes) are resident on an SM at
    the instantiated shape, and the C side refuses any other."""
    lib = pt._library()
    for shape in [FRONT, (2, 64, 64), (4, 32, 64), (4, 64, 32)]:
        per_sm = ctypes.c_int(0)
        err = lib.k10_max_blocks(torch.cuda.current_device(), *shape, ctypes.byref(per_sm))
        assert (err == 0) == pt.front_fits(*shape), (shape, err)
        if err == 0:
            assert per_sm.value == 2


def test_front_counters_count_kernel_launches_only(cuda):
    args, bars = _front_inputs(cuda, 10)
    before = (front_streams.launches, front_streams_bwd.launches)
    front_streams(*args)
    front_streams_bwd(*args[:4], *bars)
    front_streams(*(t.cpu() for t in args))
    front_streams_bwd(*(t.cpu() for t in args[:4]), *(t.cpu() for t in bars))
    assert (front_streams.launches, front_streams_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_padded_points_do_not_leak(cuda):
    """The weight gradients of n = 33 points (a ragged last tile) equal, bit
    for bit, those of the same points followed by 15 points with other
    streams and zero cotangents: such points, like the kernel's padding,
    add exactly zero."""
    mids, streams, (gq, gd) = _inputs(cuda, FULL, 33)
    _, extra, _ = _inputs(cuda, FULL, 15, seed=1)
    zero_pad = lambda t: torch.cat([t, torch.zeros((15,) + t.shape[1:], device=cuda)])
    bars = mlp_grad_quad_bwd(mids, "tanh", *streams, gq, gd)[0]
    padded = mlp_grad_quad_bwd(mids, "tanh", *(torch.cat([s, e]) for s, e in zip(streams, extra)),
                               zero_pad(gq), zero_pad(gd))[0]
    for (w, b), (wp, bp) in zip(bars, padded):
        assert torch.equal(w, wp) and torch.equal(b, bp)


def test_launch_counters_count_kernel_launches_only(cuda):
    mids, streams, cot = _inputs(cuda, (8, 8, 4), 10)
    before = (mlp_grad_quad.launches, mlp_grad_quad_bwd.launches)
    mlp_grad_quad(mids, "tanh", *streams)
    mlp_grad_quad_bwd(mids, "tanh", *streams, *cot)
    cpu = lambda xs: [t.cpu() for t in xs]
    mlp_grad_quad([(W.cpu(), b.cpu()) for W, b in mids], "tanh", *cpu(streams))
    assert (mlp_grad_quad.launches, mlp_grad_quad_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("mode", ["on", "fwd", "auto"])
def test_provider_on_the_card_matches_the_cpu(cuda, mode):
    gen = torch.Generator().manual_seed(3)
    model = PotentialMLP(4, [64, 64], feature_dim=256, fourier_features=64, quadratic_head=True,
                         generator=gen)
    params = {k: p.detach() for k, p in model.named_parameters()}
    x, v = torch.randn((2_000, 4), generator=gen), torch.randn((2_000, 4), generator=gen)

    def loss(p, xx, vv, m):
        nab, quad = fp.grad_and_quadform(model, p, xx, vv, mode=m)
        return torch.mean(torch.sum(nab**2, -1)) - 2.0 * torch.mean(quad)

    def grad(p, xx, vv, m):  # torch.autograd, as the loss takes it
        leaves = {k: t.detach().requires_grad_() for k, t in p.items()}
        return dict(zip(leaves, torch.autograd.grad(loss(leaves, xx, vv, m), list(leaves.values()))))

    g_cpu = grad(params, x, v, "xla")
    counts = lambda: (mlp_grad_quad.launches, mlp_grad_quad_bwd.launches, front_streams.launches,
                      front_streams_bwd.launches)
    before = counts()
    g_gpu = grad({k: t.to(cuda) for k, t in params.items()}, x.to(cuda), v.to(cuda), mode)
    # K3 and K9 in every mode, K4 and K10 but under "fwd"
    assert counts() == tuple(b + k for b, k in zip(before, (1, mode != "fwd", 1, mode != "fwd")))
    for k, g in g_cpu.items():
        assert _rel(g_gpu[k].cpu(), g, float(g.abs().max())) < 3e-4, k


def test_wrappers_check_their_inputs(cuda):
    mids, streams, cot = _inputs(cuda, (8, 8, 4), 10)
    with pytest.raises(ValueError, match="float32"):
        mlp_grad_quad(mids, "tanh", streams[0].double(), *streams[1:])
    with pytest.raises(ValueError, match="chain"):
        mlp_grad_quad([mids[1], mids[0]], "tanh", *streams)
    with pytest.raises(ValueError, match="derivative table"):
        mlp_grad_quad(mids, "gelu", *streams)
    with pytest.raises(ValueError, match="shared memory"):  # a 4096-wide hidden layer fits no tile
        mlp_grad_quad([(torch.zeros((8, 4096), device=cuda), torch.zeros(4096, device=cuda)),
                       (torch.zeros((4096, 4), device=cuda), torch.zeros(4, device=cuda))],
                      "tanh", *streams)
    with pytest.raises(ValueError, match="g_quad"):
        mlp_grad_quad_bwd(mids, "tanh", *streams, cot[0][:5], cot[1])
