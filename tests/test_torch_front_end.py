"""K9 and K10's plain versions, the Fourier front end of the fused pointwise
provider (pde_inverse_torch/ops/cuda/pointwise.py: ``front_streams_plain``,
``front_streams_bwd_plain``), and the provider's route through them, on
the CPU.

* K9's plain version against the front end's math as the provider wrote it
  before K9 (the first-layer streams of [x, cos xB, sin xB]), in float64;
  K10's against float64 autograd of that math, for the cotangents of all
  five outputs; at d in {2, 4}, F in {0, 32, 64}, w0 in {32, 64} and a
  ragged n;
* the provider's parameter gradient under "on" and "fwd" (the front end's
  autograd Function over the plain versions) against "xla";
* which (d, F, w0) have a kernel, the C entries' bindings, and the launch
  counters (CPU calls do not count).

This file imports neither JAX nor the JAX package.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from pde_inverse_torch.losses import fused_pointwise as fp
from pde_inverse_torch.models.mlp import PotentialMLP
from pde_inverse_torch.ops.cuda import pointwise as pk

CSRC = Path(pk.__file__).resolve().parents[2] / "csrc" / "pointwise.cu"


def _streams_math(x, v, B, W0, b0):
    """The front end as ``fused_pointwise._streams`` computed it before K9."""
    d = x.shape[-1]
    W0y = W0[:d]
    z1 = x @ W0y + b0
    dz1 = v @ W0y
    d2z1 = torch.zeros_like(z1)
    nf = B.shape[1]
    W0c, W0s = W0[d: d + nf], W0[d + nf:]
    p, dp = x @ B, v @ B
    cosp, sinp = torch.cos(p), torch.sin(p)
    dp2 = dp * dp
    z1 = z1 + cosp @ W0c + sinp @ W0s
    dz1 = dz1 + (-sinp * dp) @ W0c + (cosp * dp) @ W0s
    d2z1 = d2z1 + (-cosp * dp2) @ W0c + (-sinp * dp2) @ W0s
    return z1, dz1, d2z1, cosp, sinp


def _inputs(d, nf, w0, n=37, seed=0, dtype=torch.float64):
    """(x, v, B, W0, b0) as the KGMM path draws them (|p| reaches tens) and
    the cotangents of the five outputs."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen, dtype=torch.float64) * 2.0
    v = torch.randn((n, d), generator=gen, dtype=torch.float64) * 0.32
    B = torch.randn((d, nf), generator=gen, dtype=torch.float64)
    W0 = torch.randn((d + 2 * nf, w0), generator=gen, dtype=torch.float64) / (d + 2 * nf) ** 0.5
    b0 = torch.randn(w0, generator=gen, dtype=torch.float64) * 0.1
    bars = [torch.randn((n, w), generator=gen, dtype=torch.float64) for w in (w0, w0, w0, nf, nf)]
    return [t.to(dtype) for t in (x, v, B, W0, b0)], [t.to(dtype) for t in bars]


def _rel(got, want) -> float:
    scale = float(want.abs().max()) if want.numel() else 1.0
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-30) if want.numel() else 0.0


SHAPES = [(d, nf, w0) for d in (2, 4) for nf in (0, 32, 64) for w0 in (32, 64)]


@pytest.mark.parametrize("d,nf,w0", SHAPES)
def test_k9_plain_is_the_streams_math(d, nf, w0):
    """In float64 the plain version gives the provider's former streams to
    rounding; in float32 within 2e-5 of them (relative to each output's
    max-abs: cos and sin of |p| of tens)."""
    args, _ = _inputs(d, nf, w0)
    want = _streams_math(*args)
    got = pk.front_streams_plain(*args)
    assert [tuple(t.shape) for t in got] == [(37, w0)] * 3 + [(37, nf)] * 2
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-13
    args32, _ = _inputs(d, nf, w0, dtype=torch.float32)
    for g, w in zip(pk.front_streams_plain(*args32), want):
        assert g.dtype == torch.float32 and _rel(g, w) <= 2e-5


@pytest.mark.parametrize("d,nf,w0", SHAPES)
def test_k10_plain_is_float64_autograd_of_the_streams_math(d, nf, w0):
    """The VJP written out equals autograd's through the former streams for
    the cotangents of all five outputs: to rounding in float64, within 1e-4
    of its max-abs in float32 (sums over the points in another order)."""
    args, bars = _inputs(d, nf, w0)
    x, v, *leaves = args
    leaves = [t.clone().requires_grad_() for t in leaves]
    outs = _streams_math(x, v, *leaves)
    want = torch.autograd.grad(outs, leaves, bars, allow_unused=True)
    want = [torch.zeros_like(l) if g is None else g for g, l in zip(want, leaves)]
    got = pk.front_streams_bwd_plain(*args[:4], *bars)
    assert [tuple(t.shape) for t in got] == [(d, nf), (d + 2 * nf, w0), (w0,)]
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12
    args32, bars32 = _inputs(d, nf, w0, dtype=torch.float32)
    for g, w in zip(pk.front_streams_bwd_plain(*args32[:4], *bars32), want):
        assert g.dtype == torch.float32 and _rel(g, w) <= 1e-4


def _loss(model, params, x, v, mode):
    nab, quad = fp.grad_and_quadform(model, params, x, v, mode=mode)
    return torch.mean(torch.sum(nab**2, -1)) - 2.0 * torch.mean(quad) + 0.5 * torch.mean(torch.sum(nab * v, -1))


def _grad(model, params, x, v, mode):
    leaves = {k: t.detach().clone().requires_grad_() for k, t in params.items()}
    return dict(zip(leaves, torch.autograd.grad(_loss(model, leaves, x, v, mode), list(leaves.values()))))


# the presets' front end (a kernel's shape) and one that has no kernel
@pytest.mark.parametrize("shape", [(4, 64, 64), (2, 6, 16)], ids=["4x64x64", "2x6x16"])
@pytest.mark.parametrize("mode", ["on", "fwd"])
def test_provider_gradient_through_the_front_end_matches_xla(mode, shape):
    """On CPU tensors "on" and "fwd" take the front end's autograd Function
    over K9's and K10's plain versions (any shape); the parameter gradient
    equals "xla"'s (autograd through the plain streams) to f32 rounding."""
    d, nf, w0 = shape
    gen = torch.Generator().manual_seed(4)
    model = PotentialMLP(d, [w0, w0], feature_dim=4 * w0, fourier_features=nf, quadratic_head=True,
                         generator=gen)
    params = {k: p.detach() for k, p in model.named_parameters()}
    x, v = torch.randn((29, d), generator=gen) * 2.0, torch.randn((29, d), generator=gen) * 0.32
    want, got = _grad(model, params, x, v, "xla"), _grad(model, params, x, v, mode)
    assert set(got) == set(want) and "fourier_B" in got
    for k, g in want.items():
        assert _rel(got[k], g) <= 3e-5, k


def test_the_provider_routes_the_front_end(monkeypatch):
    """"on" and "fwd" call K9's wrapper (its plain version on the CPU), "xla"
    and "auto" on CPU tensors the plain streams, and a network without a
    Fourier front end neither."""
    calls = []
    wrapped = pk.front_streams
    monkeypatch.setattr(pk, "front_streams", lambda *a: calls.append(1) or wrapped(*a))
    gen = torch.Generator().manual_seed(5)
    x, v = torch.randn((9, 4), generator=gen), torch.randn((9, 4), generator=gen)
    fourier = PotentialMLP(4, [16], feature_dim=8, fourier_features=8, generator=gen)
    plain = PotentialMLP(4, [16], feature_dim=8, generator=gen)
    for model, mode, want in [(fourier, "on", 1), (fourier, "fwd", 1), (fourier, "xla", 0),
                              (fourier, "auto", 0), (plain, "on", 0)]:
        del calls[:]
        params = {k: p.detach() for k, p in model.named_parameters()}
        fp.grad_and_quadform(model, params, x, v, mode=mode)
        assert len(calls) == want, (mode, model.fourier_features)


@pytest.mark.parametrize("shape,fits", [((4, 64, 64), True), ((2, 64, 64), False), ((4, 32, 64), False),
                                        ((4, 64, 32), False), ((4, 0, 64), False), ((4, 6, 16), False)])
def test_front_fits_names_the_instantiated_shapes(shape, fits):
    """The rule that sends a front end to K9/K10 is FRONT_SHAPES, which the C
    side instantiates and dispatches on, shape for shape."""
    assert pk.front_fits(*shape) is fits
    source = CSRC.read_text()
    inst = set(re.findall(r"k9_kernel<(\d+), (\d+), (\d+)>", source))
    assert inst == set(re.findall(r"k10_kernel<(\d+), (\d+), (\d+)>", source))
    assert {tuple(map(int, t)) for t in inst} == set(pk.FRONT_SHAPES)
    dispatch = re.findall(r"d == (\d+) && nf == (\d+) && w0 == (\d+)", source)
    assert {tuple(map(int, t)) for t in dispatch} == set(pk.FRONT_SHAPES)


def test_ctypes_bindings_are_the_front_entries_prototypes():
    """FRONT_ENTRIES binds K9's and K10's extern "C" functions with their own
    argument and return types (pointers and the stream as c_void_p)."""
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "int*": ctypes.POINTER(ctypes.c_int),
             "float*": ctypes.c_void_p, "unsigned int*": ctypes.c_void_p, "void*": ctypes.c_void_p}
    protos = {name: (ret, params) for ret, name, params in
              re.findall(r'extern "C" ([a-z ]+?) (\w+)\(([^)]*)\)', CSRC.read_text().replace("\n", " "))}
    for name, (args, ret) in pk.FRONT_ENTRIES.items():
        c_ret, params = protos[name]
        types = [ctype[re.sub(r"^const |\s+\w+$", "", p.strip()).replace(" *", "*")] for p in params.split(",")]
        assert (args, ret) == (types, ctype[c_ret]), name


def test_front_wrappers_run_the_plain_versions_on_cpu_without_counting():
    args, bars = _inputs(4, 64, 64, n=11, dtype=torch.float32)
    before = (pk.front_streams.launches, pk.front_streams_bwd.launches)
    for got, want in ((pk.front_streams(*args), pk.front_streams_plain(*args)),
                      (pk.front_streams_bwd(*args[:4], *bars), pk.front_streams_bwd_plain(*args[:4], *bars))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (pk.front_streams.launches, pk.front_streams_bwd.launches) == before


def test_front_wrappers_check_their_inputs_on_the_kernel_path():
    """A front end with no instantiation, or inputs that do not chain, fail
    the kernel path's checks before any launch."""
    args, _ = _inputs(2, 64, 64, n=5, dtype=torch.float32)
    with pytest.raises(ValueError, match="no instantiation"):
        pk._front_check(*args[:4], (), "K9")
    args, _ = _inputs(4, 64, 64, n=5, dtype=torch.float32)
    with pytest.raises(ValueError, match="W0"):
        pk._front_check(*args[:3], args[3][1:], (), "K9")
    with pytest.raises(ValueError, match="float32"):
        pk._front_check(*args[:3], args[3].double(), (), "K9")
    assert pk._front_check(*args[:4], (args[4],), "K9") == (5, 4, 64, 64)
    xv = torch.zeros((5, 8))
    assert pk._unit_rows(xv[:, 4:])[1] == 8 and pk._unit_rows(xv.t())[1] == 5
