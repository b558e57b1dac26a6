"""K5-K8's plain versions (``pde_inverse_torch.ops.cuda.pairwise``) and the
blockwise provider's autograd Functions against the JAX package on the CPU.

* the plain versions against the JAX jnp tile math (``bw._tile_stats``, its
  ``jax.vjp``, and the collapsed-head composition of
  tests/test_pallas_packed.py) and against one interpret-mode Pallas call
  per kernel at the JAX tests' tiny size (block_i=8, block_j=4);
* masks and ragged sizes; chunking of the plain versions;
* ``mlp_pairwise_stats`` in modes on/fwd/packed (the plain versions behind
  the Functions) against off, values and parameter gradients.

Tolerances follow the JAX package's gates: rtol 2e-4 / atol 1e-4 on the
sums (tests/test_pallas_packed.py:62-70), 3e-4 relative to each gradient
leaf's max-abs, and 5e-3 relative for the collapsed head's parameter
gradients against the |f|^2 form (the collapse reassociates the feature
contraction, tests/test_pallas_packed.py:228-233).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu.losses import pairwise_blockwise as jbw
from pde_inverse_tpu.models.mlp import _ACTIVATIONS
from pde_inverse_tpu.ops.pallas import pairwise_kernel as jpk
from pde_inverse_tpu.ops.pallas import pairwise_packed as jpp
from pde_inverse_torch.convert import from_flax_params
from pde_inverse_torch.losses import pairwise_blockwise as bw
from pde_inverse_torch.models.mlp import PotentialMLP
from pde_inverse_torch.ops.cuda import pairwise as pk
from tests.test_pallas_packed import _collapse, _jnp_packed_composition
from tests.test_pallas_pairwise import _jnp_reference, _kernel_inputs, _setup

torch.set_num_threads(1)

SUM_RTOL, SUM_ATOL = 2e-4, 1e-4
GRAD_REL = 3e-4

T = lambda a: torch.from_numpy(np.array(a, np.float32))


def _mask(m, zeros=()):
    mask = np.ones(m, np.float32)
    mask[list(zeros)] = 0.0
    return mask


def _close_rel(got, want, rel=GRAD_REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (what, np.abs(got - want).max() / scale)


def _inputs(act="tanh", hidden=(16, 16), n=13, m=11, zeros=(), seed=3):
    net, params, x, v, refs = _setup(jax.random.PRNGKey(seed), n=n, m=m, act=act, hidden=hidden)
    mids, ax, av, ar = _kernel_inputs(net, params, x, v, refs)
    mask = _mask(m, zeros)
    tmids = [(T(W), T(b)) for W, b in mids]
    return net, params, (x, v, refs), (mids, ax, av, ar, jnp.asarray(mask)), (tmids, T(ax), T(av), T(ar), T(mask))


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("hidden,n,m,zeros", [((16, 16), 13, 11, ()), ((16,), 10, 7, (2, 4)),
                                              ((8, 8, 8), 1, 5, (0,))])
def test_k5_and_k7_plain_match_jnp_tiles(act, hidden, n, m, zeros):
    net, params, (x, v, refs), (mids, ax, av, ar, mask), (tmids, tax, tav, tar, tmask) = _inputs(
        act, hidden, n, m, zeros)
    want = _jnp_reference(net, params, x, v, refs, mask)
    got = pk.mlp_pairwise_sums_plain(tmids, act, tax, tav, tar, tmask)
    mids_m, M, u, c = _collapse(mids)
    tm = [(T(W), T(b)) for W, b in mids_m]
    got7 = pk.mlp_pairwise_sums_packed_plain(tm, T(M), T(u), act, tax, tav, tar, tmask)
    got7["value"] = got7["value"] + float(c) * float(tmask.sum())
    for out in (got, got7):
        for k in ("value", "hess", "s_dz0"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=SUM_RTOL,
                                       atol=SUM_ATOL, err_msg=k)


@pytest.mark.parametrize("act", ["tanh", "silu"])
@pytest.mark.parametrize("rows", [1, 1 << 20])
def test_k6_plain_matches_jax_vjp(act, rows):
    """K6's plain version against jax.vjp of the jnp tile math w.r.t.
    (layers, ax, av, ar), with a mask and ragged sizes; rows=1 makes every
    ref its own chunk."""
    net, params, _, (mids, ax, av, ar, mask), (tmids, tax, tav, tar, tmask) = _inputs(
        act, (16, 16), 10, 7, (2, 5), seed=13)
    act_fn = _ACTIVATIONS[act]
    w0 = ax.shape[-1]
    dummy0 = (jnp.zeros((2, w0)), jnp.zeros((w0,)))

    def f(mids_, ax_, av_, ar_):
        out = jbw._tile_stats([dummy0] + list(mids_), act_fn, jnp.float32, jnp.swapaxes(ax_, 0, 1),
                              jnp.swapaxes(ar_, 0, 1), jnp.swapaxes(av_, 0, 1), None, None, None, mask)
        n_, nt_ = ax_.shape[1], ax_.shape[0]
        out = {k: w.reshape((n_, nt_) + w.shape[1:]) for k, w in out.items()}
        return {"value": out["value"].T, "hess": out["hess"].T, "s_dz0": jnp.swapaxes(out["s_dz0"], 0, 1)}

    out, vjp = jax.vjp(f, mids, ax, av, ar)
    rs = np.random.default_rng(17)
    g = {k: rs.normal(size=np.shape(out[k])).astype(np.float32) for k in ("value", "hess", "s_dz0")}
    want_mids, want_ax, want_av, want_ar = vjp({k: jnp.asarray(v) for k, v in g.items()})
    got_mids, got_ax, got_av, got_ar = pk.mlp_pairwise_sums_bwd_plain(
        tmids, act, tax, tav, tar, tmask, T(g["value"]), T(g["hess"]), T(g["s_dz0"]), rows=rows)
    for (gw, gb), (ww, wb) in zip(got_mids, want_mids):
        _close_rel(gw, ww, what="W")
        _close_rel(gb, wb, what="b")
    _close_rel(got_ax, want_ax, what="ax")
    _close_rel(got_av, want_av, what="av")
    _close_rel(got_ar, want_ar, what="ar")


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("hidden,feat", [((64, 64), 128), ((48, 48, 48), 100), ((64,), 8)])
def test_k6_plain_matches_jax_vjp_at_widths_past_32(act, hidden, feat):
    """K6's plain version, which the card holds k6_kernel's eight lanes a
    pair to, against jax.vjp of the jnp tile math at the chains k6_kernel
    now takes past width 32 (64 -> 64 -> 128, the KMV MLP at hidden 64 x 2;
    48 x 3 -> 100; one 64-wide layer), with masked refs and ragged sizes,
    within GRAD_REL of each gradient's max-abs."""
    net, params, x, v, refs = _setup(jax.random.PRNGKey(21), n=6, m=5, nt=2, act=act, hidden=hidden, feat=feat)
    mids, ax, av, ar = _kernel_inputs(net, params, x, v, refs)
    mask = jnp.asarray(_mask(5, (1,)))
    w0 = ax.shape[-1]
    assert w0 == hidden[0] and pk.choose([w0] + [W.shape[1] for W, _ in mids], "on")[1] == "k6"
    dummy0 = (jnp.zeros((2, w0)), jnp.zeros((w0,)))
    act_fn = _ACTIVATIONS[act]

    def f(mids_, ax_, av_, ar_):
        out = jbw._tile_stats([dummy0] + list(mids_), act_fn, jnp.float32, jnp.swapaxes(ax_, 0, 1),
                              jnp.swapaxes(ar_, 0, 1), jnp.swapaxes(av_, 0, 1), None, None, None, mask)
        n_, nt_ = ax_.shape[1], ax_.shape[0]
        out = {k: w.reshape((n_, nt_) + w.shape[1:]) for k, w in out.items()}
        return {"value": out["value"].T, "hess": out["hess"].T, "s_dz0": jnp.swapaxes(out["s_dz0"], 0, 1)}

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, mids, ax, av, ar)
        rs = np.random.default_rng(19)
        g = {k: rs.normal(size=np.shape(out[k])).astype(np.float32) for k in ("value", "hess", "s_dz0")}
        want_mids, want_ax, want_av, want_ar = vjp({k: jnp.asarray(v) for k, v in g.items()})
    got_mids, got_ax, got_av, got_ar = pk.mlp_pairwise_sums_bwd_plain(
        [(T(W), T(b)) for W, b in mids], act, T(ax), T(av), T(ar), T(mask), T(g["value"]), T(g["hess"]),
        T(g["s_dz0"]))
    for (gw, gb), (ww, wb) in zip(got_mids, want_mids):
        _close_rel(gw, ww, what="W")
        _close_rel(gb, wb, what="b")
    _close_rel(got_ax, want_ax, what="ax")
    _close_rel(got_av, want_av, what="av")
    _close_rel(got_ar, want_ar, what="ar")


@pytest.mark.parametrize("act", ["tanh", "silu"])
@pytest.mark.parametrize("hidden", [(16,), (16, 16), (8, 8, 8)])
def test_k8_plain_matches_jax_vjp(act, hidden):
    """K8's plain version against jax.vjp of the independent collapsed-head
    composition w.r.t. (mids_m, M, u, ax, av, ar); M_bar agrees after
    symmetrisation (the kernel assumes M = M^T)."""
    net, params, _, (mids, ax, av, ar, mask), (_, tax, tav, tar, tmask) = _inputs(
        act, hidden, 10, 7, (2, 5), seed=13)
    mids_m, M, u, _ = _collapse(mids)
    M = 0.5 * (M + M.T)
    act_fn = _ACTIVATIONS[act]
    f = lambda mm, M_, u_, ax_, av_, ar_: _jnp_packed_composition(act_fn, mm, M_, u_, ax_, av_, ar_, mask)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, mids_m, M, u, ax, av, ar)
        rs = np.random.default_rng(17)
        g = {k: rs.normal(size=np.shape(out[k])).astype(np.float32) for k in ("value", "hess", "s_dz0")}
        want_mids, want_M, want_u, want_ax, want_av, want_ar = vjp({k: jnp.asarray(v) for k, v in g.items()})
    tm = [(T(W), T(b)) for W, b in mids_m]
    got_mids, got_M, got_u, got_ax, got_av, got_ar = pk.mlp_pairwise_sums_packed_bwd_plain(
        tm, T(M), T(u), act, tax, tav, tar, tmask, T(g["value"]), T(g["hess"]), T(g["s_dz0"]))
    _close_rel(got_M + got_M.T, np.asarray(want_M + want_M.T), what="M")
    _close_rel(got_u, want_u, what="u")
    for (gw, gb), (ww, wb) in zip(got_mids, want_mids):
        _close_rel(gw, ww, what="W")
        _close_rel(gb, wb, what="b")
    _close_rel(got_ax, want_ax, what="ax")
    _close_rel(got_av, want_av, what="av")
    _close_rel(got_ar, want_ar, what="ar")


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8"])
def test_plain_versions_match_interpret_mode_pallas(kernel):
    """One interpret-mode Pallas call per kernel at the JAX tests' tiny
    size (block_i=8, block_j=4), with a mask and ragged n, m."""
    net, params, _, (mids, ax, av, ar, mask), (tmids, tax, tav, tar, tmask) = _inputs(
        "tanh", (16, 16), 10, 7, (2,), seed=5)
    rs = np.random.default_rng(4)
    g = [rs.normal(size=s).astype(np.float32) for s in (ax.shape[:2], ax.shape[:2], ax.shape)]
    blocks = dict(block_i=8, block_j=4, interpret=True)
    mids_m, M, u, _ = _collapse(mids)
    M = 0.5 * (M + M.T)
    tm = [(T(W), T(b)) for W, b in mids_m]
    if kernel == "K5":
        want = jpk.mlp_pairwise_sums(mids, "tanh", ax, av, ar, mask, **blocks)
        got = pk.mlp_pairwise_sums_plain(tmids, "tanh", tax, tav, tar, tmask)
        pairs = [(got[k], want[k]) for k in ("value", "hess", "s_dz0")]
    elif kernel == "K7":
        with jax.default_matmul_precision("highest"):
            want = jpp.mlp_pairwise_sums_packed(mids_m, M, u, "tanh", ax, av, ar, mask, **blocks)
        got = pk.mlp_pairwise_sums_packed_plain(tm, T(M), T(u), "tanh", tax, tav, tar, tmask)
        pairs = [(got[k], want[k]) for k in ("value", "hess", "s_dz0")]
    elif kernel == "K6":
        w_mids, *w_rest = jpk.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *map(jnp.asarray, g), **blocks)
        g_mids, *g_rest = pk.mlp_pairwise_sums_bwd_plain(tmids, "tanh", tax, tav, tar, tmask, *map(T, g))
        pairs = [(a, b) for ga, wa in zip(g_mids, w_mids) for a, b in zip(ga, wa)] + list(zip(g_rest, w_rest))
    else:
        with jax.default_matmul_precision("highest"):
            w_mids, *w_rest = jpp.mlp_pairwise_sums_packed_bwd(mids_m, M, u, "tanh", ax, av, ar, mask,
                                                               *map(jnp.asarray, g), **blocks)
        g_mids, *g_rest = pk.mlp_pairwise_sums_packed_bwd_plain(tm, T(M), T(u), "tanh", tax, tav, tar,
                                                                tmask, *map(T, g))
        pairs = [(a, b) for ga, wa in zip(g_mids, w_mids) for a, b in zip(ga, wa)] + list(zip(g_rest, w_rest))
    for a, b in pairs:
        if kernel in ("K5", "K7"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SUM_RTOL, atol=SUM_ATOL)
        else:
            _close_rel(a, b)


def test_masked_refs_add_nothing_in_the_plain_versions():
    _, _, _, _, (tmids, tax, tav, tar, _) = _inputs("tanh", (16, 16), 9, 8)
    mask = T(_mask(8, (1, 6)))
    keep = [j for j in range(8) if j not in (1, 6)]
    full = pk.mlp_pairwise_sums_plain(tmids, "tanh", tax, tav, tar, mask)
    kept = pk.mlp_pairwise_sums_plain(tmids, "tanh", tax, tav, tar[:, keep], torch.ones(6))
    for k in full:
        torch.testing.assert_close(full[k], kept[k], rtol=1e-6, atol=1e-6)
    g = [torch.randn(tax.shape[:2]), torch.randn(tax.shape[:2]), torch.randn(tax.shape)]
    *_, ar_bar = pk.mlp_pairwise_sums_bwd_plain(tmids, "tanh", tax, tav, tar, mask, *g)
    assert not bool(ar_bar[:, [1, 6]].any())


def _torch_net(net, params, d=2):
    model = PotentialMLP(d, net.hidden_dims, feature_dim=net.feature_dim, activation=net.activation,
                         fourier_features=net.fourier_features, quadratic_head=net.quadratic_head)
    return model, from_flax_params(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("mode", ["on", "fwd", "packed", "auto"])
def test_functions_match_off_in_values_and_parameter_gradients(mode):
    """mlp_pairwise_stats with the plain versions behind the Functions (CPU
    tensors) against the plain formulation (mode off): values and the
    parameter gradient of a scalar of all three statistics."""
    net, params, (x, v, refs), *_ = _inputs("tanh", (16, 16), 12, 9, seed=7)
    model, tparams = _torch_net(net, params)
    xs = [T(a) for a in (x, v, refs)]

    def run(m):
        leaves = {k: t.detach().requires_grad_() for k, t in tparams.items()}
        s = bw.mlp_pairwise_stats(model, leaves, *xs, pallas_mode=m)
        scal = torch.sum(torch.sin(s["value"])) + torch.sum(s["nabla"] ** 2) + torch.sum(torch.cos(s["hess"]))
        return s, dict(zip(leaves, torch.autograd.grad(scal, list(leaves.values()))))

    s_off, g_off = run("off")
    s, g = run(mode)
    for k in ("nabla", "hess", "value"):
        np.testing.assert_allclose(s[k].detach().numpy(), s_off[k].detach().numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    rel = 5e-3 if mode == "packed" else GRAD_REL
    for k in g_off:
        _close_rel(g[k], g_off[k], rel=rel, what=k)


@pytest.mark.parametrize("fourier,quad", [(0, False), (4, True)])
def test_plain_formulation_matches_jax_blockwise(fourier, quad):
    """mode off (the CPU path) against the JAX package's jnp blockwise
    reduction, with and without the Fourier front end and quadratic head,
    and invariant to the chunking."""
    net, params, x, v, refs = _setup(jax.random.PRNGKey(19), n=13, m=13)
    jnet = type(net)(hidden_dims=[16, 16], feature_dim=8, fourier_features=fourier, quadratic_head=quad)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros(2))
    want = jbw.mlp_pairwise_stats(jnet, jparams, x, v, refs, pallas_mode="off")
    model, tparams = _torch_net(jnet, jparams)
    for rows in (1, 1 << 20):
        got = bw.mlp_pairwise_stats(model, tparams, T(x), T(v), T(refs), rows_per_chunk=rows,
                                    pallas_mode="off")
        for k in ("nabla", "hess", "value"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=1e-5,
                                       err_msg=k)


def test_routes_follow_the_jax_dispatch():
    gen = torch.Generator().manual_seed(0)
    narrow = PotentialMLP(2, [20] * 8, 128, generator=gen)
    wide = PotentialMLP(2, [64, 64], 128, generator=gen)
    fourier = PotentialMLP(2, [20] * 2, 128, fourier_features=4, generator=gen)
    gelu = PotentialMLP(2, [20] * 2, 128, activation="gelu", generator=gen)
    mids = lambda mod: bw._mlp_structure(mod, dict(mod.named_parameters()))[0][1:]
    assert bw.route(narrow, mids(narrow), "auto", "cuda") == "packed"
    assert bw.route(wide, mids(wide), "auto", "cuda") == "v1"
    assert bw.route(fourier, mids(fourier), "auto", "cuda") == "plain"
    assert bw.route(gelu, mids(gelu), "auto", "cuda") == "plain"
    assert bw.route(narrow, mids(narrow), "auto", "cpu") == "plain"
    assert bw.route(narrow, mids(narrow), "on", "cpu") == "v1"
    assert bw.route(narrow, mids(narrow), "fwd", "cpu") == "v1-fwd"
    assert bw.route(wide, mids(wide), "off", "cuda") == "plain"
    for module, mode in ((fourier, "on"), (wide, "packed"), (gelu, "fwd")):
        with pytest.raises(ValueError, match="kmv_pallas"):
            bw.route(module, mids(module), mode, "cpu")
    with pytest.raises(ValueError, match="kmv_pallas must be one of"):
        bw.route(narrow, mids(narrow), "xla", "cpu")
    widths = lambda mod: [W.shape[0] for W, _ in mids(mod)] + [mids(mod)[-1][0].shape[1]]
    assert jbw.packed_ok.__doc__ and pk.choose(widths(narrow))[0] == "k7" and pk.choose(widths(wide))[0] == "pw_fwd"
