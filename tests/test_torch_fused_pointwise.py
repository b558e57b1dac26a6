"""K3/K4's plain versions and the fused pointwise provider
(pde_inverse_torch/ops/cuda/pointwise.py, losses/fused_pointwise.py)
against the JAX package, on the CPU.

* the plain versions against ``fused_pointwise._sums_jnp`` and its
  ``jax.vjp``, and against the Pallas kernels ``mlp_grad_quad`` /
  ``mlp_grad_quad_bwd`` in interpret mode;
* ``grad_and_quadform`` and the parameter gradient of a loss-shaped
  composite in modes xla/fwd/on against JAX autodiff, at ragged n;
* the kinetic Fokker-Planck loss with the fused provider against
  ``pde_inverse_tpu.losses.kinetic_fokker_planck.value_and_grad_fn``.

On CPU tensors modes "on" and "fwd" run the kernels' plain versions behind
the same ``torch.autograd.Function`` that launches K3/K4 on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.losses import fused_pointwise as jfp
from pde_inverse_tpu.losses import kinetic_fokker_planck as jkfp
from pde_inverse_tpu.models import mlp as jmlp
from pde_inverse_tpu.ops import autodiff as jad
from pde_inverse_tpu.ops.pallas import pointwise_kernel as jpk
from pde_inverse_tpu.problems.kfp_gmm import KineticFokkerPlanckGMM as JaxKGMM
from pde_inverse_torch.convert import from_flax_params
from pde_inverse_torch.losses import fused_pointwise as tfp
from pde_inverse_torch.losses import kinetic_fokker_planck as tkfp
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.models import mlp as tmlp
from pde_inverse_torch.ops import autodiff as tad
from pde_inverse_torch.ops.cuda import pointwise as tpk
from pde_inverse_torch.problems.kfp_gmm import KineticFokkerPlanckGMM as TorchKGMM

torch.set_num_threads(1)

# tests/test_fused_pointwise.py's tolerances: outputs rtol 2e-4 / atol 1e-5
# (f32, another operation order), parameter gradients rtol 3e-4 / atol 1e-5
RTOL, ATOL = 2e-4, 1e-5
G_RTOL = 3e-4
ACTS = ["tanh", "silu", "softplus"]
D = 2


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(jpk, "_INTERPRET", True)


def _stack(seed, widths=(12, 16, 8), n=29):
    """Layers after the first ([(W [in, out], b)]) and first-layer streams."""
    rs = np.random.default_rng(seed)
    mids = [((rs.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
             (rs.normal(size=b) * 0.1).astype(np.float32)) for a, b in zip(widths, widths[1:])]
    w0 = widths[0]
    streams = [(rs.normal(size=(n, w0)) * s).astype(np.float32) for s in (1.0, 0.7, 0.3)]
    cot = ((rs.normal(size=n)).astype(np.float32), rs.normal(size=(n, w0)).astype(np.float32))
    return mids, streams, cot


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _tmids(mids):
    return [(torch.from_numpy(W), torch.from_numpy(b)) for W, b in mids]


def _jmids(mids):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in mids]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("act", ACTS)
def test_k3_plain_matches_sums_jnp(act):
    mids, streams, _ = _stack(1)
    quad, delta = tpk.mlp_grad_quad_plain(_tmids(mids), act, *_t(streams))
    want = jfp._sums_jnp(_jmids(mids), jmlp._ACTIVATIONS[act], jnp.float32, *map(jnp.asarray, streams))
    _close(quad, want["quad"])
    _close(delta, want["delta"])


@pytest.mark.parametrize("act", ACTS)
def test_k4_plain_matches_vjp_of_sums_jnp(act):
    mids, streams, (g_quad, g_delta) = _stack(2)
    mids_bar, *streams_bar = tpk.mlp_grad_quad_bwd_plain(
        _tmids(mids), act, *_t(streams), torch.from_numpy(g_quad), torch.from_numpy(g_delta)
    )
    sums = lambda m, a, b, c: jfp._sums_jnp(m, jmlp._ACTIVATIONS[act], jnp.float32, a, b, c)
    _, pullback = jax.vjp(sums, _jmids(mids), *map(jnp.asarray, streams))
    j_mids_bar, *j_streams_bar = pullback({"quad": jnp.asarray(g_quad), "delta": jnp.asarray(g_delta)})
    for (wb, bb), (jwb, jbb) in zip(mids_bar, j_mids_bar):
        _close(wb, jwb, G_RTOL, ATOL * float(np.abs(jwb).max()))
        _close(bb, jbb, G_RTOL, ATOL * float(np.abs(jbb).max()))
    for got, want in zip(streams_bar, j_streams_bar):
        _close(got, want, G_RTOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("n", [1, 37])
def test_plain_versions_match_interpret_mode_kernels(interp, act, n):
    mids, streams, (g_quad, g_delta) = _stack(3, widths=(8, 8, 4), n=n)
    quad, delta = tpk.mlp_grad_quad_plain(_tmids(mids), act, *_t(streams))
    want = jpk.mlp_grad_quad(_jmids(mids), act, *map(jnp.asarray, streams))
    _close(quad, want["quad"])
    _close(delta, want["delta"])
    mids_bar, *streams_bar = tpk.mlp_grad_quad_bwd_plain(
        _tmids(mids), act, *_t(streams), torch.from_numpy(g_quad), torch.from_numpy(g_delta)
    )
    j_mids_bar, *j_streams_bar = jpk.mlp_grad_quad_bwd(
        _jmids(mids), act, *map(jnp.asarray, streams), jnp.asarray(g_quad), jnp.asarray(g_delta)
    )
    for (wb, bb), (jwb, jbb) in zip(mids_bar, j_mids_bar):
        _close(wb, jwb, G_RTOL, ATOL * float(np.abs(jwb).max()))
        _close(bb, jbb, G_RTOL, ATOL * float(np.abs(jbb).max()))
    for got, want in zip(streams_bar, j_streams_bar):
        _close(got, want, G_RTOL)


# tests/test_fused_pointwise.py MLP_VARIANTS, plus softplus
VARIANTS = {
    "plain": {},
    "fourier": {"fourier_features": 6, "fourier_scale": 0.7},
    "quad_head": {"quadratic_head": True},
    "fourier+quad": {"fourier_features": 4, "quadratic_head": True},
    "silu": {"activation": "silu"},
    "softplus": {"activation": "softplus"},
}


def _nets(variant):
    kw = VARIANTS[variant]
    net = jmlp.PotentialMLP(hidden_dims=[16, 16], feature_dim=8, **kw)
    params = jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(0), jnp.zeros(D)))
    return net, params, tmlp.PotentialMLP(D, [16, 16], feature_dim=8, **kw)


def _xv(n, seed=4):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(n, D)).astype(np.float32), rs.normal(size=(n, D)).astype(np.float32)


def _composite(nab, quad, v, lib):
    mean, tsum = (jnp.mean, jnp.sum) if lib == "jax" else (torch.mean, torch.sum)
    return mean(tsum(nab**2, -1)) - 2.0 * mean(quad) + 0.5 * mean(tsum(nab * v, -1))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", ["xla", "fwd", "on"])
def test_provider_and_param_grads_match_jax_autodiff(variant, mode):
    """Outputs and the gradient of a loss-shaped composite
    (tests/test_fused_pointwise.py:97-108), provider vs JAX autodiff."""
    net, params_np, model = _nets(variant)
    x, v = _xv(29)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jx, jv = jnp.asarray(x), jnp.asarray(v)

    def j_loss(p):
        nab, quad = jad.batched_grad_and_hvp_quadform(lambda xi: net.apply(p, xi)[0], jx, jv)
        return _composite(nab, quad, jv, "jax"), (nab, quad)

    (j_val, (j_nab, j_quad)), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jparams)
    tx, tv = torch.from_numpy(x), torch.from_numpy(v)

    def t_loss(p):
        nab, quad = tfp.grad_and_quadform(model, p, tx, tv, mode=mode)
        return _composite(nab, quad, tv, "torch"), (nab, quad)

    # torch.autograd, as the loss takes the gradient through the fused path
    leaves = {k: p.requires_grad_() for k, p in from_flax_params(params_np).items()}
    t_val, (t_nab, t_quad) = t_loss(leaves)
    t_grad = dict(zip(leaves, torch.autograd.grad(t_val, list(leaves.values()))))
    _close(t_nab.detach(), j_nab)
    _close(t_quad.detach(), j_quad)
    np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-5, atol=1e-7)
    j_grad = from_flax_params(jax.tree_util.tree_map(np.asarray, j_grad))
    assert set(t_grad) == set(j_grad)
    for name, g in t_grad.items():
        _close(g, j_grad[name], G_RTOL, ATOL)


@pytest.mark.parametrize("n", [1, 29, 37])
@pytest.mark.parametrize("mode", ["fwd", "on"])
def test_ragged_batches(n, mode):
    net, params_np, model = _nets("fourier")
    x, v = _xv(n, seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    j_nab, j_quad = jad.batched_grad_and_hvp_quadform(
        lambda xi: net.apply(jparams, xi)[0], jnp.asarray(x), jnp.asarray(v)
    )
    t_nab, t_quad = tfp.grad_and_quadform(
        model, from_flax_params(params_np), torch.from_numpy(x), torch.from_numpy(v), mode=mode
    )
    assert t_nab.shape == (n, D) and t_quad.shape == (n,)
    _close(t_nab.detach(), j_nab)
    _close(t_quad.detach(), j_quad)


def test_provider_composes_with_torch_func_grad_on_cpu():
    """On CPU tensors the same Function also runs under torch.func.grad."""
    _, params_np, model = _nets("fourier+quad")
    x, v = (torch.from_numpy(a) for a in _xv(29))
    loss = lambda p, m: _composite(*tfp.grad_and_quadform(model, p, x, v, mode=m), v, "torch")
    params = from_flax_params(params_np)
    ref = torch.func.grad(loss)(params, "xla")
    for mode in ("on", "fwd"):
        got = torch.func.grad(loss)(params, mode)
        for k, g in ref.items():
            _close(got[k], g, G_RTOL, ATOL)


def test_modes_select_the_path():
    net, params_np, model = _nets("fourier")
    cpu = torch.device("cpu")
    assert not tfp.active("auto", cpu) and not tfp.active("off", cpu)
    assert all(tfp.active(m, cpu) for m in ("on", "fwd", "xla"))
    assert tfp.active("auto", torch.device("cuda"))
    with pytest.raises(ValueError, match="kfp_fused"):
        tfp.active("pallas", cpu)
    assert tfp.supported(model) and not tfp.supported(tmlp.ResNetPotential(D, 8, 1))
    assert not tfp.supported(tmlp.PotentialMLP(D, [8], activation="gelu"))
    x, v = (torch.from_numpy(a) for a in _xv(5))
    with pytest.raises(ValueError, match="autodiff"):
        tfp.grad_and_quadform(model, from_flax_params(params_np), x, v, mode="off")


D_KFP = 4


@pytest.fixture(scope="module")
def kgmm():
    cfg = config_lib.preset("KGMM", ["pde_instance.n_steps=10", "solver.train.batch_size_0T=8"])
    j = JaxKGMM(cfg, jax.random.PRNGKey(0))
    t = TorchKGMM(cfg, 0, "cpu", configuration={"mus": np.asarray(j.configuration["mus"])})
    return j, t


@pytest.mark.parametrize("mode", ["xla", "fwd", "on", "auto"])
def test_kfp_loss_with_fused_provider_matches_jax(kgmm, mode):
    """Loss, gap and parameter gradient with the fused provider on one
    shared batch against the JAX loss (autodiff on the CPU); "auto" on CPU
    tensors is the port's autodiff path."""
    jinst, tinst = kgmm
    kw = {"fourier_features": 6, "quadratic_head": True}
    net = jmlp.PotentialMLP(hidden_dims=[16, 16], feature_dim=8, **kw)
    params_np = jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(1), jnp.zeros(D_KFP)))
    model = tmlp.PotentialMLP(D_KFP, [16, 16], feature_dim=8, **kw)
    rs = np.random.default_rng(6)
    sd = np.array([2.0] * D_KFP + [np.sqrt(0.1)] * D_KFP, np.float32)
    batch = {k: (rs.normal(size=(n, 2 * D_KFP)) * sd).astype(np.float32)
             for k, n in (("initial", 48), ("terminal", 48), ("0T", 64))}
    j = jkfp.value_and_grad_fn(
        net.apply, jax.tree_util.tree_map(jnp.asarray, params_np),
        {k: jnp.asarray(b) for k, b in batch.items()}, None, jinst,
    )
    t = tkfp.value_and_grad_fn(
        functional_forward(model), from_flax_params(params_np),
        {k: torch.from_numpy(b) for k, b in batch.items()}, tinst,
        fused_module=model, fused_mode=mode,
    )
    for name in ("loss", "loss ground truth", "grad_norm"):
        np.testing.assert_allclose(float(t[name]), float(j[name]), rtol=1e-5, atol=1e-7)
    j_grad = from_flax_params(jax.tree_util.tree_map(np.asarray, j["grad"]))
    for name, g in t["grad"].items():
        _close(g, j_grad[name], G_RTOL, ATOL)


def test_auto_mode_is_the_autodiff_path_on_cpu(kgmm):
    _, tinst = kgmm
    model = tmlp.PotentialMLP(D_KFP, [8], feature_dim=8, fourier_features=4,
                              generator=torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    rs = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rs.normal(size=(32, 2 * D_KFP)).astype(np.float32))
             for k in ("initial", "terminal", "0T")}
    fwd = functional_forward(model)
    ref = tkfp.value_and_grad_fn(fwd, params, batch, tinst)
    auto = tkfp.value_and_grad_fn(fwd, params, batch, tinst, fused_module=model, fused_mode="auto")
    assert float(auto["loss"]) == float(ref["loss"])
    assert all(torch.equal(auto["grad"][k], ref["grad"][k]) for k in ref["grad"])


def test_wrappers_run_the_plain_versions_on_cpu_without_counting():
    mids, streams, (g_quad, g_delta) = _stack(8)
    before = (tpk.mlp_grad_quad.launches, tpk.mlp_grad_quad_bwd.launches)
    quad, delta = tpk.mlp_grad_quad(_tmids(mids), "tanh", *_t(streams))
    want = tpk.mlp_grad_quad_plain(_tmids(mids), "tanh", *_t(streams))
    assert torch.equal(quad, want[0]) and torch.equal(delta, want[1])
    out = tpk.mlp_grad_quad_bwd(_tmids(mids), "tanh", *_t(streams), *_t([g_quad, g_delta]))
    assert out[1].shape == streams[0].shape and len(out[0]) == 2
    assert (tpk.mlp_grad_quad.launches, tpk.mlp_grad_quad_bwd.launches) == before


def test_shared_memory_of_the_full_width_tile():
    """At the preset's width (w0 = 64, layers 64->64->256) a K3 block of 32
    points holds 128 rows of pre-activations, p and q (128), the activated
    copy (192), one chunk of 64 features of the last layer and its 16 rows
    of quad partials, at 36 floats a row: two blocks fit an SM.  A K4 block
    of 32 points holds 4 streams x (128 saved + 64 activated + 64 of the
    last layer) rows x 36 floats, g_quad of the tile and its 20,800
    weight-gradient sums: above the 48 KB default, inside Hopper's 227 KB
    opt-in."""
    plan = tpk.k3_plan([64, 64, 256])
    assert plan == ((64, 64, 256), 32, 64, 2, 4 * (128 + 128 + 192 + 64 + 16) * 36)
    assert plan.shared_bytes == 76_032 and 2 * (plan.shared_bytes + 1024) <= 228 * 1024
    plan = tpk.k4_plan([64, 64, 256])
    assert plan == ((64, 64, 256), 32, 64, True, 4 * (4 * 256 * 36 + 32 + 20_800))
    assert plan.shared_bytes == 230_784 <= 227 * 1024
    # widths of 20 are padded to 24
    assert tpk.k4_plan([20] * 8 + [128]).shared_bytes == 4 * (4 * (192 + 24 + 64) * 36 + 32 + 7_400)


# chain -> (tile, weight-gradient sums in shared memory): 64 points where the
# rows fit, 32 at the full width, 8 and no sums for 16 layers of 64 (1,152
# rows a stream)
K4_CHAINS = {(64, 64, 256): (32, True), (32, 32, 128): (64, True), (20,) * 8 + (128,): (32, True),
             (8, 8, 4): (64, True), (5, 7, 3): (64, True), (64,) * 17: (8, False),
             (64, 256): (32, True), (6, 100): (64, True)}


@pytest.mark.parametrize("widths", list(K4_CHAINS), ids=lambda w: f"{len(w) - 1}x{max(w)}x{w[0]}")
def test_k4_plan_fits_the_card(widths):
    """Every chain gets widths in multiples of 8, one of the kernel's tiles,
    a chunk in multiples of 8 features, one pass of the block
    over the last layer's inputs, and at most 227 KB of shared memory."""
    plan = tpk.k4_plan(widths)
    assert all(p % 8 == 0 and 0 <= p - w < 8 for p, w in zip(plan.widths, widths))
    assert plan.tile in tpk.K4_TILES and plan.chunk % 8 == 0 and 8 <= plan.chunk <= 64
    assert plan.chunk == min(64, plan.widths[-1])
    assert (plan.tile // 4) * (plan.widths[-2] // 4) <= tpk.K4_THREADS // 2
    assert plan.shared_bytes == tpk.k4_shared_bytes(plan.widths, plan.tile, plan.chunk, plan.acc_shared)
    assert plan.shared_bytes <= 227 * 1024
    assert (plan.tile, plan.acc_shared) == K4_CHAINS[widths]


def test_k4_plan_refuses_what_fits_no_tile():
    with pytest.raises(ValueError, match="shared memory"):
        tpk.k4_plan((128,) * 17)
    with pytest.raises(ValueError, match="layers"):
        tpk.k4_plan((64,) * 18)
    with pytest.raises(ValueError, match="layers"):
        tpk.k4_plan((64,))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("widths", [(5, 7, 3), (6, 10), (12, 20, 8), (16, 24, 8)])
def test_k4_padding_is_exact(act, widths):
    """K4's plain version on the chain zero-padded as the wrapper pads it
    gives, after the wrapper's slicing, the gradients of the unpadded chain
    (a padded feature adds 0.0 even where act(0) != 0: its outgoing weights
    are zero): jax.vjp's of the JAX composition within the tolerances of
    test_k4_plain_matches_vjp_of_sums_jnp (rtol 3e-4, atol 1e-5 of the
    largest entry: f32 in another order).  (16, 24, 8) needs no padding."""
    mids, streams, (g_quad, g_delta) = _stack(9, widths=widths, n=23)
    plan = tpk.k4_plan(widths)
    t_mids, t_rows = _tmids(mids), _t(streams + [g_delta])
    p_mids, p_rows = tpk.pad_chain(t_mids, plan.widths, t_rows)
    assert [tuple(W.shape) for W, _ in p_mids] == list(zip(plan.widths, plan.widths[1:]))
    assert all(r.shape == (23, plan.widths[0]) for r in p_rows)
    mids_bar, *streams_bar = tpk.mlp_grad_quad_bwd_plain(
        p_mids, act, *p_rows[:3], torch.from_numpy(g_quad), p_rows[3])
    mids_bar, streams_bar = tpk.unpad_grads(mids_bar, streams_bar, t_mids)
    sums = lambda m, a, b, c: jfp._sums_jnp(m, jmlp._ACTIVATIONS[act], jnp.float32, a, b, c)
    _, pullback = jax.vjp(sums, _jmids(mids), *map(jnp.asarray, streams))
    j_mids_bar, *j_streams_bar = pullback({"quad": jnp.asarray(g_quad), "delta": jnp.asarray(g_delta)})
    for (wb, bb), (jwb, jbb), (W, b) in zip(mids_bar, j_mids_bar, mids):
        assert wb.shape == W.shape and bb.shape == b.shape
        _close(wb, jwb, G_RTOL, ATOL * float(np.abs(jwb).max()))
        _close(bb, jbb, G_RTOL, ATOL * float(np.abs(jbb).max()))
    for got, want in zip(streams_bar, j_streams_bar):
        assert got.shape == want.shape
        _close(got, want, G_RTOL)


# chain -> (tile, blocks a SM): 64 points where two such blocks fit, 32 at the
# full width, 16 for 16 layers of 64 (1,424 rows)
K3_CHAINS = {(64, 64, 256): (32, 2), (32, 32, 128): (64, 2), (20,) * 8 + (128,): (64, 2),
             (8, 8, 4): (64, 2), (5, 7, 3): (64, 2), (64,) * 17: (16, 2), (64, 256): (32, 2),
             (6, 100): (64, 2), (16,) * 13: (64, 2), (8, 4096): (64, 2)}


@pytest.mark.parametrize("widths", list(K3_CHAINS), ids=lambda w: f"{len(w) - 1}x{max(w)}x{w[0]}")
def test_k3_plan_fits_the_card(widths):
    """Every chain K4 takes (and those the card tests run) gets widths in
    multiples of 8, one of the kernel's tiles, a chunk of at most 64
    features in multiples of 8, and at most 227 KB of shared memory a
    block; with two blocks an SM, both fit in its 228 KB."""
    plan = tpk.k3_plan(widths)
    assert all(p % 8 == 0 and 0 <= p - w < 8 for p, w in zip(plan.widths, widths))
    assert plan.tile in tpk.K3_TILES and plan.chunk == min(64, plan.widths[-1]) and plan.chunk % 8 == 0
    assert plan.shared_bytes == tpk.k3_shared_bytes(plan.widths, plan.tile, plan.chunk) <= 227 * 1024
    assert plan.blocks_per_sm * (plan.shared_bytes + 1024) <= 228 * 1024
    assert (plan.tile, plan.blocks_per_sm) == K3_CHAINS[widths]
    if widths in K4_CHAINS:
        tpk.k4_plan(widths)


@pytest.mark.parametrize("widths,match", [((8, 4096, 8), "shared memory"), ((64,) * 18, "layers"),
                                          ((64,), "layers"), ((64, 0, 8), "positive")])
def test_k3_plan_refuses_what_fits_no_tile(widths, match):
    """A 4096-wide hidden layer needs 5 x 4096 rows at any tile; the kernel
    takes 1..16 layers of positive widths."""
    with pytest.raises(ValueError, match=match):
        tpk.k3_plan(widths)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("widths", [(5, 7, 3), (6, 10), (12, 20, 8), (16, 24, 8)])
def test_k3_padding_is_exact(act, widths):
    """K3's plain version on the chain zero-padded as the wrapper pads it
    gives, after the wrapper's slicing of delta, what ``_sums_jnp`` gives
    for the unpadded chain (a padded feature adds 0.0 even where act(0) !=
    0: its outgoing weights are zero; a padded output feature has z_L = p_L
    = q_L = 0), within test_k3_plain_matches_sums_jnp's tolerances.
    (16, 24, 8) needs no padding."""
    mids, streams, _ = _stack(10, widths=widths, n=23)
    plan = tpk.k3_plan(widths)
    t_mids = _tmids(mids)
    p_mids, p_rows = tpk.pad_chain(t_mids, plan.widths, _t(streams))
    assert [tuple(W.shape) for W, _ in p_mids] == list(zip(plan.widths, plan.widths[1:]))
    quad, delta = tpk.mlp_grad_quad_plain(p_mids, act, *p_rows)
    delta = delta[:, :widths[0]]
    want = jfp._sums_jnp(_jmids(mids), jmlp._ACTIVATIONS[act], jnp.float32, *map(jnp.asarray, streams))
    assert quad.shape == want["quad"].shape and delta.shape == want["delta"].shape
    _close(quad, want["quad"])
    _close(delta, want["delta"])
