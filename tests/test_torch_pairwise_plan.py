"""The pairwise kernels' plans and choice (``pde_inverse_torch.ops.cuda.pairwise``
``plan`` and ``choose``) on the CPU: which kernel runs each chain, and for
K7, K8, K6's k6_kernel and K5's k5_kernel the width instantiation, the
points a block, the shared memory, the feature layer's chunks and the ref
splits that the kernels' header comment (``csrc/pairwise.cu``) states
(k6_kernel also on eight lanes a pair at widths 48 and 64), and the
zero-padding of the hidden layers, M and u (K6 and K5: the feature layer,
to whole chunks) to each instantiated width, which must leave the sums and
their VJP unchanged.

The padding is held against the JAX package's independent collapsed-head
composition (tests/test_pallas_packed.py::_jnp_packed_composition) on the
unpadded layers, with the tolerances tests/test_torch_pairwise.py uses: for
the sums rtol 2e-4 / atol 1e-4 (the JAX package's gate), for the VJP 3e-4
of each gradient's max-abs against ``jax.vjp`` (both sides are float32
sums in different orders).  K5's padded sums are held to the JAX tile math
(``pde_inverse_tpu.losses.pairwise_blockwise._tile_stats``) with K6's
tolerance, 3e-4 of each output's max-abs.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu.losses import pairwise_blockwise as jbw
from pde_inverse_tpu.models.mlp import _ACTIVATIONS
from pde_inverse_torch.ops.cuda import pairwise as pk
from tests.test_pallas_packed import _collapse, _jnp_packed_composition
from tests.test_pallas_pairwise import _kernel_inputs, _setup

torch.set_num_threads(1)

SUM_RTOL, SUM_ATOL = 2e-4, 1e-4
GRAD_REL = 3e-4
T = lambda a: torch.from_numpy(np.array(a, np.float32))
# the kernel's source with its comment lines joined
HEADER = re.sub(r"\s*\n//\s*", " ", (Path(pk.__file__).resolve().parents[2] / "csrc" / "pairwise.cu").read_text())


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("hidden,width", [((16, 16), 16), ((16, 16), 24), ((8, 8, 8), 20),
                                          ((20, 32, 8, 20), 32)])
def test_zero_padding_leaves_the_sums_unchanged(act, hidden, width):
    """The plain K7 version on the chain padded to `width` (points padded
    with zero features) equals the JAX composition on the unpadded chain;
    the padded features' s_dz0 are exactly 0."""
    net, params, x, v, refs = _setup(jax.random.PRNGKey(11), n=9, m=7, act=act, hidden=hidden)
    mids, ax, av, ar = _kernel_inputs(net, params, x, v, refs)
    mids_m, M, u, _ = _collapse(mids)
    M = 0.5 * (M + M.T)
    mask = jnp.asarray([1, 0, 1, 1, 1, 0, 1], jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = _jnp_packed_composition(_ACTIVATIONS[act], mids_m, M, u, ax, av, ar, mask)
    flat, layers, Mp, up = pk.pad_collapsed([(T(W), T(b)) for W, b in mids_m], T(M), T(u), width)
    assert flat.numel() == len(mids_m) * (width * width + width) + width * width + width
    assert all(W.shape == (width, width) and b.shape == (width,) for W, b in layers)
    w0 = ax.shape[-1]
    pad = lambda a: torch.nn.functional.pad(T(a), (0, width - w0))
    got = pk.mlp_pairwise_sums_packed_plain(layers, Mp, up, act, pad(ax), pad(av), pad(ar), T(mask))
    for k in ("value", "hess"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=SUM_RTOL, atol=SUM_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["s_dz0"][..., :w0].numpy(), np.asarray(want["s_dz0"]), rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    assert not bool(got["s_dz0"][..., w0:].any())


@pytest.mark.parametrize("widths,width", [([2, 8, 8], 8), ([20] * 9, 20), ([9, 16, 16], 16),
                                          ([20, 17, 20], 20), ([20, 21, 8], 24), ([25, 8], 32),
                                          ([20, 32, 8, 20, 20], 32)])
def test_plan_maps_widths_to_the_least_instantiation(widths, width):
    plan = pk.plan("k7", widths)
    assert plan.width == width and plan.width in pk.K7_WIDTHS
    assert plan.threads == plan.points == 128 and plan.chunks == 0
    assert plan.shared_bytes == pk.k7_shared_bytes(width, 128, len(widths) - 2)
    row = {8: 12, 16: 20, 20: 20, 24: 28, 32: 36}[width]  # rows 4 banks apart modulo 8
    n_layers = len(widths) - 2
    assert plan.shared_bytes == 4 * (n_layers * (width * width + width) + width * width + width
                                     + (n_layers + 1) * 128 * row)


def test_plan_refuses_widths_past_32_and_non_chains():
    with pytest.raises(ValueError, match="widths <= 32"):
        pk.plan("k7", [20, 33, 20])
    with pytest.raises(ValueError, match="chain"):
        pk.plan("k7", [20])


def test_plan_and_splits_are_the_header_comments():
    """The KMV main path (w0 = 20, seven 20 x 20 layers, M [20, 20]):
    95,360 B a block (13,440 of weights, 71,680 of act', 10,240 of s_dz0
    sums), 128 points a block, and 7 ref splits for 264 resident blocks on
    7 x 16 point blocks; the numbers the kernel's header comment states."""
    plan = pk.plan("k7", [20] * 9)
    assert plan == pk.Plan("k7", 20, 128, 0, 95_360, 128)
    assert 4 * (7 * (20 * 20 + 20) + 20 * 20 + 20) == 13_440 and 4 * 7 * 20 * 128 == 71_680
    assert 2 * (95_360 + 1024) <= 228 * 1024 < 3 * (95_360 + 1024)  # 1 KB reserved a block
    assert pk.k7_splits(7, 2_000, 2_000, 128, 2 * 132) == 7
    for text in ("13,440 B of weights + 71,680 B of act' + 10,240 B of s_dz0 sums = 95,360 B",
                 "7 splits", "(784 blocks, 2.97 waves)", "{8, 16, 20, 24, 32}", "4 (L (W^2 + W) + W^2 + W)",
                 "4 (L + 1) `threads` R bytes"):
        assert text in HEADER, text
    assert pk.K7_WIDTHS == (8, 16, 20, 24, 32)


def test_plan_takes_fewer_points_a_block_where_shared_memory_would_not_fit():
    """16 layers at width 32: 71,808 B of weights; act' and the s_dz0 sums
    in rows of 36 floats for 128 points would take 313,344 B more, for 64
    points 156,672 B."""
    plan = pk.plan("k7", [32] * 18)
    assert plan == pk.Plan("k7", 32, 64, 0, 71_808 + 156_672, 64)
    assert plan.shared_bytes <= 227 * 1024 < pk.k7_shared_bytes(32, 128, 16)


@pytest.mark.parametrize("nt,n,m,resident,want", [(7, 2_000, 2_000, 264, 7), (1, 10, 3, 264, 3),
                                                  (3, 130, 5, 264, 5), (2, 129, 1, 264, 1),
                                                  (7, 2_000, 2_000, 132, 7)])
def test_splits_round_the_grid_to_whole_waves(nt, n, m, resident, want):
    """The fewest splits that minimise ceil(splits x blocks / resident) x
    ceil(m / splits) over up to 8 waves: never more than one per ref."""
    splits = pk.k7_splits(nt, n, m, 128, resident)
    assert splits == want and 1 <= splits <= m
    blocks = nt * -(-n // 128)
    cost = lambda s: -(-s * blocks // resident) * -(-m // s)
    assert all(cost(splits) <= cost(s) for s in range(1, min(m, -(-8 * resident // blocks)) + 1))


# (square-head chain, kernels under "auto" and "packed", kernels under "on"
# and "fwd"): the KMV MLP (w0 20 or 2), the hidden-64 chains of the KMV MLP
# at 64 x 2 to 64 x 4 and those too deep for the octets (64 x 5 and 64 x 4
# at 130 features), a chain past 64, chains at 33-64 that only
# pw_bwd_kernel's tile holds, and the unequal, ragged and deep chains the
# CUDA tests run
CHOSEN = [([20] * 8 + [128], ("k7", "k8"), ("k5", "k6")), ([2] + [20] * 8 + [128], ("k7", "k8"), ("k5", "k6")),
          ([64, 64, 128], ("pw_fwd", "k6"), ("pw_fwd", "k6")), ([64] * 3 + [128], ("pw_fwd", "k6"), ("pw_fwd", "k6")),
          ([64] * 4 + [128], ("pw_fwd", "k6"), ("pw_fwd", "k6")), ([64] * 5 + [128], ("pw_fwd", "k6"), ("pw_fwd", "k6")),
          ([64] * 6 + [128], ("pw_fwd", "pw_bwd"), ("pw_fwd", "pw_bwd")),
          ([64] * 5 + [130], ("pw_fwd", "pw_bwd"), ("pw_fwd", "pw_bwd")),
          ([72, 72, 16], ("pw_fwd", "pw_bwd"), ("pw_fwd", "pw_bwd")),
          ([1] + [56] * 6 + [8], ("pw_fwd", "pw_bwd"), ("pw_fwd", "pw_bwd")),
          ([40] + [1] * 12 + [1], ("pw_fwd", "pw_bwd"), ("pw_fwd", "pw_bwd")),
          ([32, 33, 8], ("pw_fwd", "k6"), ("pw_fwd", "k6")), ([40, 40, 8], ("pw_fwd", "k6"), ("pw_fwd", "k6")),
          ([20, 65, 8], ("pw_fwd", "pw_bwd"), ("pw_fwd", "pw_bwd")),
          ([48, 48, 48, 100], ("pw_fwd", "k6"), ("pw_fwd", "k6")), ([32, 130], ("k7", "k8"), ("k5", "k6")),
          ([8, 8, 4], ("k7", "k8"), ("k5", "k6")), ([32] * 16 + [100], ("k7", "k8"), ("k5", "k6")),
          ([12, 20, 20, 100], ("k7", "k8"), ("k5", "k6"))]


@pytest.mark.parametrize("widths,packed,square", CHOSEN)
def test_choose_gives_each_chain_its_kernels(widths, packed, square):
    """``choose`` in each mode.  At widths <= 32, "on" keeps K6 on
    k6_kernel even where its plan does not fit (15 hidden layers of 32 and
    100 features): the launch raises there."""
    assert pk.choose(widths, "auto") == pk.choose(widths, "packed") == packed
    assert pk.choose(widths, "on") == pk.choose(widths, "fwd") == square
    if widths == [32] * 16 + [100]:
        with pytest.raises(ValueError, match="shared memory"):
            pk.plan("k6", widths)
    with pytest.raises(ValueError, match="no kernels"):
        pk.choose(widths, "off")


# -- K8 ------------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers", [0, 7, 16])
@pytest.mark.parametrize("width", pk.K7_WIDTHS)
def test_k8_plan_fits_shared_memory(width, n_layers):
    """K8's plan at every width instantiation and depth: K7's width, the
    most lanes a block (of K8_THREADS) whose shared memory fits 227 KB: the
    weights twice (values and gradient accumulators), max(L, 1) + 1 row sets
    of 4 rows + 4 floats a pair, the warps' scratch (two buffers of W^2 + W
    floats a warp, none for one warp) and one ref-row partial a warp."""
    plan = pk.plan("k8", [width] * (n_layers + 2))
    assert plan.width == width and plan.threads in pk.K8_THREADS and plan.threads % 32 == 0
    assert plan.points == plan.threads // 4 and plan.chunks == 0
    row = {8: 12, 16: 20, 20: 20, 24: 28, 32: 36}[width]
    weights = n_layers * (width * width + width) + width * width + width
    warps = plan.threads // 32
    scratch = 2 * warps * (width * width + width) if warps > 1 else 0
    want = 4 * (2 * weights + (max(n_layers, 1) + 1) * (plan.threads // 4) * (4 * row + 4) + scratch
                + warps * width)
    assert plan.shared_bytes == want == pk.k8_shared_bytes(width, plan.threads, n_layers)
    assert plan.shared_bytes <= 227 * 1024
    larger = [t for t in pk.K8_THREADS if t > plan.threads]
    assert all(pk.k8_shared_bytes(width, t, n_layers) > 227 * 1024 for t in larger)


def test_k8_plan_and_splits_are_the_header_comments():
    """The KMV main path (w0 = 20, seven 20 x 20 layers, M [20, 20]): 256
    lanes (64 points) a block and 226,432 B (26,880 of weights and
    accumulators, 172,032 of rows, 26,880 of the warps' scratch, 640 of
    ref-row partials), one block an SM, and 4 ref splits for 132 resident
    blocks on 7 x 32 point blocks."""
    plan = pk.plan("k8", [20] * 9)
    assert plan == pk.Plan("k8", 20, 256, 0, 226_432, 64)
    assert 2 * 4 * (7 * 420 + 420) == 26_880 and 4 * 8 * 64 * 84 == 172_032 and 4 * 8 * 20 == 640
    assert 4 * pk.k8_scratch_floats(20, 256) == 4 * 2 * 8 * 420 == 26_880
    assert 26_880 + 172_032 + 26_880 + 640 == plan.shared_bytes <= 232_448
    assert plan.shared_bytes + 1024 <= 228 * 1024 < 2 * (plan.shared_bytes + 1024)
    assert pk.k7_splits(7, 2_000, 2_000, plan.points, 132) == 4
    assert pk.k8_rows(7) == 8 and pk.k8_rows(1) == 2 and pk.k8_rows(0) == 2
    for text in ("26,880 B of weights and accumulators + 172,032 B of rows + 26,880 B of scratch + 640 B of "
                 "ref-row partials = 226,432 B", "4 splits", "(896 blocks, 6.79 waves)",
                 "max(L, 1) + 1 row sets", "4 R + 4 floats", "one barrier a layer"):
        assert text in HEADER, text


def test_k8_plan_shrinks_the_block_and_refuses_widths_past_32():
    """16 layers at width 32 leave room for 32 lanes (8 points) a block,
    one warp, which needs no scratch: with one it would not fit."""
    plan = pk.plan("k8", [32] * 18)
    assert plan == pk.Plan("k8", 32, 32, 0, pk.k8_shared_bytes(32, 32, 16), 8)
    assert pk.k8_shared_bytes(32, 64, 16) > 227 * 1024 >= plan.shared_bytes
    assert pk.k8_scratch_floats(32, 32) == 0
    assert plan.shared_bytes + 4 * 2 * (32 * 32 + 32) > 227 * 1024
    with pytest.raises(ValueError, match="widths <= 32"):
        pk.plan("k8", [20, 33, 20])
    with pytest.raises(ValueError, match="chain"):
        pk.plan("k8", [20])


@pytest.mark.parametrize("width", pk.K7_WIDTHS)
def test_k8_scratch_and_row_sets_at_each_width(width):
    """At the main path's depth (7 hidden layers) every width keeps 8 row
    sets (the saved inputs of layers 1-6, H and S: one set S, since a warp
    reads only its own pairs' rows) and a scratch of two buffers of one
    layer's W^2 + W floats for each warp of its plan; a block of one warp
    has none.  K6 keeps its 9 (two sets S)."""
    plan = pk.plan("k8", [width] * 9)
    warps = plan.threads // 32
    assert pk.k8_rows(7) == 8 and pk.k6_rows(7) == 9
    assert pk.k8_scratch_floats(width, plan.threads) == 2 * warps * (width * width + width)
    assert pk.k8_scratch_floats(width, 32) == 0 and pk.k8_scratch_floats(width, 64) == 4 * (width * width + width)
    row = {8: 12, 16: 20, 20: 20, 24: 28, 32: 36}[width]
    rows = 4 * 8 * (plan.threads // 4) * (4 * row + 4)
    weights = 4 * 2 * 8 * (width * width + width)
    assert plan.shared_bytes == weights + rows + 4 * pk.k8_scratch_floats(width, plan.threads) + 4 * warps * width
    assert plan.threads == {8: 256, 16: 256, 20: 256, 24: 128, 32: 96}[width]


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("hidden,width", [((16, 16), 16), ((16, 16), 24), ((8, 8, 8), 20),
                                          ((20, 32, 8, 20), 32)])
def test_zero_padding_leaves_the_vjp_unchanged(act, hidden, width):
    """The plain K8 version on the chain padded to `width` gives, after the
    wrapper's slicing (``unpad_collapsed``), ``jax.vjp`` of the JAX
    composition on the unpadded chain, within GRAD_REL of each gradient's
    max-abs; the padded entries' gradients of ax, av and ar are exactly 0."""
    net, params, x, v, refs = _setup(jax.random.PRNGKey(11), n=9, m=7, act=act, hidden=hidden)
    mids, ax, av, ar = _kernel_inputs(net, params, x, v, refs)
    mids_m, M, u, _ = _collapse(mids)
    M = 0.5 * (M + M.T)
    mask = jnp.asarray([1, 0, 1, 1, 1, 0, 1], jnp.float32)
    f = lambda mm, M_, u_, ax_, av_, ar_: _jnp_packed_composition(_ACTIVATIONS[act], mm, M_, u_, ax_, av_,
                                                                  ar_, mask)
    rs = np.random.default_rng(17)
    w0 = ax.shape[-1]
    g = [rs.normal(size=s).astype(np.float32) for s in (ax.shape[:2], ax.shape[:2], ax.shape)]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(f, mids_m, M, u, ax, av, ar)
        want_mids, want_M, want_u, *want_x = vjp({"value": jnp.asarray(g[0]), "hess": jnp.asarray(g[1]),
                                                  "s_dz0": jnp.asarray(g[2])})
    unpadded = [(T(W), T(b)) for W, b in mids_m]
    _, layers, Mp, up = pk.pad_collapsed(unpadded, T(M), T(u), width)
    pad = lambda a: torch.nn.functional.pad(T(a), (0, width - w0))
    got_mids, got_M, got_u, *got_x = pk.mlp_pairwise_sums_packed_bwd_plain(
        layers, Mp, up, act, pad(ax), pad(av), pad(ar), T(mask), T(g[0]), T(g[1]), pad(g[2]))
    flat = torch.cat([t.reshape(-1) for pair in got_mids for t in pair] + [got_M.reshape(-1), got_u])
    got_mids, got_M, got_u = pk.unpad_collapsed(flat, unpadded, T(M), width)

    def close(got, want, what):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, what
        assert np.abs(got - want).max() <= GRAD_REL * max(np.abs(want).max(), 1e-30), what

    close(got_M + got_M.T, want_M + want_M.T, "M")
    close(got_u, want_u, "u")
    for (gw, gb), (ww, wb) in zip(got_mids, want_mids):
        close(gw, ww, "W")
        close(gb, wb, "b")
    for got, want, what in zip(got_x, want_x, ("ax", "av", "ar")):
        close(got[..., :w0], want, what)
        assert not bool(got[..., w0:].any()), what


# -- K6's k6_kernel -----------------------------------------------------------------


def _tile_sums(act, mids, ax, av, ar, mask):
    """The JAX tile math's square-head sums {value [nt, n], hess [nt, n],
    s_dz0 [nt, n, w0]} over the refs, from the layers after the first."""
    w0 = ax.shape[-1]
    dummy0 = (jnp.zeros((2, w0)), jnp.zeros((w0,)))
    out = jbw._tile_stats([dummy0] + list(mids), _ACTIVATIONS[act], jnp.float32, jnp.swapaxes(ax, 0, 1),
                          jnp.swapaxes(ar, 0, 1), jnp.swapaxes(av, 0, 1), None, None, None, mask)
    n, nt = ax.shape[1], ax.shape[0]
    out = {k: w.reshape((n, nt) + w.shape[1:]) for k, w in out.items()}
    return {"value": out["value"].T, "hess": out["hess"].T, "s_dz0": jnp.swapaxes(out["s_dz0"], 0, 1)}



def test_k6_plan_and_splits_are_the_header_comments():
    """The KMV main path (w0 = 20, seven 20 x 20 layers, feature layer 20 x
    128): the feature layer in 7 chunks of 20 (128 padded to 140), 224 lanes
    (56 points) a block and 216,944 B (47,040 of weights and accumulators,
    169,344 of rows, 560 of ref-row partials), one block an SM; 256 lanes
    would need 241,216 B; 1 ref split for 132 resident blocks on 7 x 36 point
    blocks."""
    plan = pk.plan("k6", [20] * 8 + [128])
    assert plan == pk.Plan("k6", 20, 224, 7, 216_944, 56)
    assert 2 * 4 * 14 * 420 == 47_040 and 4 * 9 * 56 * 84 == 169_344 and 4 * 7 * 20 == 560
    assert pk.k6_shared_bytes(20, 256, 7, 7) == 241_216 > 227 * 1024
    assert plan.shared_bytes + 1024 <= 228 * 1024 < 2 * (plan.shared_bytes + 1024)
    assert pk.k7_splits(7, 2_000, 2_000, plan.points, 132) == 1 and 7 * -(-2_000 // 56) == 252
    for text in ("47,040 B of weights and accumulators + 169,344 B of rows + 560 B of ref-row partials = "
                 "216,944 B", "1 split (252 blocks, 1.91 waves)", "4 (L + chunks) (W^2 + W) bytes",
                 "128 -> 140 at W = 20, 7 chunks", "Barriers a ref: L + chunks + 2"):
        assert text in HEADER, text


@pytest.mark.parametrize("feature", [4, 100, 128])
@pytest.mark.parametrize("n_layers", [0, 7, 15])
@pytest.mark.parametrize("width", pk.K7_WIDTHS)
def test_k6_plan_fits_shared_memory(width, n_layers, feature):
    """k6_kernel's plan at every width instantiation, depth and feature
    width: the feature layer in ceil(F / width) chunks, the most lanes a
    block (of K6_THREADS) whose shared memory fits 227 KB, or a refusal
    where none does (15 layers at width 32 and 100 or 128 features)."""
    widths = [width] * (n_layers + 1) + [feature]
    chunks = -(-feature // width)
    fits = [t for t in pk.K6_THREADS if pk.k6_shared_bytes(width, t, n_layers, chunks) <= 227 * 1024]
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            pk.plan("k6", widths)
        return
    plan = pk.plan("k6", widths)
    row = {8: 12, 16: 20, 20: 20, 24: 28, 32: 36}[width]
    weights = (n_layers + chunks) * (width * width + width)
    want = 4 * (2 * weights + (max(n_layers, 1) + 2) * (plan.threads // 4) * (4 * row + 4)
                + plan.threads // 32 * width)
    assert plan == pk.Plan("k6", width, fits[0], chunks, want, fits[0] // 4) and plan.threads % 32 == 0


def test_k6_takes_chains_by_their_widths_before_the_feature_layer():
    """``choose`` takes K6 through k6_kernel where every width before the
    feature layer is <= 64 (on eight lanes a pair past 32) and the plan
    fits; a width past 64 goes to pw_bwd_kernel."""
    k6 = lambda widths: pk.choose(widths, "on")[1] == "k6"
    assert k6([20] * 8 + [128]) and k6([32, 32, 4096]) and k6([2, 128])
    assert k6([64, 64, 128]) and k6([20, 33, 8]) and k6([64] * 5 + [128])
    assert not k6([72, 72, 16]) and not k6([20, 65, 8])
    assert not k6([64] * 6 + [128])  # 5 hidden layers: no octet plan fits
    with pytest.raises(ValueError, match="chain"):
        pk.choose([20], "on")
    assert pk.plan("k6", [12, 20, 17, 100]) == pk.plan("k6", [20, 20, 20, 100])
    assert pk.plan("k6", [40, 33, 8]) == pk.plan("k6", [48, 48, 8]) and pk.plan("k6", [20, 50, 64]).width == 64
    with pytest.raises(ValueError, match="widths <= 64"):
        pk.plan("k6", [72, 72, 16])
    with pytest.raises(ValueError, match="shared memory"):
        pk.plan("k6", [64] * 6 + [128])
    with pytest.raises(ValueError, match="chain"):
        pk.plan("k6", [20])


@pytest.mark.parametrize("feature", [4, 100, 128])
@pytest.mark.parametrize("n_layers", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("width", [48, 64])
def test_k6_octet_plan_fits_shared_memory(width, n_layers, feature):
    """k6_kernel on eight lanes a pair: the feature layer in ceil(F / W)
    chunks, the most lanes a block (of K6_THREADS) whose shared memory fits
    227 KB, 4 (2 (L + chunks)(W^2 + W) + k6_rows(L) (T / 8)(4 R + 8) + (T /
    32) W) bytes with R = W + 4, or a refusal where none does: 5 hidden
    layers at width 64 and 100 or 128 features."""
    widths = [width] * (n_layers + 1) + [feature]
    chunks = -(-feature // width)
    size = lambda t: 4 * (2 * (n_layers + chunks) * (width * width + width)
                          + (max(n_layers, 1) + 2) * (t // 8) * (4 * (width + 4) + 8) + t // 32 * width)
    fits = [t for t in pk.K6_THREADS if size(t) <= 227 * 1024]
    refused = width == 64 and n_layers == 5 and feature > 4
    assert bool(fits) != refused and (pk.choose(widths, "on")[1] == "k6") != refused
    if refused:
        with pytest.raises(ValueError, match="shared memory"):
            pk.plan("k6", widths)
        return
    plan = pk.plan("k6", widths)
    assert plan == pk.Plan("k6", width, fits[0], chunks, size(fits[0]), fits[0] // 8) and plan.threads % 32 == 0
    assert plan.shared_bytes == pk.k6_shared_bytes(width, plan.threads, n_layers, chunks)
    assert plan.points == plan.threads // 8 and pk.k6_lanes(width) == 8


@pytest.mark.parametrize("widths, k6, tile", [
    ([64, 64, 128], True, True), ([64] * 4 + [128], True, False), ([64] * 6 + [128], False, False),
    ([1] + [56] * 6 + [8], False, True), ([40] + [1] * 12 + [1], False, True)])
def test_k6_takes_past_32_the_chains_its_octet_plan_fits(widths, k6, tile):
    """At widths 33-64 before the feature layer ``choose`` asks whether the
    octet plan fits: pw_bwd_kernel's 32-point tile (four streams,
    ``shared_bytes``) holds some deep chains that the octets, which pad
    every layer to 64, do not (56 -> 64 six times, 1 -> 48 twelve times); a
    chain neither holds raises, naming the shared memory."""
    assert pk.choose(widths, "on")[1] == ("k6" if k6 else "pw_bwd")
    assert (pk.shared_bytes(widths, 4) <= 227 * 1024) == tile
    if not k6:
        with pytest.raises(ValueError, match="shared memory"):
            pk.plan("k6", widths)
        if not tile:
            with pytest.raises(ValueError, match="shared memory"):
                pk.plan("pw_bwd", widths)


def test_k6_octet_plan_and_splits_are_the_header_comments():
    """64 -> 64 -> 128 (the KMV MLP at hidden 64 x 2): the feature layer in 2
    chunks of 64, 256 lanes (32 points) a block and 209,408 B (99,840 of
    weights and accumulators, 107,520 of rows, 2,048 of ref-row partials),
    one block an SM, and 2 ref splits for 132 resident blocks on 7 x 63
    point blocks; hidden 64 x 3: 160 lanes, 224,000 B (192 lanes would need
    242,176 B); 64 lanes at 3 hidden layers, 32 at 4; the row set of a pair
    4 R + 8 floats, so that the 4 pairs of a warp start 24 banks apart."""
    plan = pk.plan("k6", [64, 64, 128])
    assert plan == pk.Plan("k6", 64, 256, 2, 209_408, 32)
    assert 2 * 4 * 3 * 4_160 == 99_840 and 4 * 3 * 32 * 280 == 107_520 and 4 * 8 * 64 == 2_048
    assert plan.shared_bytes + 1024 <= 228 * 1024 < 2 * (plan.shared_bytes + 1024)
    assert pk.k7_splits(7, 2_000, 2_000, plan.points, 132) == 2 and 7 * -(-2_000 // 32) == 441
    assert pk.plan("k6", [64] * 3 + [128]) == pk.Plan("k6", 64, 160, 2, 224_000, 20)
    assert pk.k6_shared_bytes(64, 192, 2, 2) == 242_176 > 227 * 1024
    assert [pk.plan("k6", [64] * (d + 1) + [128]).threads for d in (3, 4)] == [64, 32]
    assert (4 * 68 + 8) % 32 == 24 and (4 * 52 + 8) % 32 == 24 and pk.K6_WIDTHS[-2:] == (48, 64)
    assert 4 * 4_096 + 3 * 4 * 64 * 128 + 2 * 4 * 4_096 == 147_456
    for text in ("99,840 B of weights and accumulators + 107,520 B of rows + 2,048 B of ref-row partials = "
                 "209,408 B", "2 splits (882 blocks, 6.68 waves)", "4 R + 8 floats", "24 banks apart",
                 "192 lanes would need 242,176 B", "= 147,456 FMAs a pair"):
        assert text in HEADER, text


@pytest.mark.parametrize("width,hidden,feature", [(48, (40, 33), 100), (64, (64,), 128), (64, (50, 64, 17), 130)])
def test_k6_octet_weight_layout_round_trips(width, hidden, feature):
    """pad_square and unpad_square at the octet widths: chunks of `width`
    feature columns ([width, width] of W_F, then its biases), the hidden
    layers padded to [width, width]; reading the layout back gives the
    unpadded chain, and the padded entries are zeros."""
    gen = torch.Generator().manual_seed(1)
    dims = (7,) + hidden + (feature,)
    mids = [(torch.randn((a, b), generator=gen), torch.randn(b, generator=gen)) for a, b in zip(dims, dims[1:])]
    flat, padded = pk.pad_square(mids, width)
    chunks = -(-feature // width)
    assert [tuple(W.shape) for W, _ in padded] == [(width, width)] * len(hidden) + [(width, chunks * width)]
    assert flat.numel() == (len(hidden) + chunks) * (width * width + width)
    assert torch.equal(pk.pack_square(padded, width), flat)
    last = flat[(len(hidden) + chunks - 1) * (width * width + width):]  # the last chunk
    cols = feature - (chunks - 1) * width
    assert torch.equal(last[: width * width].view(width, width)[: dims[-2], :cols], mids[-1][0][:, -cols:])
    assert not bool(last[: width * width].view(width, width)[:, cols:].any())
    for (W, b), (Wu, bu) in zip(pk.unpad_square(flat, mids, width), mids):
        assert torch.equal(W, Wu) and torch.equal(b, bu)


def test_k6_weight_layout_round_trips():
    """pad_square lays out every hidden (W_k, b_k), then each chunk of
    `width` feature columns ([width, width] of W_F, then its biases);
    unpad_square reads the unpadded chain back out of that layout."""
    gen = torch.Generator().manual_seed(0)
    mids = [(torch.randn((12, 16), generator=gen), torch.randn(16, generator=gen)),
            (torch.randn((16, 9), generator=gen), torch.randn(9, generator=gen)),
            (torch.randn((9, 50), generator=gen), torch.randn(50, generator=gen))]
    flat, padded = pk.pad_square(mids, 16)
    assert [tuple(W.shape) for W, _ in padded] == [(16, 16), (16, 16), (16, 64)]
    assert flat.numel() == (2 + 4) * (16 * 16 + 16)
    chunk1 = flat[3 * 272: 4 * 272]  # the second chunk: columns 16..31 of W_F, then b_F[16:32]
    assert torch.equal(chunk1[:256].view(16, 16)[:9], mids[2][0][:, 16:32])
    assert torch.equal(chunk1[256:], mids[2][1][16:32])
    assert torch.equal(pk.pack_square(padded, 16), flat)
    for (W, b), (Wu, bu) in zip(pk.unpad_square(flat, mids, 16), mids):
        assert torch.equal(W, Wu) and torch.equal(b, bu)


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("hidden,feat,width", [((16, 16), 8, 16), ((16, 16), 20, 24), ((8, 8, 8), 12, 20),
                                               ((20, 32, 8, 20), 30, 32), ((12,), 7, 20), ((40, 33), 50, 48),
                                               ((64, 50), 70, 64)])
def test_k6_zero_padding_leaves_the_vjp_unchanged(act, hidden, feat, width):
    """K6's plain version on the chain padded as k6_kernel takes it (hidden
    layers to `width`, the feature layer to whole chunks of `width`
    columns), its gradients passed through k6_kernel's weight layout
    (``pack_square``, ``unpad_square``), gives ``jax.vjp`` of the JAX tile
    math on the unpadded chain within GRAD_REL of each gradient's max-abs;
    the padded entries' gradients of ax, av and ar are exactly 0.  (12,):
    no hidden layer after the first; widths 48 and 64: the octet
    instantiations' padding (70 features in two chunks of 64)."""
    net, params, x, v, refs = _setup(jax.random.PRNGKey(11), n=9, m=7, act=act, hidden=hidden, feat=feat)
    mids, ax, av, ar = _kernel_inputs(net, params, x, v, refs)
    mask = jnp.asarray([1, 0, 1, 1, 1, 0, 1], jnp.float32)
    w0 = ax.shape[-1]
    f = lambda mids_, ax_, av_, ar_: _tile_sums(act, mids_, ax_, av_, ar_, mask)
    rs = np.random.default_rng(17)
    g = [rs.normal(size=s).astype(np.float32) for s in (ax.shape[:2], ax.shape[:2], ax.shape)]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(f, mids, ax, av, ar)
        want_mids, *want_x = vjp({"value": jnp.asarray(g[0]), "hess": jnp.asarray(g[1]),
                                  "s_dz0": jnp.asarray(g[2])})
    unpadded = [(T(W), T(b)) for W, b in mids]
    _, padded = pk.pad_square(unpadded, width)
    pad = lambda a: torch.nn.functional.pad(T(a), (0, width - w0))
    got_padded, *got_x = pk.mlp_pairwise_sums_bwd_plain(padded, act, pad(ax), pad(av), pad(ar), T(mask),
                                                        T(g[0]), T(g[1]), pad(g[2]))
    got_mids = pk.unpad_square(pk.pack_square(got_padded, width), unpadded, width)

    def close(got, want, what):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, what
        assert np.abs(got - want).max() <= GRAD_REL * max(np.abs(want).max(), 1e-30), what

    for (gw, gb), (ww, wb) in zip(got_mids, want_mids):
        close(gw, ww, "W")
        close(gb, wb, "b")
    for got, want, what in zip(got_x, want_x, ("ax", "av", "ar")):
        close(got[..., :w0], want, what)
        assert not bool(got[..., w0:].any()), what


# -- K5's k5_kernel -----------------------------------------------------------------


def test_k5_plan_and_splits_are_the_header_comments():
    """The KMV main path (w0 = 20, seven 20 x 20 layers, feature layer 20 x
    128): the feature layer in 32 chunks of 4, 128 points a block and
    104,432 B (22,512 of weights, 81,920 of act' and s_dz0 rows), two blocks
    an SM, and 7 ref splits for 264 resident blocks on 7 x 16 point blocks,
    as K7's."""
    plan = pk.plan("k5", [20] * 8 + [128])
    assert plan == pk.Plan("k5", 20, 128, 32, 104_432, 128)
    assert 4 * (7 * 420 + 21 * 128) == 22_512 and 4 * 8 * 128 * 20 == 81_920
    assert 2 * (plan.shared_bytes + 1024) <= 228 * 1024 < 3 * (plan.shared_bytes + 1024)
    assert pk.k7_splits(7, 2_000, 2_000, plan.threads, 2 * 132) == 7 and 7 * 7 * -(-2_000 // 128) == 784
    assert 3 * 7 * 400 + 3 * 2_560 + 2_560 + 7 * 400 == 21_440 and 700 + 640 + 640 + 700 == 2_680
    assert pk.K5_CHUNK == 4
    for text in ("22,512 B of weights + 81,920 B of act' and s_dz0 rows = 104,432 B",
                 "7 splits (784 blocks, 2.97 waves)", "4 (L (W^2 + W) + (W + 1) F4) bytes",
                 "4 (L + 1) `threads` R bytes", "= 21,440 (K7: 12,000)", "2,680 (K7: 1,500)"):
        assert text in HEADER, text


@pytest.mark.parametrize("feature", [4, 100, 128, 130])
@pytest.mark.parametrize("n_layers", [0, 7, 15])
@pytest.mark.parametrize("width", pk.K7_WIDTHS)
def test_k5_plan_fits_shared_memory(width, n_layers, feature):
    """k5_kernel's plan at every width instantiation, depth and feature
    width: the feature layer in ceil(F / 4) chunks, the most points a block
    (of K7_THREADS) whose shared memory fits 227 KB: the padded weights,
    then K7's rows of act' and s_dz0 sums.  Every one of these fits."""
    plan = pk.plan("k5", [width] * (n_layers + 1) + [feature])
    chunks = -(-feature // 4)
    row = {8: 12, 16: 20, 20: 20, 24: 28, 32: 36}[width]
    size = lambda t: 4 * (n_layers * (width * width + width) + (width + 1) * 4 * chunks
                          + (n_layers + 1) * t * row)
    fits = [t for t in pk.K7_THREADS if size(t) <= 227 * 1024]
    assert plan == pk.Plan("k5", width, fits[0], chunks, size(fits[0]), fits[0])
    assert plan.shared_bytes == pk.k5_shared_bytes(width, plan.threads, n_layers, chunks)


@pytest.mark.parametrize("widths", [[20] * 8 + [128], [32, 32, 4096], [2, 128], [64, 64, 128], [20, 33, 8],
                                    [20], [12, 20, 17, 100], [8, 8, 8, 130], [33, 8, 8], [8, 40]])
def test_k5_takes_the_chains_k6_takes(widths):
    """Under "on", ``choose`` takes K5 through k5_kernel for those of the
    chains K6 takes whose every width before the feature layer is <= 32,
    whatever the feature width: k5_kernel has no instantiation past 32,
    where K6 also runs k6_kernel on eight lanes a pair (48, 64)."""
    if len(widths) < 2:
        with pytest.raises(ValueError, match="chain"):
            pk.choose(widths, "on")
        return
    k5, k6 = pk.choose(widths, "on")
    assert (k5 == "k5") == (max(widths[:-1]) <= 32) and k5 in ("k5", "pw_fwd")
    assert k5 != "k5" or k6 == "k6"
    assert (k6 == "k6") == (max(widths[:-1]) <= 64) and k6 in ("k6", "pw_bwd")


def test_k5_plan_refuses_widths_past_32_and_non_chains():
    assert pk.plan("k5", [12, 20, 17, 100]) == pk.plan("k5", [20, 20, 20, 100])
    with pytest.raises(ValueError, match="widths <= 32"):
        pk.plan("k5", [64, 64, 128])
    with pytest.raises(ValueError, match="chain"):
        pk.plan("k5", [20])
    with pytest.raises(ValueError, match="shared memory"):
        pk.plan("k5", [8, 8192])


def test_k5_weight_layout_round_trips():
    """pad_k5 lays out every hidden (W_k, b_k), then W_F [width, F4]
    row-major and b_F [F4] (F4 the feature width rounded up to 4); reading
    that layout back gives the unpadded chain, with zeros where it was
    padded."""
    gen = torch.Generator().manual_seed(0)
    mids = [(torch.randn((12, 16), generator=gen), torch.randn(16, generator=gen)),
            (torch.randn((16, 9), generator=gen), torch.randn(9, generator=gen)),
            (torch.randn((9, 50), generator=gen), torch.randn(50, generator=gen))]
    flat, padded = pk.pad_k5(mids, 16)
    assert [tuple(W.shape) for W, _ in padded] == [(16, 16), (16, 16), (16, 52)]
    lw = 16 * 16 + 16
    assert flat.numel() == 2 * lw + 17 * 52
    read = []
    for k in range(2):
        layer = flat[k * lw: (k + 1) * lw]
        read.append((layer[:256].view(16, 16), layer[256:]))
    feature = flat[2 * lw:]
    read.append((feature[: 16 * 52].view(16, 52), feature[16 * 52:]))
    for (W, b), (Wp, bp), (Wu, bu) in zip(read, padded, mids):
        assert torch.equal(W, Wp) and torch.equal(b, bp)
        assert torch.equal(W[: Wu.shape[0], : Wu.shape[1]], Wu) and torch.equal(b[: bu.shape[0]], bu)
        assert not bool(W[Wu.shape[0]:].any()) and not bool(W[:, Wu.shape[1]:].any())
        assert not bool(b[bu.shape[0]:].any())


@pytest.mark.parametrize("act", ["tanh", "silu", "softplus"])
@pytest.mark.parametrize("hidden,feat,width", [((16, 16), 8, 16), ((16, 16), 20, 24), ((8, 8, 8), 12, 20),
                                               ((20, 32, 8, 20), 30, 32), ((12,), 7, 20), ((16,), 130, 16)])
def test_k5_zero_padding_leaves_the_sums_unchanged(act, hidden, feat, width):
    """K5's plain version on the chain padded as k5_kernel takes it (hidden
    layers to `width`, the feature layer to a multiple of 4 features, the
    points with zero features) gives the JAX tile math's sums on the
    unpadded chain within GRAD_REL of each output's max-abs; the padded
    features' s_dz0 are exactly 0.  (12,): no hidden layer after the first;
    130 features are padded to 132."""
    net, params, x, v, refs = _setup(jax.random.PRNGKey(11), n=9, m=7, act=act, hidden=hidden, feat=feat)
    mids, ax, av, ar = _kernel_inputs(net, params, x, v, refs)
    mask = jnp.asarray([1, 0, 1, 1, 1, 0, 1], jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = _tile_sums(act, mids, ax, av, ar, mask)
    w0 = ax.shape[-1]
    _, padded = pk.pad_k5([(T(W), T(b)) for W, b in mids], width)
    assert padded[-1][0].shape == (width, -(-feat // 4) * 4)
    pad = lambda a: torch.nn.functional.pad(T(a), (0, width - w0))
    got = pk.mlp_pairwise_sums_plain(padded, act, pad(ax), pad(av), pad(ar), T(mask))
    for k in ("value", "hess", "s_dz0"):
        g, w = got[k][..., :w0] if k == "s_dz0" else got[k], np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * max(np.abs(w).max(), 1e-30), k
    assert not bool(got["s_dz0"][..., w0:].any())


# -- the launchers' host side ----------------------------------------------------------


def _launch(kernel, widths, seed=3, nt=2, n=5, m=3):
    """A validated launch of `kernel` on the square-head chain `widths` (K7
    and K8: its collapsed head) with CPU tensors, and its plan."""
    gen = torch.Generator().manual_seed(seed)
    mids = [(torch.randn((a, b), generator=gen), torch.randn(b, generator=gen)) for a, b in zip(widths, widths[1:])]
    w0 = widths[0]
    ax, av, ar = torch.randn((nt, n, w0), generator=gen), torch.randn((nt, n, w0), generator=gen), \
        torch.randn((nt, m, w0), generator=gen)
    cot = (torch.randn((nt, n), generator=gen), torch.randn((nt, n), generator=gen), torch.randn((nt, n, w0), generator=gen))
    head = None
    if kernel in ("k7", "k8"):
        (WF, bF), mids = mids[-1], mids[:-1]
        head = (WF @ WF.T, 2.0 * (WF @ bF))
    L = pk._Launch(kernel, mids, "tanh", ax, av, ar, torch.ones(m), head=head, cot=cot)
    return L, pk.plan(kernel, L.widths), mids, head


@pytest.mark.parametrize("kernel,widths", [("k5", [12, 20, 17, 100]), ("pw_fwd", [40, 33, 8]),
                                           ("k6", [12, 20, 17, 100]), ("k6", [40, 33, 70]),
                                           ("pw_bwd", [72, 72, 16]), ("k7", [20, 20, 24, 8]), ("k8", [20, 20, 24, 8])])
def test_launch_lays_out_the_weights_each_kernel_reads(kernel, widths):
    """``_Launch.weights`` gives each kernel its layout (k5 ``pad_k5``, k6
    ``pad_square``, k7 and k8 ``pad_collapsed``, the tile kernels params
    [W_k, b_k] and params_t [W_k^T] unpadded), and for the backward kernels
    ``_Launch.weight_grads`` reads that layout back to the unpadded layers
    (K8: and M, u)."""
    L, plan, mids, head = _launch(kernel, widths)
    weights, weights_t = L.weights(plan)
    padded = {"k5": lambda: pk.pad_k5(mids, plan.width)[0], "k6": lambda: pk.pad_square(mids, plan.width)[0],
              "k7": lambda: pk.pad_collapsed(mids, *head, plan.width)[0],
              "k8": lambda: pk.pad_collapsed(mids, *head, plan.width)[0]}
    if kernel in padded:
        assert plan.width > 0 and weights_t is None and torch.equal(weights, padded[kernel]())
    else:
        assert plan.width == 0 and torch.equal(weights, torch.cat([torch.cat([W.reshape(-1), b]) for W, b in mids]))
        assert torch.equal(weights_t, torch.cat([W.T.reshape(-1) for W, _ in mids]))
    if kernel in ("k6", "pw_bwd", "k8"):
        back = L.weight_grads(plan, weights)
        assert all(torch.equal(W, Wu) and torch.equal(b, bu) for (W, b), (Wu, bu) in zip(back[0], mids))
        assert len(back) == (3 if kernel == "k8" else 1)
        if kernel == "k8":
            assert torch.equal(back[1], head[0]) and torch.equal(back[2], head[1])


def test_launch_refuses_malformed_inputs():
    """The launchers' checks before any library call: the activation, the
    layer count, the chain, the cotangents and the collapsed head's M and u."""
    L, _, mids, head = _launch("k8", [20, 20, 24, 8])
    ax, av, ar, mask, *cot = L.tensors
    cases = [(dict(act_name="gelu"), "derivative table"), (dict(layers=[mids[0]] * 17), "at most 16 layers"),
             (dict(layers=mids[::-1]), "do not chain"), (dict(cot=(cot[0], cot[1][:, :2], cot[2])), "cotangents"),
             (dict(head=(head[0], head[1][:3])), "u must be"), (dict(head=(head[0][:3], head[1][:3])), "square"),
             (dict(mask=mask[:2]), "mask must be")]
    for change, match in cases:
        args = dict(name="K8", layers=mids, act_name="tanh", ax=ax, av=av, ar=ar, mask=mask, head=head, cot=cot)
        args.update(change)
        with pytest.raises(ValueError, match=match):
            pk._Launch(**args)


def test_ctypes_bindings_are_the_c_prototypes():
    """``ENTRIES`` binds every ``extern "C"`` function of csrc/pairwise.cu
    with its own argument and return types (pointers to floats and the
    stream as c_void_p)."""
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "void": None, "int*": ctypes.POINTER(ctypes.c_int),
             "long long*": ctypes.POINTER(ctypes.c_longlong), "float*": ctypes.c_void_p, "void*": ctypes.c_void_p}
    source = HEADER.replace("\n", " ")
    protos = re.findall(r'extern "C" ([a-z ]+?) (\w+)\(([^)]*)\)', source)
    assert {name for _, name, _ in protos} == set(pk.ENTRIES)
    for ret, name, params in protos:
        types = [ctype[re.sub(r"^const |\s+\w+$", "", p.strip()).replace(" *", "*")] for p in params.split(",")
                 if p.strip()]
        assert pk.ENTRIES[name] == (types, ctype[ret]), name
