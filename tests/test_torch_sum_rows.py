"""The fixed-order row sum (``sum_rows``) and S2's column sum
(``column_sum``) on the CPU: their plan, their plain versions against numpy
float64 and against the JAX package's S2 kernel body in interpret mode, and
S1's pair rows against the JAX K5 helper in interpret mode.  The kernels
themselves run on the card (tests/test_torch_diag_cuda.py)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pde_inverse_tpu.ops.pallas import pairwise_kernel as jpk
from pde_inverse_torch.ops.cuda import mma_tf32
from pde_inverse_torch.ops.cuda import pairwise as pw
from pde_inverse_torch.ops.cuda import row_chunks as rc
from pde_inverse_torch.scripts import microtest_sublane_reduce as s2

torch.set_num_threads(1)

ROWS = (1, 3, 63, 64, 65, 2049)
LENS = (1, 7, 33, 120, 2940)
SHAPES = [(r, n) for r in ROWS for n in LENS]


def _jax_s2_script():
    """scripts/microtest_sublane_reduce.py of the JAX package, loaded by path
    (``scripts/`` is no package)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "microtest_sublane_reduce.py"
    spec = importlib.util.spec_from_file_location("jax_microtest_sublane_reduce", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows,len_", SHAPES)
@pytest.mark.parametrize("slab", [32, 16])
def test_plan_covers_every_row_and_column(rows, len_, slab):
    p = rc.sum_rows_plan(rows, len_, slab)
    assert p.chunk % 8 == 0 and p.chunk >= rc.SUM_ROWS_MIN_CHUNK
    assert (p.n_chunks - 1) * p.chunk < rows <= p.n_chunks * p.chunk
    assert p.n_chunks <= rc.SUM_ROWS_WARPS * rc.SUM_ROWS_CLUSTER
    # warps along the rows: the least power of two that holds a block's chunks
    assert p.warps_per_slab in (1, 2, 4, 8) and p.warps_per_slab >= min(p.n_chunks, rc.SUM_ROWS_WARPS)
    assert p.warps_per_slab == 1 or p.warps_per_slab // 2 < min(p.n_chunks, rc.SUM_ROWS_WARPS)
    assert (p.cluster - 1) * p.warps_per_slab < p.n_chunks <= p.cluster * p.warps_per_slab
    assert 1 <= p.cluster <= rc.SUM_ROWS_CLUSTER
    assert p.slabs_per_block * p.warps_per_slab == rc.SUM_ROWS_WARPS
    assert (p.blocks - 1) * p.slabs_per_block * slab < len_ <= p.blocks * p.slabs_per_block * slab
    assert (p.n_chunks == 1) == (rows <= p.chunk)


def test_plan_at_the_main_path_shapes():
    """K8's weight-gradient partials at the KMV MLP's full width (4 splits x
    7 stamps x 32 point blocks = 896 rows of 3,360 weights): 14 chunks of 64
    rows in clusters of 2 blocks; S2's [2048, 120]: 32 chunks, clusters of 4;
    K8's and K7's other partials have few rows and keep row order."""
    assert rc.sum_rows_plan(896, 3360) == rc.SumRowsPlan(64, 14, 8, 2, 1, 105)
    assert rc.sum_rows_plan(2048, 120) == rc.SumRowsPlan(64, 32, 8, 4, 1, 4)
    assert rc.sum_rows_plan(2048, 120, 16) == rc.SumRowsPlan(64, 32, 8, 4, 1, 8)
    assert rc.sum_rows_plan(5000, 120) == rc.SumRowsPlan(80, 63, 8, 8, 1, 4)
    assert rc.sum_rows_plan(4, 2 * 7 * 2000 * 20).n_chunks == 1
    assert rc.sum_rows_plan(32, 7 * 2000 * 20).n_chunks == 1
    assert rc.sum_rows_plan(7, 7 * 2000 * 22).n_chunks == 1
    assert rc.sum_rows_plan(100_000, 5).chunk == 1568
    with pytest.raises(ValueError, match="rows"):
        rc.sum_rows_plan(0, 5)


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_rows_within_a_chunk_add_in_row_order(rows):
    x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, 9)).astype(np.float32) * 1e4)
    want = torch.zeros(9)
    for r in range(rows):
        want = want + x[r]
    assert torch.equal(pw.sum_rows_plain(x), want)


def test_chunks_add_in_chunk_order():
    """130 rows: chunks of 64, 64 and 2, each summed from 0.0 in row order,
    then added in chunk order, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(130, 11)).astype(np.float32) * 1e3)
    sums = []
    for c0 in (0, 64, 128):
        s = torch.zeros(11)
        for r in range(c0, min(130, c0 + 64)):
            s = s + x[r]
        sums.append(s)
    want = (torch.zeros(11) + sums[0] + sums[1]) + sums[2]
    assert torch.equal(pw.sum_rows_plain(x), want)
    row_order = torch.zeros(11)
    for r in range(130):
        row_order = row_order + x[r]
    assert not torch.equal(want, row_order)  # the order is visible at 1e3 scale


def test_column_sum_plain_takes_k_steps_small_before_big():
    """3xTF32 on 72 rows (chunks of 64 and 8 rows, nine k-steps of 8): per
    k-step the small parts' sum, then the big parts', each in row order,
    added to the chunk's running sum; then the chunks in order."""
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(72, 5)).astype(np.float32))
    big = mma_tf32.round_tf32(x)
    small = mma_tf32.round_tf32(x - big)

    def step(part, k):
        t = part[8 * k]
        for r in range(8 * k + 1, 8 * k + 8):
            t = t + part[r]
        return t

    d = [torch.zeros(5), torch.zeros(5)]
    for k in range(9):
        d[k // 8] = d[k // 8] + step(small, k)
        d[k // 8] = d[k // 8] + step(big, k)
    assert torch.equal(mma_tf32.column_sum_plain(x, "3xtf32"), (torch.zeros(5) + d[0]) + d[1])
    assert torch.equal(mma_tf32.column_sum(x, "tf32"), mma_tf32.column_sum_plain(x, "tf32"))


@pytest.mark.parametrize("rows,len_", SHAPES)
def test_plain_sums_within_s2_bounds_against_float64(rows, len_):
    """sum_rows_plain and column_sum_plain in both precisions against a
    float64 sum, relative to the largest column sum of |x| (S2's
    rel(cancel-scale)), within S2's rounding bounds."""
    x = np.random.default_rng(rows * 7919 + len_).normal(size=(rows, len_)).astype(np.float32)
    ref = x.astype(np.float64).sum(0)
    scale = max(float(np.abs(x).sum(0).max()), 1e-30)
    xt = torch.from_numpy(x)
    for mode, got in (("sum", pw.sum_rows_plain(xt)), ("dot", mma_tf32.column_sum_plain(xt, "tf32")),
                      ("dot_hi", mma_tf32.column_sum_plain(xt, "3xtf32"))):
        assert got.shape == (len_,)
        err = float(np.abs(got.double().numpy() - ref).max()) / scale
        assert err <= s2.bound(mode, rows), (mode, err)


@pytest.mark.parametrize("mode", s2.MODES)
def test_plain_s2_modes_match_the_jax_kernel_body_in_interpret_mode(mode):
    """S2 at [2048, 120]: the port's plain mode against the JAX script's own
    kernel body run through an interpret-mode pallas_call on the CPU, where
    its dots run in float32, on the script's cancellation-heavy input and
    on one whose column sums do not cancel (there the bounds are under a
    thousandth of the sums, so a wrong or zero sum fails).  sum and dot_hi:
    within their own bound (both are float32-accurate); dot: TF32's
    rounding on the port's side, so dot's bound plus sum's."""
    jax_s2 = _jax_s2_script()
    kernel = pl.pallas_call(jax_s2.make_kernel(mode), interpret=True,
                            out_shape=jax.ShapeDtypeStruct((1, 120), jnp.float32))
    tol = s2.bound(mode, 2048) + (s2.bound("sum", 2048) if mode == "dot" else 0.0)
    for x in (s2.inputs(2048, 120), s2.sums_input(2048, 120)):
        with jax.default_device(jax.devices("cpu")[0]):
            want = np.asarray(kernel(jnp.asarray(x)))[0]
        got = s2.reduce_plain(mode, torch.from_numpy(x)).numpy()
        scale = float(np.abs(x).sum(0).max())
        assert float(np.abs(got.astype(np.float64) - want).max()) / scale <= tol
        # and both within the bound of the float64 sum
        ref = x.astype(np.float64).sum(0)
        assert float(np.abs(got - ref).max()) / scale <= s2.bound(mode, 2048)
        assert float(np.abs(want - ref).max()) / scale <= s2.bound("sum", 2048)
    assert float(np.abs(want).min()) > 1e3 * tol * scale  # the sums of the second input stand out


@pytest.mark.parametrize("m", [1, 48, 200])
def test_s1_pair_rows_plain_is_bitwise_the_jax_k5_helper(m):
    """The port's S1 pair rows against pairwise_kernel._pair_rows (K5's
    first-layer outer difference) in an interpret-mode pallas_call: its
    [m * n, w0] ref-major rows, reshaped to [m, n, w0], equal bit for bit."""
    rs = np.random.default_rng(m)
    ax, av = (rs.normal(size=(16, 20)).astype(np.float32) for _ in range(2))
    ar = rs.normal(size=(m, 20)).astype(np.float32)

    def kernel(ax_ref, ar_ref, av_ref, z_ref, dz_ref):
        z, dz = jpk._pair_rows(ax_ref[...], ar_ref[...], av_ref[...], jnp.float32)
        z_ref[...] = z
        dz_ref[...] = dz

    rows = jax.ShapeDtypeStruct((m * 16, 20), jnp.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        z_j, dz_j = pl.pallas_call(kernel, out_shape=(rows, rows), interpret=True)(
            jnp.asarray(ax), jnp.asarray(ar), jnp.asarray(av))
    z, dz = pw.s1_pair_rows_plain(*(torch.from_numpy(a) for a in (ax, av, ar)))
    assert np.array_equal(z.numpy(), np.asarray(z_j).reshape(m, 16, 20))
    assert np.array_equal(dz.numpy(), np.asarray(dz_j).reshape(m, 16, 20))
