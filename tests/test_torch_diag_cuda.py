"""S1-S3's kernels against their plain versions on the card.

Without a CUDA device every test skips.  On the card:

    python -m pytest -q tests/test_torch_diag_cuda.py
"""

import numpy as np
import pytest
import torch

from pde_inverse_torch.ops.cuda import mma_tf32
from pde_inverse_torch.ops.cuda import pairwise as pw
from pde_inverse_torch.scripts import diag_packed_onchip as s1
from pde_inverse_torch.scripts import microtest_blkdiag_dot as s3
from pde_inverse_torch.scripts import microtest_sublane_reduce as s2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_s1_diag_ok_on_the_card(cuda, capsys):
    before = [fn.launches for fn in pw.S1_WRAPPERS]
    out = s1.run("cuda")
    assert out["ok"], capsys.readouterr().out
    assert all(fn.launches > b for fn, b in zip(pw.S1_WRAPPERS, before))
    # kernels vs plain: pair rows exact; sums within f32 reordering
    assert out["max_abs_err"] < 1e-3


def test_sum_rows_kernel_is_fixed_order(cuda):
    part = torch.tensor([[1.0, 1e8], [1e-8, -1e8], [2.0, 1.0]], device=cuda)
    assert pw.sum_rows(part).tolist() == [3.0, 1.0]
    x = torch.randn((2048, 120), device=cuda)
    assert torch.equal(pw.sum_rows(x), pw.sum_rows_plain(x))


# ragged shapes (one chunk, a few, a cluster of 8 blocks), then the partial
# rows K7 and K8 finish at the KMV MLP's full width: K8's weight gradients
# (4 splits x 7 stamps x 32 point blocks, 3,360 weights), its ax/av and ar
# cotangents, K7's sums (7 splits)
SUM_SHAPES = [(r, n) for r in (1, 3, 63, 64, 65, 2049) for n in (1, 7, 33, 120, 2940)]
KMV_PARTIALS = [(896, 3360), (4, 560_000), (32, 280_000), (7, 308_000)]


@pytest.mark.parametrize("rows,len_", SUM_SHAPES + KMV_PARTIALS)
def test_sum_rows_is_bitwise_its_plain_version(cuda, rows, len_):
    gen = torch.Generator().manual_seed(rows * 31 + len_)
    x = (torch.randn((rows, len_), generator=gen) * 100.0).to(cuda)
    before = pw.sum_rows.launches
    got = pw.sum_rows(x)
    assert pw.sum_rows.launches == before + 1
    assert torch.equal(got, pw.sum_rows_plain(x))
    assert torch.equal(pw.sum_rows(x), got)  # two calls, bit for bit


def test_sum_rows_plan_c_twin_is_the_python_plan(cuda):
    for rows, len_ in SUM_SHAPES + KMV_PARTIALS + [(2048, 120), (100_000, 5)]:
        for slab in (32, 16):
            assert pw.sum_rows_plan_c(rows, len_, slab) == pw.sum_rows_plan(rows, len_, slab)


def test_sum_rows_counts_its_launches_inside_k5_to_k8(cuda):
    """sum_rows finishes K5's and K7's partial rows once a call, K6's and
    K8's three times; the count, read from the library where it launches,
    includes them."""
    gen = torch.Generator().manual_seed(5)
    mids = [(torch.randn((4, 8), generator=gen).to(cuda), torch.randn(8, generator=gen).to(cuda)),
            (torch.randn((8, 6), generator=gen).to(cuda), torch.randn(6, generator=gen).to(cuda))]
    ax, av = (torch.randn((1, 10, 4), generator=gen).to(cuda) for _ in range(2))
    ar, mask = torch.randn((1, 9, 4), generator=gen).to(cuda), torch.ones(9, device=cuda)
    cot = [torch.randn((1, 10), generator=gen).to(cuda) for _ in range(2)] + [torch.randn_like(ax)]
    WF, bF = mids[-1]
    head = (mids[:-1], WF @ WF.T, 2.0 * (WF @ bF))
    for call, n in ((lambda: pw.mlp_pairwise_sums(mids, "tanh", ax, av, ar, mask), 1),
                    (lambda: pw.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *cot), 3),
                    (lambda: pw.mlp_pairwise_sums_packed(*head, "tanh", ax, av, ar, mask), 1),
                    (lambda: pw.mlp_pairwise_sums_packed_bwd(*head, "tanh", ax, av, ar, mask, *cot), 3)):
        before, in_library = pw.sum_rows.launches, pw._library().pw_sum_rows_launches()
        call()
        assert pw.sum_rows.launches == before + n
        assert pw._library().pw_sum_rows_launches() == in_library + n


@pytest.mark.parametrize("precision", ["tf32", "3xtf32"])
@pytest.mark.parametrize("rows,len_", SUM_SHAPES)
def test_column_sum_matches_plain(cuda, precision, rows, len_):
    """The tensor-core column sum against its plain version on the same
    rounded values: the products by 1.0 are exact, only the order of the f32
    sums inside a k-step differs (8 K 2^-24 of the column sum of |x|)."""
    gen = torch.Generator().manual_seed(rows * 17 + len_)
    x = torch.randn((rows, len_), generator=gen).to(cuda)
    before = mma_tf32.column_sum.launches
    got = mma_tf32.column_sum(x, precision)
    assert mma_tf32.column_sum.launches == before + 1
    want = mma_tf32.column_sum_plain(x, precision)
    scale = float(x.abs().sum(0).max())
    assert got.shape == (len_,) and float((got - want).abs().max()) <= 8 * rows * 2.0**-24 * scale
    assert torch.equal(mma_tf32.column_sum(x, precision), got)


@pytest.mark.parametrize("n,m,w0", [(16, 1, 20), (16, 48, 20), (16, 200, 20), (32, 48, 7), (5, 3, 33)])
def test_s1_pair_rows_is_bitwise_its_plain_version(cuda, n, m, w0):
    """A block a ref through pair_rows<3>; at w0 = 33 a block needs more
    than 48 KB of shared memory (the limit is raised once)."""
    gen = torch.Generator().manual_seed(n + m + w0)
    ax, av = (torch.randn((n, w0), generator=gen).to(cuda) for _ in range(2))
    ar = torch.randn((m, w0), generator=gen).to(cuda)
    before = pw.s1_pair_rows.launches
    for _ in range(2):
        z, dz = pw.s1_pair_rows(ax, av, ar)
        z_p, dz_p = pw.s1_pair_rows_plain(ax, av, ar)
        assert torch.equal(z, z_p) and torch.equal(dz, dz_p)
    assert pw.s1_pair_rows.launches == before + 2


@pytest.mark.parametrize("precision", ["tf32", "3xtf32"])
@pytest.mark.parametrize("shape", [(16, 8, 8), (17, 9, 13), (2048, 120, 120), (1, 2048, 120)])
@pytest.mark.parametrize("transpose_b", [False, True])
def test_tf32_kernel_matches_plain(cuda, precision, shape, transpose_b):
    """The kernel against the plain version on the same rounded operands:
    the products are exact in f32, only the order of the f32 sums differs
    (K terms, 3K with 3xTF32)."""
    M, K, N = shape
    gen = torch.Generator().manual_seed(sum(shape))
    a = torch.randn((M, K), generator=gen).to(cuda)
    b = torch.randn((N, K) if transpose_b else (K, N), generator=gen).to(cuda)
    got = mma_tf32.tf32_matmul(a, b, precision, transpose_b)
    want = mma_tf32.tf32_matmul_plain(a, b, precision, transpose_b)
    scale = (a.abs() @ (b.abs().T if transpose_b else b.abs()))
    assert float(((got - want).abs() / scale).max()) <= 8 * K * 2.0**-24


@pytest.mark.parametrize("precision", ["tf32", "3xtf32"])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("M", [1, 17, 2049])
@pytest.mark.parametrize("N", [1, 7, 120, 130])
@pytest.mark.parametrize("K", [1, 7, 121])
def test_tf32_kernel_at_edge_shapes(cuda, precision, transpose_b, M, N, K):
    """The staged kernel at rows, columns and k that end inside a block, a
    tile, a k-step and a 16-byte load (N = 130: a second column block of
    two columns), against the plain version as above; outputs past the
    edges stay unwritten."""
    gen = torch.Generator().manual_seed(M * 1_000 + N * 10 + K)
    a = torch.randn((M, K), generator=gen).to(cuda)
    b = torch.randn((N, K) if transpose_b else (K, N), generator=gen).to(cuda)
    before = mma_tf32.tf32_matmul.launches
    got = mma_tf32.tf32_matmul(a, b, precision, transpose_b)
    assert mma_tf32.tf32_matmul.launches == before + 1 and got.shape == (M, N)
    want = mma_tf32.tf32_matmul_plain(a, b, precision, transpose_b)
    scale = (a.abs() @ (b.abs().T if transpose_b else b.abs()))
    assert float(((got - want).abs() / scale).max()) <= 8 * K * 2.0**-24
    assert torch.equal(mma_tf32.tf32_matmul(a, b, precision, transpose_b), got)
    if K == 1 and precision == "tf32":  # one exact product: the rounding is the plain version's, bit for bit
        assert torch.equal(got, want)


def test_tf32_kernel_takes_strided_and_unaligned_rows(cuda):
    """Operands whose rows are not 16-byte aligned (K = 121, and a view one
    float into a buffer) take the scalar staging path."""
    gen = torch.Generator().manual_seed(3)
    buf = torch.randn(1 + 300 * 120, generator=gen).to(cuda)
    a = buf[1:].view(300, 120)  # contiguous, 4 bytes past an aligned start
    w = torch.randn((120, 120), generator=gen).to(cuda)
    for precision in ("tf32", "3xtf32"):
        got = mma_tf32.tf32_matmul(a, w, precision)
        want = mma_tf32.tf32_matmul_plain(a, w, precision)
        assert float(((got - want).abs() / (a.abs() @ w.abs())).max()) <= 8 * 120 * 2.0**-24


def test_s2_s3_within_their_bounds_on_the_card(cuda):
    before = (pw.sum_rows.launches, mma_tf32.column_sum.launches, mma_tf32.tf32_matmul.launches)
    out2, out3 = s2.run("cuda"), s3.run("cuda")
    assert out2["ok"] and out3["ok"]
    # S2 on two inputs a shape: six sums and twelve column sums (18); S3:
    # twelve products
    after = (pw.sum_rows.launches, mma_tf32.column_sum.launches, mma_tf32.tf32_matmul.launches)
    assert [a - b for a, b in zip(after, before)] == [6, 12, 12]
    rel = {(R, w, mode): r for R, w, mode, _, _, r in out2["rows"]}
    assert rel[(2048, 120, "dot_hi")] < rel[(2048, 120, "dot")]
    assert np.isfinite([r[-1] for r in out3["rows"]]).all()
