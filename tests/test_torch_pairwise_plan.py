"""K7's plan (``pde_inverse_torch.ops.cuda.pairwise``) on the CPU: the width
instantiation, the points a block, the shared memory and the ref splits
that the kernel's header comment (``csrc/pairwise.cu``) states, and the
zero-padding of the hidden layers, M and u to each instantiated width,
which must leave the collapsed-head sums unchanged.

The padding is held against the JAX package's independent collapsed-head
composition (tests/test_pallas_packed.py::_jnp_packed_composition) on the
unpadded layers, with the tolerance tests/test_torch_pairwise.py uses for
the sums (rtol 2e-4 / atol 1e-4, the JAX package's gate).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu.models.mlp import _ACTIVATIONS
from pde_inverse_torch.ops.cuda import pairwise as pk
from tests.test_pallas_packed import _collapse, _jnp_packed_composition
from tests.test_pallas_pairwise import _kernel_inputs, _setup

torch.set_num_threads(1)

SUM_RTOL, SUM_ATOL = 2e-4, 1e-4
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
    plan = pk.k7_plan(widths)
    assert plan.width == width and plan.width in pk.K7_WIDTHS
    assert plan.threads == 128
    assert plan.shared_bytes == pk.k7_shared_bytes(width, 128, len(widths) - 2)
    row = {8: 12, 16: 20, 20: 20, 24: 28, 32: 36}[width]  # rows 4 banks apart modulo 8
    n_layers = len(widths) - 2
    assert plan.shared_bytes == 4 * (n_layers * (width * width + width) + width * width + width
                                     + (n_layers + 1) * 128 * row)


def test_plan_refuses_widths_past_32_and_non_chains():
    with pytest.raises(ValueError, match="widths <= 32"):
        pk.k7_plan([20, 33, 20])
    with pytest.raises(ValueError, match="chain"):
        pk.k7_plan([20])


def test_plan_and_splits_are_the_header_comments():
    """The KMV main path (w0 = 20, seven 20 x 20 layers, M [20, 20]):
    95,360 B a block (13,440 of weights, 71,680 of act', 10,240 of s_dz0
    sums), 128 points a block, and 7 ref splits for 264 resident blocks on
    7 x 16 point blocks; the numbers the kernel's header comment states."""
    plan = pk.k7_plan([20] * 9)
    assert plan == pk.K7Plan(20, 128, 95_360)
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
    plan = pk.k7_plan([32] * 18)
    assert plan == pk.K7Plan(32, 64, 71_808 + 156_672)
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
