"""The fixed summation order of the column sums over rows, the Python twin of
``csrc/row_chunks.cuh``: ``sum_rows`` (``ops/cuda/pairwise.py``, S2's ``sum``
mode and the row sum that finishes K5-K8's partial rows) and S2's
``column_sum`` (``ops/cuda/mma_tf32.py``).

out[e] = sum over rows r of part[r][e] is taken over chunks of `chunk`
consecutive rows (the last one ragged), each summed from 0.0 in row order,
then the chunk sums added in chunk order; the order depends on the shape
alone.  ``sum_rows_plan`` gives the chunks and the kernels' grid (checked
against the C plan, ``pairwise.sum_rows_plan_c``, on the card);
``chunked_sum`` adds in that order on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SumRowsPlan(NamedTuple):
    """How ``sum_rows`` (and S2's ``column_sum``) splits [rows, len]: chunks
    of `chunk` consecutive rows (a multiple of 8, at least 64), the last one
    ragged; a warp sums one chunk for a slab of columns, `warps_per_slab`
    warps of a block and `cluster` blocks of a thread-block cluster along the
    rows, `slabs_per_block` slabs a block and `blocks` blocks along the
    columns."""

    chunk: int
    n_chunks: int
    warps_per_slab: int
    cluster: int
    slabs_per_block: int
    blocks: int


SUM_ROWS_WARPS = 8  # warps a block
SUM_ROWS_CLUSTER = 8  # most blocks a cluster
# least rows a chunk: up to 64 partial rows (one a ref split) add in row
# order, so that a masked ref's row of zeros can be dropped without a change
SUM_ROWS_MIN_CHUNK = 64


def sum_rows_plan(rows: int, len_: int, slab: int = 32) -> SumRowsPlan:
    """The chunks of the fixed summation order of part [rows, len_] (`slab`
    columns a warp: 32 for ``sum_rows``, 16 for ``column_sum``): at most
    SUM_ROWS_WARPS x SUM_ROWS_CLUSTER chunks; rows <= chunk is row order."""
    if rows < 1 or len_ < 1:
        raise ValueError(f"sum_rows_plan: need rows, len >= 1, got {rows}, {len_}")
    most = SUM_ROWS_WARPS * SUM_ROWS_CLUSTER
    chunk = max(SUM_ROWS_MIN_CHUNK, -(-(-(-rows // most)) // 8) * 8)
    n_chunks = -(-rows // chunk)
    warps = 1
    while warps < min(n_chunks, SUM_ROWS_WARPS):
        warps *= 2
    per_block = SUM_ROWS_WARPS // warps
    return SumRowsPlan(chunk, n_chunks, warps, -(-n_chunks // warps), per_block,
                       -(-(-(-len_ // slab)) // per_block))


def chunked_sum(parts, chunk: int, step: int = 1):
    """The order of ``sum_rows_plan``: each [rows, len] tensor of `parts`
    zero-padded to whole chunks of `chunk` rows; per chunk, starting from
    0.0, the rows `step` at a time, every part in turn (with step > 1 a
    step's rows are first added to each other in row order, as one
    tensor-core k-step adds its products); then the chunk sums added in
    chunk order.  Zero rows add exactly 0.0 (a sum from +0.0 is never
    -0.0), so the padding changes no bit."""
    rows, n = parts[0].shape
    n_chunks = -(-rows // chunk)
    padded = [torch.nn.functional.pad(x, (0, 0, 0, n_chunks * chunk - rows))
              .view(n_chunks, chunk // step, step, n) for x in parts]
    s = torch.zeros((n_chunks, n), dtype=parts[0].dtype, device=parts[0].device)
    for k in range(chunk // step):
        for x in padded:
            t = x[:, k, 0]
            for i in range(1, step):
                t = t + x[:, k, i]
            s = s + t
    out = torch.zeros(n, dtype=s.dtype, device=s.device)
    for c in range(n_chunks):
        out = out + s[c]
    return out
