"""The KMV MLP step's work: the pairwise provider over every pair at a stamp.

Per pair (every sample with every ref at its stamp), the forward streams
three jets through the hidden layers and a reverse one (4 Fh FMAs), and the
collapsed head |f|^2 = a^T M a (2 wm); the VJP needs 12 Fh + 6 wm.  Fh is
the products of the hidden chain, wm the last hidden width squared, so the
feature width does not enter.  At 20 x 8 that is 12,000 + 36,000 = 48,000
FMAs a pair.  The first layer is per point (the pair's pre-activation is a
difference) and is not counted.
"""

from __future__ import annotations

from typing import Dict

from benchmark.work import hidden_widths, mlp_products


def pairwise_fmas(hidden) -> Dict[str, int]:
    """FMAs a pair of the forward and the VJP for hidden widths `hidden`."""
    fh, wm = mlp_products(hidden), hidden[-1] ** 2
    return {"forward": 4 * fh + 2 * wm, "vjp": 12 * fh + 6 * wm}


def cell_work(s: dict, problem: dict) -> Dict[str, dict]:
    hidden = hidden_widths(s)
    nt, n = s["solver.train.n_time_stamps"], s["solver.train.sample_per_time"]
    pairs, w0 = nt * n * n, hidden[0]
    fm = pairwise_fmas(hidden)
    x_bytes = 4 * (3 * nt * n * w0 + n + 2 * nt * n + nt * n * w0)
    flops = 2.0 * pairs * (fm["forward"] + fm["vjp"])
    return {"pairwise": {"flops": flops, "bytes": 2.0 * x_bytes}, "step": {"flops": flops}}
