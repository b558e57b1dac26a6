"""S2: how accurate is an axis-0 sum of [R, w] float32 on the card, at three
precisions (counterpart of scripts/microtest_sublane_reduce.py)?

The packed pairwise VJP's bias and u gradients are axis-0 sums of
cotangent arrays.  On cancellation-heavy columns (zero-mean columns plus a
small signal, the shape of a cotangent sum) at (2048, 120), (2048, 20) and
(1024, 120), each mode is held against a float64 sum:

  sum     the port's fixed-order column sum, the row sum that finishes
          K5-K8's bias and u gradients (``ops/cuda/pairwise.py::sum_rows``);
  dot     a ones-row product on the tensor cores in TF32, x^T @ ones with
          the ones a register constant (``mma.sync`` m16n8k8,
          ``ops/cuda/mma_tf32.py::column_sum``): Hopper's counterpart of the
          TPU's default-precision f32 dot;
  dot_hi  the same product in 3xTF32, the counterpart of Precision.HIGHEST.

Each line prints abs (the largest error), rel(leafmax) (over the largest
|sum|) and rel(cancel-scale) (over the largest column sum of |x|, the
scale that rounding errors follow), as the JAX script does.  A mode fails
when rel(cancel-scale) exceeds its rounding bound: (R - 1) 2^-24 for sum,
2^-11 more for dot (each x rounded to TF32), 2^-21 + 3 R 2^-24 for dot_hi.

On cancelling columns those bounds are larger than the sums themselves
(dot's is about 1.0 at [2048, 120], where the largest sum is 0.12), so a
mode that returned zeros would pass them.  Each kernel is therefore also
held against its plain version, on the same input and on one whose column
sums do not cancel (N(1, 1) entries, where the same bounds are under a
thousandth of the sums): sum bit for bit (its plain version adds in the
kernel's order), dot and dot_hi within 8 R 2^-24 of the largest column sum
of |x| (the products by 1.0 are exact; only the order of the float32 adds
inside a tensor-core k-step differs); on the second input each mode is
also held to its float64 bound.

    python -m pde_inverse_torch.scripts.microtest_sublane_reduce [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pde_inverse_torch.device import resolve_device, setup_precision
from pde_inverse_torch.ops.cuda import mma_tf32
from pde_inverse_torch.ops.cuda import pairwise as pw

SHAPES = ((2048, 120), (2048, 20), (1024, 120))
MODES = ("sum", "dot", "dot_hi")
U = 2.0**-24  # float32 unit roundoff


def bound(mode: str, R: int) -> float:
    """Rounding bound of rel(cancel-scale) for `mode` over R rows."""
    return {"sum": (R - 1) * U, "dot": 2.0**-11 + (R - 1) * U, "dot_hi": 2.0**-21 + 3 * R * U}[mode]


def inputs(R: int, w: int) -> np.ndarray:
    """Cancellation-heavy [R, w] float32: zero-mean columns plus 1e-3 noise."""
    y = np.random.default_rng(0).standard_normal((R, w))
    y -= y.mean(axis=0, keepdims=True)
    return (y + 1e-3 * np.random.default_rng(1).standard_normal((R, w))).astype(np.float32)


def sums_input(R: int, w: int) -> np.ndarray:
    """[R, w] float32 whose column sums do not cancel: N(1, 1) entries, so a
    wrong or missing part of a sum shows at its full size."""
    return (1.0 + np.random.default_rng(2).standard_normal((R, w))).astype(np.float32)


def plain_limit(mode: str, R: int, scale: float) -> float:
    """Largest kernel-vs-plain difference allowed over R rows whose largest
    column sum of |x| is `scale`: none for sum, 8 R 2^-24 scale for dot and
    dot_hi."""
    return 0.0 if mode == "sum" else 8 * R * U * scale


def reduce(mode: str, x: torch.Tensor) -> torch.Tensor:
    """Axis-0 sum of x [R, w] by `mode` (the kernels on CUDA tensors)."""
    if mode == "sum":
        return pw.sum_rows(x)
    return mma_tf32.column_sum(x, "tf32" if mode == "dot" else "3xtf32")


def reduce_plain(mode: str, x: torch.Tensor) -> torch.Tensor:
    if mode == "sum":
        return pw.sum_rows_plain(x)
    return mma_tf32.column_sum_plain(x, "tf32" if mode == "dot" else "3xtf32")


def run(device=None) -> dict:
    """{"ok", "rows": [(R, w, mode, abs, rel_leafmax, rel_cancel)] on the
    cancelling input, "max_abs_err": the largest kernel-vs-plain difference
    on either input}."""
    dev = resolve_device(device)
    setup_precision()
    out = {"ok": True, "rows": [], "max_abs_err": 0.0}
    for R, w in SHAPES:
        for cancelling, x in ((True, inputs(R, w)), (False, sums_input(R, w))):
            ref = x.astype(np.float64).sum(axis=0)
            scale = np.abs(x).sum(axis=0).max()
            xt = torch.from_numpy(x).to(dev)
            for mode in MODES:
                got = reduce(mode, xt)
                diff = float((got - reduce_plain(mode, xt)).abs().max())
                out["max_abs_err"] = max(out["max_abs_err"], diff)
                err = float(np.abs(got.double().cpu().numpy() - ref).max())
                rel_leaf, rel_cancel = err / np.abs(ref).max(), err / scale
                good = rel_cancel <= bound(mode, R) and diff <= plain_limit(mode, R, scale)
                out["ok"] &= good
                if cancelling:
                    out["rows"].append((R, w, mode, err, rel_leaf, rel_cancel))
                print(f"[{R}x{w}{'' if cancelling else ' no-cancel'}] {mode:7s} abs={err:.3e} "
                      f"rel(leafmax)={rel_leaf:.3e} rel(cancel-scale)={rel_cancel:.3e} (bound "
                      f"{bound(mode, R):.3e}); vs plain {diff:.3e} (limit {plain_limit(mode, R, scale):.3e})"
                      f"{'' if good else ': EXCEEDED'}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return 0 if run(parser.parse_args(argv).device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
