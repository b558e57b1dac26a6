"""Time the fused pointwise kernels K3 and K4 on the card with CUDA events at
the non-parametric KGMM presets' shapes, and print one JSON line.

Shapes (points a step, layers after the first, tanh), inputs from a seed:

    online   n = 250,000   64 -> 64 -> 256   (KGMM-nonparametric-online)
    xl       n = 655,360   64 -> 64 -> 256   (KGMM-nonparametric-offline-XL)
    offline  n = 320,000   32 -> 32 -> 128   (KGMM-nonparametric)

Only ``csrc/pointwise.cu`` is built (well under a minute), not the minutes
of the whole build.

    python -m pde_inverse_torch.scripts.time_pointwise [--reps 10] [--kernels K3 K4]
        [--shapes online xl offline]

To compare two versions of the kernels on one card, run this file in turns
(A, B, B, A) with PYTHONPATH pointing at each checkout's root, giving the
file's path rather than ``-m``: the package found first on the path is the
one timed, and each checkout builds its own library.  For example, with
the other checkout unpacked at ``.scratch/parent``:

    for c in .scratch/parent . . .scratch/parent; do
      PYTHONPATH=$c python pde_inverse_torch/scripts/time_pointwise.py --kernels K4; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SHAPES = {"online": (250_000, (64, 64, 256)), "xl": (655_360, (64, 64, 256)),
          "offline": (320_000, (32, 32, 128))}


def _inputs(dev, n: int, widths, seed: int = 7):
    """(mids, [z1, dz1, d2z1], [g_quad, g_delta]) on `dev`."""
    gen = torch.Generator().manual_seed(seed)
    mids = [(torch.randn((a, b), generator=gen) / a**0.5, torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    streams = [torch.randn((n, widths[0]), generator=gen) * s for s in (1.0, 0.7, 0.3)]
    cot = [torch.randn(n, generator=gen), torch.randn((n, widths[0]), generator=gen)]
    return ([(W.to(dev), b.to(dev)) for W, b in mids], [t.to(dev) for t in streams],
            [t.to(dev) for t in cot])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--kernels", nargs="+", default=["K3", "K4"], choices=["K3", "K4"])
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pointwise: needs a CUDA device")
    import pde_inverse_torch
    from pde_inverse_torch.ops.cuda import pointwise as pt

    dev = torch.device("cuda")
    times = {}
    for shape in args.shapes:
        n, widths = SHAPES[shape]
        mids, streams, cot = _inputs(dev, n, widths)
        calls = {"K3": lambda: pt.mlp_grad_quad(mids, "tanh", *streams),
                 "K4": lambda: pt.mlp_grad_quad_bwd(mids, "tanh", *streams, *cot)}
        for kid in args.kernels:
            fn = calls[kid]
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[f"{kid} {shape}"] = start.elapsed_time(end) / args.reps
        del mids, streams, cot
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"package": pde_inverse_torch.__file__, "card": smi[0] if smi else None,
                      "shapes": {k: f"n={SHAPES[k][0]} " + "->".join(map(str, SHAPES[k][1]))
                                 for k in args.shapes},
                      "reps": args.reps, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
