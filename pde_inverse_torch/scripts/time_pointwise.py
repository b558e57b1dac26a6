"""Time the fused pointwise kernels K3 and K4, and the Fourier front end's K9
and K10, on the card with CUDA events at the non-parametric KGMM presets'
shapes, and print one JSON line.

Shapes (points a step, layers after the first, tanh), inputs from a seed:

    online   n = 250,000     64 -> 64 -> 256   (KGMM-nonparametric-online)
    xl       n = 655,360     64 -> 64 -> 256   (KGMM-nonparametric-offline-XL)
    offline  n = 320,000     32 -> 32 -> 128   (KGMM-nonparametric)
    paths1m  n = 1,000,000   64 -> 64 -> 256   (the online preset at 10,000 trajectories)

K9 and K10 run at d = 4, F = 64, w0 = 64 (the online and XL presets' front
end); ``front-torch`` is the same front end as PyTorch operations, forward
and backward (``front_streams_plain`` and autograd through it, for the
cotangents of its five outputs), which is what the provider ran before K9
and K10.  ``--rounds`` repeats every timing that many times, in turns.
Only ``csrc/pointwise.cu`` is built (well under a minute), not the minutes
of the whole build.

    python -m pde_inverse_torch.scripts.time_pointwise [--reps 10] [--rounds 1]
        [--kernels K3 K4 K9 K10 front-torch] [--shapes online xl offline paths1m]

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
          "offline": (320_000, (32, 32, 128)), "paths1m": (1_000_000, (64, 64, 256))}
FRONT = (4, 64, 64)  # d, F, w0 of K9 and K10
KERNELS = ("K3", "K4", "K9", "K10", "front-torch")


def _inputs(dev, n: int, widths, seed: int = 7):
    """(mids, [z1, dz1, d2z1], [g_quad, g_delta]) on `dev`."""
    gen = torch.Generator().manual_seed(seed)
    mids = [(torch.randn((a, b), generator=gen) / a**0.5, torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    streams = [torch.randn((n, widths[0]), generator=gen) * s for s in (1.0, 0.7, 0.3)]
    cot = [torch.randn(n, generator=gen), torch.randn((n, widths[0]), generator=gen)]
    return ([(W.to(dev), b.to(dev)) for W, b in mids], [t.to(dev) for t in streams],
            [t.to(dev) for t in cot])


def _front_inputs(dev, n: int, seed: int = 7):
    """((x, v, B, W0, b0), the cotangents of K9's five outputs) on `dev`: x
    and v the halves of one [n, 2d] batch, as the loss passes them."""
    d, nf, w0 = FRONT
    gen = torch.Generator().manual_seed(seed)
    xv = torch.randn((n, 2 * d), generator=gen) * torch.tensor([2.0] * d + [0.32] * d)
    B = torch.randn((d, nf), generator=gen)
    W0 = torch.randn((d + 2 * nf, w0), generator=gen) / (d + 2 * nf) ** 0.5
    b0 = torch.randn(w0, generator=gen) * 0.1
    bars = [torch.randn((n, w), generator=gen).to(dev) for w in (w0, w0, w0, nf, nf)]
    xv = xv.to(dev)
    return (xv[:, :d], xv[:, d:], B.to(dev), W0.to(dev), b0.to(dev)), bars


def _front_torch(args, bars):
    """The front end as PyTorch operations, forward and backward."""
    x, v, *leaves = args
    leaves = [t.detach().requires_grad_() for t in leaves]
    from pde_inverse_torch.ops.cuda import pointwise as pt

    torch.autograd.backward(pt.front_streams_plain(x, v, *leaves), bars)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--kernels", nargs="+", default=["K3", "K4"], choices=KERNELS)
    parser.add_argument("--shapes", nargs="+", default=["online", "xl", "offline"], choices=list(SHAPES))
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
        front, bars = _front_inputs(dev, n)
        calls = {"K3": lambda: pt.mlp_grad_quad(mids, "tanh", *streams),
                 "K4": lambda: pt.mlp_grad_quad_bwd(mids, "tanh", *streams, *cot),
                 "K9": lambda: pt.front_streams(*front),
                 "K10": lambda: pt.front_streams_bwd(*front[:4], *bars),
                 "front-torch": lambda: _front_torch(front, bars)}
        for kid in args.kernels:
            calls[kid]()
        for _ in range(args.rounds):
            for kid in args.kernels:
                fn = calls[kid]
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times.setdefault(f"{kid} {shape}", []).append(start.elapsed_time(end) / args.reps)
        del mids, streams, cot, front, bars
    if args.rounds == 1:
        times = {k: v[0] for k, v in times.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"package": pde_inverse_torch.__file__, "card": smi[0] if smi else None,
                      "shapes": {k: f"n={SHAPES[k][0]} " + "->".join(map(str, SHAPES[k][1]))
                                 for k in args.shapes},
                      "front": "d, F, w0 = " + ", ".join(map(str, FRONT)),
                      "reps": args.reps, "rounds": args.rounds, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
