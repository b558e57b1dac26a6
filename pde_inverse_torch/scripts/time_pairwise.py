"""Time the pairwise kernels on the card at the KMV MLP configuration's full
width with CUDA events, and print one JSON line: the collapsed-head K7 and
K8 by default, the square-head K5 and K6 on request, and K5 and K6 at a
chain with hidden width 64 (``K5-wide``, ``K6-wide``: what
``kmv_pallas=auto`` runs for wide nets, through pw_fwd_kernel and through
k6_kernel on eight lanes a pair, as ``choose`` says in the output).

Shape: 7 stamps x 2,000 points x 2,000 refs (28 million pairs), the
PotentialMLP 2 -> 20 x 8 -> 128 with tanh, as the provider calls them
(K7/K8: hidden 20 x 7 layers, M = W_F W_F^T, u = 2 W_F b_F; K5/K6: the
layers with the feature layer last), inputs from a seed.  ``K5-wide`` and
``K6-wide``: the same 28 million pairs through 64 -> 64 -> 128, the deepest
chain of hidden width 64 whose 32-point tile fits pw_bwd_kernel's shared
memory, so that both versions of K6 run it.  Only ``csrc/pairwise.cu`` is
built (about two minutes: 15 instantiations each of K5, K7 and K8, 21 of
K6), not the minutes of the whole build.

    python -m pde_inverse_torch.scripts.time_pairwise [--reps 5] [--kernels K7 K8]

To compare two versions of the kernels on one card, run this file in turns
(A, B, B, A) with PYTHONPATH pointing at each checkout's root, giving the
file's path rather than ``-m``: the package found first on the path is the
one timed, and each checkout builds its own library.  For example, with
the other checkout unpacked at ``.scratch/parent``:

    for c in .scratch/parent . . .scratch/parent; do
      PYTHONPATH=$c python pde_inverse_torch/scripts/time_pairwise.py; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

NT, N, WIDTHS = 7, 2_000, (20,) * 8 + (128,)
WIDE = (64, 64, 128)


def _inputs(dev, seed: int = 10, widths=WIDTHS):
    """(mids, mids_m, M, u, ax, av, ar, mask, cotangents) at the full width."""
    gen = torch.Generator().manual_seed(seed)
    mids = [(torch.randn((a, b), generator=gen) / a**0.5, torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    w0 = widths[0]
    ax, av, ar = (torch.randn((NT, N, w0), generator=gen) * s for s in (1.0, 0.7, 1.0))
    cot = [torch.randn((NT, N), generator=gen), torch.randn((NT, N), generator=gen),
           torch.randn((NT, N, w0), generator=gen)]
    WF, bF = mids[-1]
    to = lambda t: t.to(dev)
    mids = [(to(W), to(b)) for W, b in mids]
    return (mids, mids[:-1], to(WF @ WF.T), to(2.0 * (WF @ bF)),
            to(ax), to(av), to(ar), to(torch.ones(N)), [to(c) for c in cot])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--kernels", nargs="+", default=["K7", "K8"], choices=["K5", "K6", "K7", "K8", "K5-wide", "K6-wide"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pairwise: needs a CUDA device")
    import pde_inverse_torch
    from pde_inverse_torch.ops.cuda import pairwise as pw

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mids, mids_m, M, u, ax, av, ar, mask, cot = _inputs(dev)
    wide, _, _, _, wax, wav, war, wmask, wcot = _inputs(dev, widths=WIDE)
    calls = {"K5": lambda: pw.mlp_pairwise_sums(mids, "tanh", ax, av, ar, mask),
             "K6": lambda: pw.mlp_pairwise_sums_bwd(mids, "tanh", ax, av, ar, mask, *cot),
             "K7": lambda: pw.mlp_pairwise_sums_packed(mids_m, M, u, "tanh", ax, av, ar, mask),
             "K8": lambda: pw.mlp_pairwise_sums_packed_bwd(mids_m, M, u, "tanh", ax, av, ar, mask, *cot),
             "K5-wide": lambda: pw.mlp_pairwise_sums(wide, "tanh", wax, wav, war, wmask),
             "K6-wide": lambda: pw.mlp_pairwise_sums_bwd(wide, "tanh", wax, wav, war, wmask, *wcot)}
    times = {}
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
        times[kid] = start.elapsed_time(end) / args.reps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    ran = None  # a checkout without ``choose`` does not say which kernel ran
    if hasattr(pw, "choose"):
        (k5, k6), (k5_wide, k6_wide) = pw.choose(WIDTHS, "on"), pw.choose(WIDE, "on")
        ran = {"K5": k5, "K6": k6, "K7": "k7", "K8": "k8", "K5-wide": k5_wide, "K6-wide": k6_wide}
        ran = {kid: ran[kid] for kid in args.kernels}
    print(json.dumps({"package": pde_inverse_torch.__file__, "card": smi[0] if smi else None,
                      "shape": f"{NT}x{N}x{N}", "reps": args.reps, "ms": times, "kernels": ran,
                      "launches": {"K5": pw.mlp_pairwise_sums.launches, "K6": pw.mlp_pairwise_sums_bwd.launches}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
