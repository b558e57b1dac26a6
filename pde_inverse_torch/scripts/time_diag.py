"""Time the diagnostics' kernels S1-S3 and the fixed-order row sum
``sum_rows`` on the card, and print one JSON line.

Each timed function gets three numbers: its device time (``torch.profiler``,
the device time of every kernel it launches over `--reps` back-to-back calls,
with the kernels' names), its call time (CUDA events around the same
back-to-back calls: where it exceeds the device time, the host paces the
calls) and, where one PyTorch call computes the same function, that call's
two times.  What is timed:

    s1        S1's pair rows, 16 points x 48 refs x width 20
              (``pairwise.s1_pair_rows``; ``ax[None] - ar[:, None]``)
    s2        S2's three axis-0 sums of [2048, 120]: sum (``sum_rows``), dot
              and dot_hi (``mma_tf32.column_sum``; ``x.sum(0)``)
    s3        S3's block-diagonal [2048, 120] x [120, 120] products x @ W and
              x @ W^T in TF32 and 3xTF32 (``mma_tf32.tf32_matmul``;
              ``x @ W`` with TF32 allowed and disallowed)
    sum_rows  ``sum_rows`` at the partial rows that K7 and K8 finish at the
              KMV MLP's full width (7 stamps x 2,000 points x 2,000 refs,
              PotentialMLP 2 -> 20 x 8 -> 128): K8's weight gradients, its
              ax/av and ar cotangents, K7's sums, each with its byte bound
    kmv_step  one KMV MLP loss + gradient step with kmv_pallas=auto, median
              of 10 after one warm-up (the step K7 and K8 run in)

Only ``csrc/pairwise.cu`` and ``csrc/mma_tf32.cu`` are built (about a
minute), not the minutes of the whole build.

    python -m pde_inverse_torch.scripts.time_diag [--reps 200] [--what s1 s2 s3 sum_rows kmv_step]

To compare two versions on one card, run this file in turns (A, B, B, A)
with PYTHONPATH pointing at each checkout's root, giving the file's path
rather than ``-m``: the package found first on the path is the one timed,
and each checkout builds its own libraries.  For example, with the other
checkout unpacked at ``.scratch/parent``:

    for c in .scratch/parent . . .scratch/parent; do
      PYTHONPATH=$c python pde_inverse_torch/scripts/time_diag.py; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

WHAT = ("s1", "s2", "s3", "sum_rows", "kmv_step")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
KMV_NT, KMV_N, KMV_W = 7, 2_000, 20  # stamps, points (= refs), hidden width
KMV_LAYERS = 7  # hidden layers before the collapsed head
KMV_MLP = ["preset=KMV-nonparametric-fourier", "neural_network.model=mlp",
           "neural_network.fourier_features=0", "neural_network.fourier_trainable=False",
           "solver.train.kmv_field_reg=0.0", "train.optimizer.weight_decay=1e-1",
           "logging.writer=none", "solver.train.kmv_pallas=auto"]


def _device_us(event) -> float:
    total = getattr(event, "device_time_total", None)
    return float(event.cuda_time_total if total is None else total)


def times(fn, reps: int) -> dict:
    """{"device_ms": device time a call, "call_ms": CUDA-event time a call,
    "kernels": {name: launches a call}} over `reps` back-to-back calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"device_ms": 1e-3 * sum(_device_us(e) for e in kernels) / reps,
            "call_ms": start.elapsed_time(end) / reps,
            "kernels": {e.key[:60]: e.count / reps for e in kernels}}


def kmv_partial_shapes(dev) -> dict:
    """{what: (rows, columns)} of the partial rows that sum_rows finishes in
    K7 and K8 at the KMV MLP's full width, from the wrappers' own plans."""
    from pde_inverse_torch.ops.cuda import pairwise as pw

    widths = [KMV_W] * (KMV_LAYERS + 2)
    dev_index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits = {}
    for kid in ("K7", "K8"):
        plan = pw.plan(kid.lower(), widths)
        splits[kid] = pw.ref_splits(plan, "tanh", widths, KMV_NT, KMV_N, KMV_N, dev_index)
        splits[kid + " points"] = plan.points
    n_blk = -(-KMV_N // splits["K8 points"])
    n_w = KMV_LAYERS * (KMV_W * KMV_W + KMV_W) + KMV_W * KMV_W + KMV_W
    return {"K8 weight gradients": (splits["K8"] * KMV_NT * n_blk, n_w),
            "K8 ax/av cotangents": (splits["K8"], 2 * KMV_NT * KMV_N * KMV_W),
            "K8 ar cotangents": (n_blk, KMV_NT * KMV_N * KMV_W),
            "K7 sums": (splits["K7"], KMV_NT * KMV_N * (2 + KMV_W))}


def kmv_step_ms(steps: int = 10) -> float:
    """Median loss + gradient time of the KMV MLP step (kmv_pallas=auto)."""
    from pde_inverse_torch import rng
    from pde_inverse_torch.main import parse_args
    from pde_inverse_torch.methods import functional_forward
    from pde_inverse_torch.registry import get_method, get_pde_instance

    cfg, _ = parse_args(KMV_MLP)
    key_problem, key_method, key_trainer, _ = rng.split(cfg.seed, 4)
    dev = torch.device("cuda")
    inst = get_pde_instance(cfg)(cfg, key_problem, dev)
    method = get_method(cfg)(inst, cfg, key_method, dev)
    model, params = method.create_model_fn()
    loss_mod, fwd = method._loss_module(), functional_forward(model)
    out = []
    for s in range(steps + 1):
        batch = method.sample_data(rng.fold_in(key_trainer, s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(loss_mod.value_and_grad_fn(fwd, params, batch, inst, **method._kmv_kwargs())["loss"])
        if s:
            out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--what", nargs="+", default=list(WHAT), choices=WHAT)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_diag: needs a CUDA device")
    import pde_inverse_torch
    from pde_inverse_torch.device import setup_precision
    from pde_inverse_torch.ops.cuda import mma_tf32
    from pde_inverse_torch.ops.cuda import pairwise as pw

    dev = torch.device("cuda")
    setup_precision()
    gen = torch.Generator().manual_seed(12)
    out = {}
    if "s1" in args.what:
        ax, av = (torch.randn((16, 20), generator=gen).to(dev) for _ in range(2))
        ar = torch.randn((48, 20), generator=gen).to(dev)
        out["S1 pair rows 16x48x20"] = {"kernel": times(lambda: pw.s1_pair_rows(ax, av, ar), args.reps),
                                        "library": times(lambda: ax[None] - ar[:, None], args.reps)}
    if "s2" in args.what:
        x = torch.randn((2048, 120), generator=gen).to(dev)
        out["S2 [2048,120]"] = {
            "sum": times(lambda: pw.sum_rows(x), args.reps),
            "dot": times(lambda: mma_tf32.column_sum(x, "tf32"), args.reps),
            "dot_hi": times(lambda: mma_tf32.column_sum(x, "3xtf32"), args.reps),
            "library": times(lambda: x.sum(0), args.reps)}
    if "s3" in args.what:
        from pde_inverse_torch.scripts import microtest_blkdiag_dot as s3

        x3, W3 = (torch.from_numpy(a).to(dev) for a in s3.inputs(2048, 20, 6))
        res = {f"{prec} {mode}": times(lambda: mma_tf32.tf32_matmul(x3, W3, prec, mode == "x @ W^T"),
                                       args.reps)
               for prec in ("tf32", "3xtf32") for mode in ("x @ W", "x @ W^T")}
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = allow
            res[f"library x @ W, TF32 {'allowed' if allow else 'disallowed'}"] = times(lambda: x3 @ W3, args.reps)
        torch.backends.cuda.matmul.allow_tf32 = False
        out["S3 [2048,120] x [120,120]"] = res
    if "sum_rows" in args.what:
        for what, (rows, cols) in kmv_partial_shapes(dev).items():
            part = torch.randn((rows, cols), generator=gen).to(dev)
            t = times(lambda: pw.sum_rows(part), max(10, args.reps // 4))
            t.update(rows=rows, columns=cols, bound_ms=1e3 * 4 * (rows + 1) * cols / PEAK_BYTES_PER_S,
                     library=times(lambda: part.sum(0), max(10, args.reps // 4)))
            out[f"sum_rows {what}"] = t
            del part
    if "kmv_step" in args.what:
        out["KMV MLP loss+gradient ms (auto, median of 10)"] = kmv_step_ms()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"package": pde_inverse_torch.__file__, "card": smi[0] if smi else None,
                      "reps": args.reps, "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
