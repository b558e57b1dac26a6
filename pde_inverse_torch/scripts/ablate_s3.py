"""Where S3's device time goes: time variants of ``csrc/mma_tf32.cu`` on the
card and print one JSON line.

Each variant is the source with one edit, built with nvcc into
``pde_inverse_torch/_build/ablate_s3/`` and called through its own
``tf32_matmul`` entry at S3's [2048, 120] x [120, 120] (x @ W and x @ W^T,
TF32 and 3xTF32), timed by device time (``torch.profiler``, as
``time_diag.py``), beside ``x @ W`` in TF32:

    full          the source as it is
    no_products   tf32_gemm_kernel without its mma.sync k-steps
    no_staging    without the loads and stores of its operands
    no_rounding   with rna_tf32 returning its input
    launch_only   without the staging and the products (launch, barriers,
                  the C stores)
    cols64, warps16, depth32, rows32, rows64, tile64
                  other tile shapes: 64 columns a block, 16 warps, stages
                  of 32 k, 32 or 64 rows a block, 64 x 64 tiles

A variant without a phase computes wrong products: only its time is read.
The tile-shape variants are also held to the plain version (``ok``).

    python -m pde_inverse_torch.scripts.ablate_s3 [--reps 300]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys

import torch

from pde_inverse_torch.ops.cuda import build

# (old, new) edits of csrc/mma_tf32.cu; each must apply
_PRODUCTS = ("      if (k0 >= kc) break;\n", "      if (k0 >= kc || M > 0) break;\n")
_STAGING = [("  load(0);\n  store(0);\n", ""), ("    if (s + 1 < n_stages) load(s + 1);\n", ""),
            ("      store(s + 1);\n", "")]
_ROUNDING = ("  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);", "  return x;")
EDITS = {
    "full": [],
    "no_products": [_PRODUCTS],
    "no_staging": _STAGING,
    "no_rounding": [_ROUNDING],
    "launch_only": [_PRODUCTS, *_STAGING],
    "cols64": [("constexpr int kGemmCols = 128; ", "constexpr int kGemmCols = 64; ")],
    "warps16": [("constexpr int kGemmWarps = 8;", "constexpr int kGemmWarps = 16;")],
    "depth32": [("constexpr int kGemmDepth = 64; ", "constexpr int kGemmDepth = 32; ")],
    "rows32": [("constexpr int kGemmRows = 16; ", "constexpr int kGemmRows = 32; ")],
    "rows64": [("constexpr int kGemmRows = 16; ", "constexpr int kGemmRows = 64; ")],
    "tile64": [("constexpr int kGemmRows = 16; ", "constexpr int kGemmRows = 64; "),
               ("constexpr int kGemmCols = 128; ", "constexpr int kGemmCols = 64; ")],
}
SHAPES = ("cols64", "warps16", "depth32", "rows32", "rows64", "tile64")  # variants that still compute the product


def variants() -> dict:
    """{name: source text} of every variant; raises if an edit no longer
    applies to csrc/mma_tf32.cu."""
    src = (build.CSRC / "mma_tf32.cu").read_text()
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"ablate_s3: variant {name}: {old.strip()!r} is not in csrc/mma_tf32.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(texts: dict) -> dict:
    """{name: library path}, one nvcc a variant, all started together."""
    out_dir = build.BUILD_DIR / "ablate_s3"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir)
    procs = {}
    for name, text in texts.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
                                        str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablate_s3: nvcc failed on variant {name}:\n{log}")
    return {name: out_dir / f"lib{name}.so" for name in texts}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=300)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_s3: needs a CUDA device")
    from pde_inverse_torch.ops.cuda import mma_tf32
    from pde_inverse_torch.scripts import microtest_blkdiag_dot as s3
    from pde_inverse_torch.scripts.time_diag import times

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, W = (torch.from_numpy(a).to(dev) for a in s3.inputs(2048, 20, 6))
    M, K = x.shape
    N = W.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for name, path in _build(variants()).items():
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tf32_matmul.argtypes = [ci] * 6 + [vp, ci, vp, ci, vp, ci, vp]
        for split, precision in ((0, "tf32"), (1, "3xtf32")):
            for bt in (0, 1):
                out = torch.empty((M, N), device=dev)
                call = lambda: lib.tf32_matmul(dev.index or 0, split, bt, M, N, K, x.data_ptr(), K, W.data_ptr(), N,
                                               out.data_ptr(), N, stream)
                if call() != 0:
                    raise RuntimeError(f"ablate_s3: variant {name} failed to launch")
                row = {"device_us": 1e3 * times(call, args.reps)["device_ms"]}
                if name == "full" or name in SHAPES:
                    want = mma_tf32.tf32_matmul_plain(x, W, precision, bool(bt))
                    scale = x.abs() @ (W.abs().T if bt else W.abs())
                    row["ok"] = float(((out - want).abs() / scale).max()) <= 8 * K * 2.0**-24
                res[f"{name} {precision} {'x @ W^T' if bt else 'x @ W'}"] = row
    torch.backends.cuda.matmul.allow_tf32 = True
    res["library x @ W, TF32 allowed"] = {"device_us": 1e3 * times(lambda: x @ W, args.reps)["device_ms"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0] if smi else None, "reps": args.reps, "shape": "2048x120x120", "times": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
