"""The benchmark of the PyTorch and CUDA port (``pde_inverse_torch``) on one
NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted`` (the window's
training steps), ``failed`` (steps whose loss was not finite), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number that decides ``correct`` beside its limit.  The same numbers are the
last lines of its standard error.

The process keeps to two fixed CPUs (``pin_cpus``).  Set-up builds the
cell's problem, method, model and trainer from the seed as the port's CLI
does (the initial weights are drawn by the benchmark), runs the first
training steps through ``Trainer.fit`` (the check's steps; this builds the
CUDA kernels the path loads and warms every shape), then a short
calibration of the rate.  The window is one ``Trainer.fit`` of as many
steps as the rate fills in ``--seconds``; with ``--trace 1`` it is one
chunk run untraced for the time a step, then the same chunk under
``torch.profiler``.  After it, the program's state is freed and the plain
reference follows the check's steps.

Exits with 2 and prints no result without a CUDA device, and with 3 if
JAX or the JAX package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pde_inverse_tpu")
CACHE = ROOT / ".bench_cache"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def pin_cpus(n: int = 2) -> list:
    """Keeps the process, and every thread it starts later, on a fixed set
    of `n` CPUs: the last `n` of those it may use.  The step of a host-paced
    cell is as fast as its host, and a process that wanders over a shared
    machine's cores runs at a speed that varies from run to run."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) > n:
        cpus = cpus[-n:]
        os.sched_setaffinity(0, cpus)
    return cpus


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    cpus = pin_cpus()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process imported {found}", file=sys.stderr)
        return 3
    out.device["power_limit"] = power_limit()
    out.notes.append(f"pinned to CPUs {cpus}")
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": out.metrics, "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["check"] = out.check
    sys.stdout.flush()
    for note in out.notes:
        print(f"benchmark: {note}", file=sys.stderr)
    for name, v in out.check.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
