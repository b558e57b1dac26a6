"""Build a kernel source into a shared library with a plain C interface.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles ``pde_inverse_torch/csrc/<name>.cu`` into
``pde_inverse_torch/_build/lib<name>-<hash>.so`` (the hash covers the source,
the ``csrc/`` headers it includes and the flags), at first use; the library
is loaded with ctypes.  A failed build raises.  ``nvcc`` is taken from
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or from ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built on the machine that has the card"
        )
    return found


def _local_headers(src: Path) -> list:
    """The csrc/ headers that `src` includes by name (``#include "x.cuh"``)."""
    lines = src.read_text().splitlines()
    return sorted(CSRC / ln.split('"')[1] for ln in lines if ln.startswith('#include "'))


def library_path(name: str) -> Path:
    """Where the library for csrc/<name>.cu lands, keyed by source, the
    csrc/ headers it includes and flags."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in _local_headers(src))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> list:
    """Compile csrc/<name>.cu for every name whose library does not exist
    yet, one nvcc process per source, all started together; returns the
    library paths in the order of `names`.

    The compiler's resource report (-Xptxas=-v) is kept beside each library
    as ``.log``.  Any failed build raises."""
    outs = [library_path(name) for name in names]
    running = []
    for name, out in zip(names, outs):
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}.cu:\n{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(
            f"{' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n{log}"
        )
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    return build_all([name])[0]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    return ctypes.CDLL(str(build(name)))
