"""S2 and S3: TF32 and 3xTF32 tensor-core products (``csrc/mma_tf32.cu``)
and their plain PyTorch versions.

``tf32_matmul(a, b, precision, transpose_b)`` is a @ b (or a @ b^T) with
a [M, K], b [K, N] (or [N, K]) float32:

* ``precision="tf32"``: both operands rounded to TF32 (10-bit mantissa,
  round to nearest, ties away from zero), f32 accumulation -- Hopper's
  counterpart of the TPU's default-precision f32 dot;
* ``precision="3xtf32"``: each operand split into TF32 big and small parts,
  big @ small + small @ big + big @ big -- the counterpart of
  ``Precision.HIGHEST``.

S2's ones-row product ``column_sum(x, precision)`` is the column sum of x
[R, w] as x^T @ ones on the tensor cores, in a kernel of its own (the ones
operand a register constant, the rows split into the chunks of
``row_chunks.sum_rows_plan``); its plain-f32 mode is the fixed-order row sum
of K5-K8 (``ops/cuda/pairwise.py::sum_rows``).  For a CUDA tensor a wrapper
launches its kernel on the current stream and raises if the build or the
launch fails; for a CPU tensor it runs its plain version, which rounds the
operands the same way and adds in float32 (the products of TF32 values are
exact in float32; only the order of the sums differs).
``tf32_matmul.launches`` and ``column_sum.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pde_inverse_torch.ops.cuda import build, current_stream, device_index
from pde_inverse_torch.ops.cuda.row_chunks import chunked_sum, sum_rows_plan

PRECISIONS = {"tf32": 0, "3xtf32": 1}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32``: add half a unit of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul_plain(a, b, precision: str = "tf32", transpose_b: bool = False):
    """The plain version: the same rounding and splitting, float32 products."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    b = b.T if transpose_b else b
    a_big, b_big = round_tf32(a), round_tf32(b)
    big = a_big @ b_big
    if precision == "tf32":
        return big
    a_small, b_small = round_tf32(a - a_big), round_tf32(b - b_big)
    return (a_big @ b_small + a_small @ b_big) + big


def _library() -> ctypes.CDLL:
    lib = build.load("mma_tf32")
    if lib.tf32_matmul.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tf32_matmul.argtypes = [ci] * 6 + [vp, ci, vp, ci, vp, ci, vp]
        lib.tf32_column_sum.argtypes = [ci, ci, ci, ci, vp, vp, vp]
        lib.tf32_matmul.restype = lib.tf32_column_sum.restype = ci
    return lib


def tf32_matmul(a, b, precision: str = "tf32", transpose_b: bool = False):
    """a @ b (transpose_b: a @ b^T) on the tensor cores in TF32 or 3xTF32.
    CUDA tensors: the kernel; CPU tensors: ``tf32_matmul_plain``."""
    split = PRECISIONS.get(precision)
    if split is None:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    if a.device.type == "cpu":
        return tf32_matmul_plain(a, b, precision, transpose_b)
    if a.device.type != "cuda":
        raise ValueError(f"tf32_matmul runs on CUDA or CPU tensors, not {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or b.device != a.device:
        raise ValueError("tf32_matmul: a and b must be float32 on one device")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"tf32_matmul: need 2-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not a.is_contiguous():
        a = a.contiguous()
    if not b.is_contiguous():
        b = b.contiguous()
    M, K = a.shape
    N, Kb = b.shape if transpose_b else b.shape[::-1]
    if Kb != K:
        raise ValueError(f"tf32_matmul: shapes {tuple(a.shape)} and {tuple(b.shape)} do not chain")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    dev = device_index(a)
    err = _library().tf32_matmul(dev, split, int(transpose_b), M, N, K, a.data_ptr(), K, b.data_ptr(),
                                 b.shape[1], out.data_ptr(), N, current_stream(dev))
    if err != 0:
        raise RuntimeError(f"tf32_matmul launch failed: CUDA error {err}")
    tf32_matmul.launches += 1
    return out


def column_sum_plain(x, precision: str = "tf32"):
    """The plain version of ``column_sum``: x rounded to TF32 (3xTF32: its
    small part too), each k-step's 8 rows summed, small before big, into
    the chunk sums of ``sum_rows_plan(R, w, 16)``, added in chunk order."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    big = round_tf32(x)
    parts = [big] if precision == "tf32" else [round_tf32(x - big), big]
    return chunked_sum(parts, sum_rows_plan(*x.shape, slab=16).chunk, step=8)


def column_sum(x, precision: str = "tf32"):
    """S2's axis-0 sum of x [R, w] as the ones-row product on the tensor
    cores in TF32 or 3xTF32: [w].  CUDA tensors: the kernel; CPU tensors:
    ``column_sum_plain``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    if x.device.type == "cpu":
        return column_sum_plain(x, precision)
    if x.device.type != "cuda":
        raise ValueError(f"column_sum runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or min(x.shape) < 1:
        raise ValueError(f"column_sum: need x float32 [R, w], got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    dev = device_index(x)
    err = _library().tf32_column_sum(dev, PRECISIONS[precision], x.shape[0], x.shape[1], x.data_ptr(),
                                     out.data_ptr(), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"column_sum launch failed: CUDA error {err}")
    column_sum.launches += 1
    return out


tf32_matmul.launches = 0
column_sum.launches = 0
