"""S3's plain version (``mma_tf32.tf32_matmul_plain``) against the JAX
package's S3 kernel body, ``scripts/microtest_blkdiag_dot.py::make_kernel``,
run through an interpret-mode ``pallas_call`` on the CPU, for x @ W and
x @ W^T at the script's block-diagonal shapes.

On the CPU JAX's f32 dot is full f32 at both of the script's precisions
(default and HIGHEST), so each comparison holds the port's rounded product
within its own rounding bound over sum_k |x_ik| |W_kj| (the bound of
``pde_inverse_torch/scripts/microtest_blkdiag_dot.py``: 2^-10 + 2^-20 +
K 2^-24 for TF32, 2^-20 + 3 K 2^-24 for 3xTF32) plus K 2^-24 for the JAX
side's own f32 sums.  The kernel itself runs on the card
(tests/test_torch_diag_cuda.py)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pde_inverse_torch.ops.cuda import mma_tf32
from pde_inverse_torch.scripts import microtest_blkdiag_dot as s3

torch.set_num_threads(1)

U = 2.0**-24


def _jax_s3_script():
    """scripts/microtest_blkdiag_dot.py of the JAX package, loaded by path
    (``scripts/`` is no package)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "microtest_blkdiag_dot.py"
    spec = importlib.util.spec_from_file_location("jax_microtest_blkdiag_dot", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_S3 = _jax_s3_script()
# the JAX script's precisions and the port's counterparts
PRECISIONS = [(None, "tf32", "def"), (jax.lax.Precision.HIGHEST, "3xtf32", "hi ")]


def _jax_run(mode, prec, x, W):
    """The JAX script's kernel body in an interpret-mode pallas_call."""
    call = pl.pallas_call(JAX_S3.make_kernel(mode, prec),
                          out_shape=jax.ShapeDtypeStruct((x.shape[0], W.shape[0]), jnp.float32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(x), jnp.asarray(W)), np.float64)


@pytest.mark.parametrize("R,w,p", [(16, 8, 1), (64, 20, 6), (2048, 20, 1)])
@pytest.mark.parametrize("mode", ["fwd", "bwd"])
@pytest.mark.parametrize("prec,precision,tag", PRECISIONS)
def test_plain_s3_matches_the_jax_kernel_body_in_interpret_mode(R, w, p, mode, prec, precision, tag):
    x, W = s3.inputs(R, w, p)
    want = _jax_run(mode, prec, x, W)
    got = mma_tf32.tf32_matmul_plain(torch.from_numpy(x), torch.from_numpy(W), precision,
                                     transpose_b=mode == "bwd").double().numpy()
    K = p * w
    Wd = W.astype(np.float64) if mode == "fwd" else W.astype(np.float64).T
    scale = np.abs(x).astype(np.float64) @ np.abs(Wd)
    assert got.shape == want.shape == (R, K)
    assert (np.abs(got - want) <= (s3.bound(tag, K) + K * U) * scale).all()


def test_jax_body_is_f32_and_tf32_is_visibly_coarser():
    """The comparison above is not vacuous: on the CPU JAX's default dot is
    f32-accurate while the port's TF32 product departs from it by far more
    than the 3xTF32 bound."""
    x, W = s3.inputs(2048, 20, 6)
    want = _jax_run("fwd", None, x, W)
    ref = x.astype(np.float64) @ W.astype(np.float64)
    scale = np.abs(x).astype(np.float64) @ np.abs(W.astype(np.float64))
    K = 120
    assert (np.abs(want - ref) <= K * U * scale).all()
    tf32 = mma_tf32.tf32_matmul_plain(torch.from_numpy(x), torch.from_numpy(W), "tf32").double().numpy()
    assert (np.abs(tf32 - want) / scale).max() > s3.bound("hi ", K)
