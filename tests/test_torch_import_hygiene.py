"""Importing the port initialises neither JAX nor CUDA, and its sources
import nothing of JAX (counterpart of tests/test_import_hygiene.py)."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "pde_inverse_torch"

_PROBE = """
import importlib, pkgutil, sys
import torch
import pde_inverse_torch
names = [m.name for m in pkgutil.walk_packages(pde_inverse_torch.__path__, "pde_inverse_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
assert not bad, bad
assert not torch.cuda.is_initialized()
print(len(names))
"""


def test_importing_every_module_loads_no_jax_and_no_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 36  # every module of the ported slices was imported


def test_slice_three_modules_are_importable_without_jax_or_cuda():
    """The KMV slice's modules are among those the probe imports."""
    names = {p.relative_to(PKG).with_suffix("").as_posix() for p in PKG.rglob("*.py")}
    assert {"ops/ou", "ops/cuda/pairwise", "problems/kfp_ou", "problems/kmv_quadratic",
            "losses/kinetic_mckean_vlasov", "losses/pairwise_blockwise"} <= names


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_sources_import_nothing_of_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b", re.M)
    for path in _sources():
        assert not banned.search(path.read_text()), path


def test_only_the_shared_config_is_taken_from_the_jax_package():
    uses = re.compile(r"^\s*(?:from|import)\s+(pde_inverse_tpu[\w.]*)", re.M)
    for path in _sources():
        for module in uses.findall(path.read_text()):
            assert module == "pde_inverse_tpu.config" or (
                module == "pde_inverse_tpu" and "import config" in path.read_text()
            ), (path, module)
    assert not uses.search((REPO / "chip_smoke.py").read_text())


def test_kernel_wrapper_has_no_fallback():
    """The K1, K3-K8 wrappers, their build and the fused and blockwise
    providers raise on failure; no try/except falls back to a plain version."""
    for name in ("ops/cuda/langevin.py", "ops/cuda/build.py", "ops/simulate.py",
                 "ops/cuda/pointwise.py", "losses/fused_pointwise.py", "device.py",
                 "ops/cuda/pairwise.py", "losses/pairwise_blockwise.py",
                 "losses/kinetic_mckean_vlasov.py", "methods.py"):
        assert not re.search(r"^\s*(try|except)\b", (PKG / name).read_text(), re.M), name
