"""K1 and K2: the kinetic Langevin kernel (``csrc/langevin.cu``) and its
plain PyTorch version.

``langevin`` is the counterpart of
``pde_inverse_tpu.ops.pallas.langevin_kernel.langevin_pallas``: ``pack=1``
is K1 (one particle per thread), ``pack`` in {2, 4, 8} is K2 (that many
particles per thread; the TPU kernel's sub-blocks per grid cell).  For a
CUDA tensor it launches the CUDA kernel on the current stream, for a CPU
tensor it runs ``langevin_plain``, which is the plain version of K1 and K2
alike: the law, and with the kernel even the random numbers, do not depend
on ``pack``.  Both take an integer ``seed`` and a
runtime ``noise_scale``: +1, -1 and 0 with one seed draw the same normals,
so the -1 run is the antithetic mirror of the +1 run and 0 is the noiseless
flow.  The kernel's random stream (Philox) differs from the plain version's
(``torch.Generator``); the two agree exactly only without noise and without
random phase, and in law otherwise.

``langevin.launches`` counts kernel launches (CPU calls do not count),
``langevin.launches_by_pack`` the same launches by ``pack``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pde_inverse_torch import rng
from pde_inverse_torch.ops.cuda import build, current_stream, device_index
from pde_inverse_torch.ops.langevin import simulate_kinetic_langevin
from pde_inverse_torch.potentials import GMMPotential, Potential, QuadraticPotential

MAX_DIM = 8
PACKS = (1, 2, 4, 8)  # particles per thread the kernel is compiled for
_MAX_SHARED_BYTES = 48 * 1024
_POTENTIALS = {QuadraticPotential: 0, GMMPotential: 1}
_INTEGRATORS = {"euler": 0, "baoab": 1}

Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def kernel_supported_potential(potential: Potential) -> bool:
    return type(potential) in _POTENTIALS


def _library() -> ctypes.CDLL:
    lib = build.load("langevin")
    fn = lib.langevin_run
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            ci, ci, ci, ci, ci,      # device, d, potential, integrator, pack
            vp, vp, vp, vp, vp,      # z0, final, traj, tau0, pot_params
            ci, ci, cf,              # n_params, k, inv_s2
            ci, ci, cf, cf, cf,      # n, n_steps, dt, gamma, noise_scale
            ctypes.c_ulonglong, ci,  # seed, random_phase
            vp,                      # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def _potential_params(potential: Potential, d: int, device: torch.device):
    """(kind, flat f32 parameter buffer, k, inv_s2) for the kernel."""
    if isinstance(potential, GMMPotential):
        mus = potential.mus
        if mus.ndim != 2 or mus.shape[1] != d:
            raise ValueError(f"GMM means {tuple(mus.shape)} do not match d={d}")
        buf, k, inv_s2 = mus, mus.shape[0], 1.0 / potential.sigma**2
    elif isinstance(potential, QuadraticPotential):
        if tuple(potential.inv_cov.shape) != (d, d) or tuple(potential.mu.shape) != (d,):
            raise ValueError(f"quadratic potential does not match d={d}")
        buf, k, inv_s2 = torch.cat([potential.inv_cov.reshape(-1), potential.mu]), 0, 1.0
    else:
        raise NotImplementedError(
            f"K1 supports Quadratic and GMM potentials, not {type(potential).__name__}"
        )
    if buf.device != device or buf.dtype != torch.float32:
        raise ValueError(
            f"potential parameters must be float32 on {device}, got {buf.dtype} on {buf.device}"
        )
    buf = buf.contiguous()
    if buf.numel() * 4 > _MAX_SHARED_BYTES:
        raise ValueError(
            f"potential has {buf.numel()} parameters; K1 stages at most "
            f"{_MAX_SHARED_BYTES // 4} in shared memory"
        )
    return _POTENTIALS[type(potential)], buf, k, inv_s2


def langevin_plain(
    seed: int,
    z0: torch.Tensor,
    n_steps: int,
    dt: float,
    potential: Potential,
    gamma: float,
    return_trajectory: bool = False,
    random_phase: bool = True,
    noise_scale: float = 1.0,
    integrator: str = "euler",
) -> Outputs:
    """K1's and K2's plain PyTorch version, on z0's device."""
    return simulate_kinetic_langevin(
        rng.generator(seed, z0.device),
        z0,
        n_steps,
        float(dt),
        potential.gradient,
        gamma,
        return_trajectory=return_trajectory,
        random_phase=random_phase,
        integrator=integrator,
        noise_sign=noise_scale,
    )


def langevin(
    seed: int,
    z0: torch.Tensor,
    n_steps: int,
    dt: float,
    potential: Potential,
    gamma: float,
    return_trajectory: bool = False,
    random_phase: bool = True,
    noise_scale: float = 1.0,
    integrator: str = "euler",
    pack: int = 1,
) -> Outputs:
    """(final [n, 2d], trajectory [n, n_steps, 2d] or None, taus [n, n_steps]
    or None).  CUDA tensor: the kernel with `pack` particles per thread (K1
    for 1, K2 otherwise); CPU tensor: ``langevin_plain``."""
    if pack not in PACKS:
        raise ValueError(f"pack={pack}: the Langevin kernel is compiled for pack in {PACKS}")
    if z0.device.type == "cpu":
        return langevin_plain(
            seed, z0, n_steps, dt, potential, gamma, return_trajectory,
            random_phase, noise_scale, integrator,
        )
    if z0.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {z0.device}")
    if z0.dtype != torch.float32 or z0.ndim != 2 or z0.shape[1] % 2:
        raise ValueError(f"z0 must be float32 [n, 2d], got {z0.dtype} {tuple(z0.shape)}")
    if not z0.is_contiguous():
        raise ValueError("z0 must be contiguous")
    n, two_d = z0.shape
    d = two_d // 2
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"K1 is compiled for 1 <= d <= {MAX_DIM}, got d={d}")
    if not 1 <= n < 2**31 or n_steps < 1:
        raise ValueError(f"need 1 <= n < 2^31 and n_steps >= 1, got n={n}, n_steps={n_steps}")
    if integrator not in _INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    kind, params, k, inv_s2 = _potential_params(potential, d, z0.device)

    final = torch.empty((n, two_d), dtype=z0.dtype, device=z0.device)
    traj = (
        torch.empty((n_steps, n, two_d), dtype=z0.dtype, device=z0.device)
        if return_trajectory
        else None
    )
    tau0 = torch.empty((n,), dtype=z0.dtype, device=z0.device)
    err = _library().langevin_run(
        device_index(z0),
        d,
        kind,
        _INTEGRATORS[integrator],
        pack,
        z0.data_ptr(),
        final.data_ptr(),
        traj.data_ptr() if traj is not None else None,
        tau0.data_ptr(),
        params.data_ptr(),
        params.numel(),
        k,
        inv_s2,
        n,
        n_steps,
        float(dt),
        float(gamma),
        float(noise_scale),
        int(seed),
        int(bool(random_phase)),
        current_stream(device_index(z0)),
    )
    if err != 0:
        raise RuntimeError(f"{'K1' if pack == 1 else 'K2'} launch failed: CUDA error {err}")
    langevin.launches += 1
    langevin.launches_by_pack[pack] += 1
    if traj is None:
        return final, None, None
    taus = tau0[:, None] + torch.arange(n_steps, dtype=z0.dtype, device=z0.device) * dt
    return final, traj.permute(1, 0, 2), taus


langevin.launches = 0
langevin.launches_by_pack = dict.fromkeys(PACKS, 0)
