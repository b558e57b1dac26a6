"""Simulator dispatch (counterpart of pde_inverse_tpu/ops/simulate.py).

A Quadratic or GMM potential goes through the K1/K2 wrapper
(``ops/cuda/langevin.py``), which launches the CUDA kernel for a CUDA tensor
(``pack`` particles per thread: K1 for 1, K2 for 2, 4 or 8) and runs the
plain PyTorch simulator for a CPU tensor.  Other potentials run the plain
simulator on any device.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from pde_inverse_torch import rng
from pde_inverse_torch.ops.cuda.langevin import (
    Outputs,
    kernel_supported_potential,
    langevin,
    langevin_plain,
)
from pde_inverse_torch.potentials import Potential
from pde_inverse_torch.tracing import span


def simulate(
    key: int,
    z0: torch.Tensor,
    n_steps: int,
    dt: float,
    potential: Potential,
    gamma: float,
    return_trajectory: bool = True,
    integrator: str = "euler",
    antithetic: bool = False,
    z0_mirror: Optional[torch.Tensor] = None,
    pack: Optional[int] = None,
) -> Outputs:
    """(final [n, 2d], trajectory [n, n_steps, 2d] | None, taus | None).

    antithetic=True simulates every row twice, with the Brownian increments
    and with them negated (same seed, same random phase), and concatenates
    the halves along the particle axis (leading dim 2n).  The +1 half is
    bitwise a plain call with the same key.  z0_mirror gives the initial
    states of the mirrored half (e.g. 2 mean - z0 for a Gaussian law).
    pack: particles per kernel thread; None means 1, as in the JAX package.
    The seed draw and the simulator's calls run in the ``pde.langevin`` span."""
    pack = 1 if pack is None else int(pack)
    if z0_mirror is not None:
        if not antithetic:
            raise ValueError("z0_mirror is only meaningful with antithetic=True")
        if z0_mirror.shape != z0.shape:
            raise ValueError(
                f"z0_mirror shape {tuple(z0_mirror.shape)} != z0 shape {tuple(z0.shape)}"
            )
    if kernel_supported_potential(potential):
        sim = partial(langevin, pack=pack)
    else:
        sim = langevin_plain
    signs = (1.0, -1.0) if antithetic else (1.0,)
    starts = (z0, z0_mirror if z0_mirror is not None else z0)
    with span("langevin"):
        # one integer seed per call, drawn from the key's generator on the
        # host (no device sync); both antithetic halves share it
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=rng.generator(key)))
        outs = [
            sim(seed, start, n_steps, dt, potential, gamma, return_trajectory=return_trajectory,
                integrator=integrator, noise_scale=sign)
            for sign, start in zip(signs, starts)
        ]
    if not antithetic:
        return outs[0]
    return tuple(
        None if a is None else torch.cat([a, b], dim=0) for a, b in zip(*outs)
    )
