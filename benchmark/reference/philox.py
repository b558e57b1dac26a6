"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) and Box-Muller normals, in int64 torch arithmetic on any device.

The kinetic Langevin kernel draws its noise from this generator with the
counter (particle, step, draw, tag) under the key (seed low word, seed high
word); the reference draws the same numbers from the same counters.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, x: torch.Tensor):
    """(high, low) 32-bit words of a * x for x in [0, 2^32), without
    overflowing int64: a is split into 16-bit halves."""
    p0 = x * (a & 0xFFFF)
    p1 = x * (a >> 16)
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _MASK
    hi = ((p0 >> 16) + p1) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, key: int):
    """Four int64 tensors of 32-bit counter words -> four of output words."""
    k0, k1 = key & _MASK, (key >> 32) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def uniform01(bits: torch.Tensor, dtype) -> torch.Tensor:
    """A 32-bit word -> (0, 1]: its top 24 bits plus one, over 2^24."""
    return ((bits >> 8) + 1).to(dtype) / 16777216.0


def normals(particles: torch.Tensor, step: int, key: int, d: int, dtype) -> torch.Tensor:
    """[n, d] standard normals of (particle, step): Box-Muller on each
    counter block (particle, step, j, 0), both branches."""
    out = []
    for j in range(0, d, 4):
        zero = torch.zeros_like(particles)
        b = philox4x32_10(particles, zero + step, zero + j // 4, zero, key)
        r1 = torch.sqrt(-2.0 * torch.log(uniform01(b[0], dtype)))
        r2 = torch.sqrt(-2.0 * torch.log(uniform01(b[2], dtype)))
        a1 = 2.0 * math.pi * uniform01(b[1], dtype)
        a2 = 2.0 * math.pi * uniform01(b[3], dtype)
        out += [r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2), r2 * torch.sin(a2)]
    return torch.stack(out[:d], -1)


def phases(particles: torch.Tensor, key: int, dtype) -> torch.Tensor:
    """[n] uniforms in (0, 1] of the counter (particle, 0, 0, 1)."""
    zero = torch.zeros_like(particles)
    return uniform01(philox4x32_10(particles, zero, zero, zero + 1, key)[0], dtype)
