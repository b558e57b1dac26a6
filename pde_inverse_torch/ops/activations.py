"""Elementwise activations and their hand-written derivative tables
(counterparts of ``pde_inverse_tpu.models.mlp._ACTIVATIONS`` and of the
tables in ``pde_inverse_tpu/ops/pallas/pairwise_kernel.py``).

``ACTIVATIONS`` maps a config name to the activation itself.  ``ACT_D012``
maps tanh, silu and softplus to z -> (act, act', act'') and ``ACT_D0123``
to z -> (act, act', act'', act''').  The fused pointwise kernels (K3/K4,
``csrc/pointwise.cu``) evaluate the same tables; their plain versions use
these.  softplus and sigmoid are the numerically stable forms, as in
``jax.nn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "celu": F.celu,
    "elu": F.elu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}


def _tanh_d012(z):
    a = torch.tanh(z)
    d1 = 1.0 - a * a
    return a, d1, -2.0 * a * d1


def _silu_d012(z):
    s = torch.sigmoid(z)
    ds = s * (1.0 - s)
    return z * s, s + z * ds, 2.0 * ds + z * ds * (1.0 - 2.0 * s)


def _softplus_d012(z):
    s = torch.sigmoid(z)
    return F.softplus(z), s, s * (1.0 - s)


def _tanh_d0123(z):
    a = torch.tanh(z)
    d1 = 1.0 - a * a
    d2 = -2.0 * a * d1
    d3 = d1 * (4.0 * a * a - 2.0 * d1)
    return a, d1, d2, d3


def _silu_d0123(z):
    s = torch.sigmoid(z)
    s1 = s * (1.0 - s)
    s2 = s1 * (1.0 - 2.0 * s)
    s3 = s2 * (1.0 - 2.0 * s) - 2.0 * s1 * s1
    return z * s, s + z * s1, 2.0 * s1 + z * s2, 3.0 * s2 + z * s3


def _softplus_d0123(z):
    s = torch.sigmoid(z)
    s1 = s * (1.0 - s)
    return F.softplus(z), s, s1, s1 * (1.0 - 2.0 * s)


ACT_D012 = {"tanh": _tanh_d012, "silu": _silu_d012, "softplus": _softplus_d012}
ACT_D0123 = {"tanh": _tanh_d0123, "silu": _silu_d0123, "softplus": _softplus_d0123}


def supported_activation(name: str) -> bool:
    """Whether the fused kernels' derivative tables cover `name`."""
    return name in ACT_D012
