"""One-step check of the port's main path.

``entry()`` builds a preset (KGMM by default; any ported preset, e.g.
KGMM-nonparametric-online or KMV) with its problem, method and model, runs one
training step's sampling, loss and gradient on the resolved device (CUDA
unless ``device="cpu"``), and returns its outputs after checking that they
are finite:

    python -c "from pde_inverse_torch.entry import entry; print(entry()['loss'])"
    python -c "from pde_inverse_torch.entry import entry; \
        print(entry(preset='KGMM-nonparametric-online')['loss'])"
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_torch import rng
from pde_inverse_torch.device import resolve_device, setup_precision
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.registry import get_method, get_pde_instance


def entry(
    overrides: Sequence[str] = (), device: Optional[str] = None, preset: str = "KGMM"
) -> Dict[str, object]:
    """One value-and-grad step at the preset's width (plus `overrides`)."""
    cfg = config_lib.preset(preset, list(overrides))
    dev = resolve_device(device)
    setup_precision()
    key_problem, key_method, key_trainer, _ = rng.split(cfg.seed, 4)
    inst = get_pde_instance(cfg)(cfg, key_problem, dev)
    method = get_method(cfg)(inst, cfg, key_method, dev)
    model, params = method.create_model_fn()
    out = method.value_and_grad_fn(functional_forward(model), params, key_trainer, step=0)
    values = [out["loss"], out["grad_norm"], *out["grad"].values()]
    if not all(bool(torch.isfinite(v).all()) for v in values):
        raise FloatingPointError(f"non-finite one-step outputs: {out}")
    return out
