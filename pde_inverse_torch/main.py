"""CLI entry point of the port.

Usage (the JAX package's overrides and presets, plus ``device=``):

    python -m pde_inverse_torch.main preset=KGMM train.number_of_iterations=20 \
        train.steps_per_chunk=10 logging.writer=none
    python -m pde_inverse_torch.main preset=KGMM device=cpu solver.train.batch_size_0T=64
    python -m pde_inverse_torch.main preset=KMV device=cpu solver.train.sample_per_time=1000

``device`` defaults to CUDA and raises when no CUDA device is present;
``device=cpu`` runs on the CPU.  Flow: 4-way seed split ->
problem -> method -> model -> optimizer -> trainer.fit -> recovered
parameter error, as in ``pde_inverse_tpu/main.py``.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.config import Config
from pde_inverse_torch import rng
from pde_inverse_torch.device import resolve_device, setup_precision
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.registry import check_supported, get_method, get_pde_instance
from pde_inverse_torch.training.metrics import make_writer
from pde_inverse_torch.training.optimizers import get_optimizer
from pde_inverse_torch.training.trainer import Trainer


def parse_args(argv) -> Tuple[Config, Optional[str]]:
    """(cfg, device) from ``preset=``, ``config=``, ``device=`` and dotted
    ``key=value`` overrides."""
    overrides, cfg, preset_name, device = [], None, None, None
    for arg in argv:
        if arg in ("-h", "--help", "help"):
            print(__doc__)
            print("presets:", " ".join(sorted(config_lib.PRESETS)))
            raise SystemExit(0)
        key, _, value = arg.partition("=")
        if key == "config":
            cfg = config_lib.load_yaml(value)
        elif key == "preset":
            preset_name = value
        elif key == "device":
            device = value
        else:
            overrides.append(arg)
    if preset_name is not None:
        return config_lib.preset(preset_name, overrides), device
    return config_lib.apply_overrides(cfg or Config(), overrides), device


@dataclass
class RunResult:
    params: Dict[str, torch.Tensor]
    rel_l2: Optional[float]
    losses: np.ndarray  # every step's loss
    test_metrics: Dict[str, float]  # the final test, with steps_per_sec
    # non-parametric models: the end-of-run test at key 99 ([result] line)
    result_metrics: Dict[str, float]


def run(cfg: Config, device: Optional[str] = None) -> RunResult:
    check_supported(cfg)
    dev = resolve_device(device)
    setup_precision()
    # deterministic 4-way seed split: problem, method, trainer, log-density
    key_problem, key_method, key_trainer, _ = rng.split(cfg.seed, 4)
    if cfg.train.data_seed >= 0:
        # re-key only the training data stream; the ground truth stays
        key_trainer = rng.fold_in(cfg.train.data_seed, 0)

    pde_instance = get_pde_instance(cfg)(cfg, key_problem, dev)
    method = get_method(cfg)(pde_instance, cfg, key_method, dev)
    model, params = method.create_model_fn()

    p = cfg.pde_instance
    run_name = f"{p.domain_dim}D-{p.name}-{p.potential}-{cfg.solver.name}-{p.total_evolving_time}"
    run_dir = f"{cfg.logging.run_dir}/{run_name}-seed{cfg.seed}-torch"
    writer = make_writer(cfg.logging.writer, run_dir)
    if cfg.logging.writer in ("jsonl", "csv"):
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(config_lib.to_dict(cfg), f, indent=1)

    trainer = Trainer(
        cfg=cfg,
        method=method,
        key=key_trainer,
        forward_fn=functional_forward(model),
        params=params,
        optimizer=get_optimizer(cfg.train.optimizer),
        writer=writer,
    )
    try:
        params_trained = trainer.fit()
    finally:
        writer.close()

    rel = pde_instance.recovered_parameter_rel_l2(params_trained)
    result_metrics = {}
    if rel is not None:
        print(f"[result] recovered-parameter rel-L2: {rel:.4e}")
    else:
        # non-parametric model: report the test metrics at a fixed key
        result_metrics = {
            k: float(v)
            for k, v in method.test_fn(functional_forward(model), params_trained, 99).items()
        }
        line = " ".join(f"{k}={v:.4e}" for k, v in result_metrics.items())
        print(f"[result] {line}" if result_metrics else "[result] done")
    return RunResult(params_trained, rel, trainer.losses, trainer.test_metrics, result_metrics)


def main():
    cfg, device = parse_args(sys.argv[1:])
    run(cfg, device)


if __name__ == "__main__":
    main()
