"""String -> class registries and the slice's support check (counterpart of
pde_inverse_tpu/registry.py).

The port runs what it has ported and refuses the rest: every configuration
outside the ported slices (online KGMM and online exact-law KMV, each with
its parametric model or a non-parametric MLP, ResNet or bilinear
hypothesis) raises NotImplementedError naming the ROADMAP item that will
port it.  Nothing is silently ignored.
"""

from __future__ import annotations

from pde_inverse_tpu.config import Config
from pde_inverse_torch.methods import ConsistencyBased
from pde_inverse_torch.problems import KineticFokkerPlanckGMM, KineticMcKeanVlasovQuadratic

PDE_INSTANCES = {
    ("Kinetic-Fokker-Planck", "GMM"): KineticFokkerPlanckGMM,
    ("Kinetic-McKean-Vlasov", "Quadratic"): KineticMcKeanVlasovQuadratic,
}

_NOT_PORTED = {
    ("Fokker-Planck", "Quadratic"): "ROADMAP queue 1, item 22 (overdamped FP)",
    ("Kinetic-Fokker-Planck", "Quadratic"): "ROADMAP queue 1, items 4-5 (KFP-OU, preset KOU)",
}


def _unsupported(cfg: Config):
    """(setting, ROADMAP item) for every setting the ported slices do not run."""
    p, tr, be, net = cfg.pde_instance, cfg.solver.train, cfg.backend, cfg.neural_network
    non_parametric = cfg.estimation_mode == "non-parametric"
    checks = [
        (cfg.solver.name == "PINN", "solver.name=PINN", "queue 1, item 23"),
        (p.sample_mode != "online", f"pde_instance.sample_mode={p.sample_mode}",
         "queue 1, item 17"),
        (non_parametric and net.model == "fourier-kernel",
         "neural_network.model=fourier-kernel", "queue 1, item 20"),
        (non_parametric and net.model != "bilinear-debug" and net.dtype != "float32",
         f"neural_network.dtype={net.dtype}", "queue 1, item 27"),
        (p.init_broaden > 1.0, "pde_instance.init_broaden>1", "queue 1, item 14"),
        (tr.kmv_field_reg > 0.0, "solver.train.kmv_field_reg>0", "queue 1, item 19"),
        ((tr.kmv_pallas_block_i, tr.kmv_pallas_block_j) != (128, 8),
         "solver.train.kmv_pallas_block_i/j (TPU tile shapes)", "'Do not port' list"),
        (p.langevin_pack > 1, "pde_instance.langevin_pack>1", "queue 2, K2"),
        (tr.boundary_reservoir > 0, "solver.train.boundary_reservoir", "queue 1, item 14"),
        (tr.boundary_per_chunk, "solver.train.boundary_per_chunk", "'Do not port' list"),
        (tr.boundary_rotate, "solver.train.boundary_rotate", "'Do not port' list"),
        (cfg.save_and_load.save_model or cfg.save_and_load.load_model,
         "save_and_load.*", "queue 1, item 10"),
        (be.data_axis_size > 1, "backend.data_axis_size>1", "queue 1, item 24"),
        (be.ref_axis_size > 1, "backend.ref_axis_size>1", "queue 1, item 24"),
        (bool(be.profile_dir), "backend.profile_dir", "queue 1, item 26"),
        (cfg.plot.enable, "plot.enable", "queue 1, item 25"),
    ]
    return [(what, item) for bad, what, item in checks if bad]


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError if `cfg` leaves the ported slices."""
    key = (cfg.pde_instance.name, cfg.pde_instance.potential)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"pde_instance name={key[0]!r} potential={key[1]!r} is not ported "
            f"yet: {_NOT_PORTED[key]}"
        )
    bad = _unsupported(cfg)
    if bad:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(f"{what} (ROADMAP {item})" for what, item in bad)
        )


def get_pde_instance(cfg: Config):
    check_supported(cfg)
    key = (cfg.pde_instance.name, cfg.pde_instance.potential)
    if key not in PDE_INSTANCES:
        raise KeyError(
            f"no PDE instance for name={key[0]!r} potential={key[1]!r}; "
            f"available: {sorted(PDE_INSTANCES)}"
        )
    return PDE_INSTANCES[key]


def get_method(cfg: Config):
    check_supported(cfg)
    if cfg.solver.name != "ConsistencyBased":
        raise KeyError(f"unknown solver {cfg.solver.name!r}; available: ['ConsistencyBased']")
    return ConsistencyBased
