"""One run of one cell: set-up, the measured window or the traced one, and
the check of the first training steps against the plain reference.

Everything that belongs to a configuration, a cell or a per-layer metric
is a file found by its name in ``BENCHMARK.json``: ``configs/<config>.json``
(the preset, its overrides, every setting as it is run, the problem's
constants, and the names of its modules: ``inits/<init>.py`` draws the
initial weights, ``work/<work>.py`` counts the step's work,
``reference/<reference>.py`` follows the first steps), ``workloads/<cell>.json``
(the traffic: batch shapes, chunking and test cadence as setting overrides,
and the limits of the check) and ``metrics/<metric>.py`` (a reader).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, trace, work
from benchmark.reference import common as ref_common

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict          # configs/<config>.json
    workload: dict        # workloads/<cell>.json
    spec: dict            # BENCHMARK.json

    @property
    def settings(self) -> dict:
        """Every setting as it is run: the configuration's with the traffic's."""
        return {**self.config["settings"], **self.workload["traffic"]}

    def module(self, kind: str):
        """The configuration's module of `kind` ("inits", "work" or
        "reference"), named in its file."""
        key = {"inits": "init", "work": "work", "reference": "reference"}[kind]
        return importlib.import_module(f"benchmark.{kind}.{self.config[key]}")


def find_cell(name: str, spec: Optional[dict] = None, bench_dir: Path = BENCH) -> Cell:
    spec = spec if spec is not None else load_json(bench_dir.parent / "BENCHMARK.json")
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    conf = [c for c in spec["configs"] if c["name"] == entry["config"]][0]
    return Cell(name, entry, load_json(bench_dir.parent / conf["file"]),
                load_json(bench_dir / "workloads" / f"{name}.json"), spec)


def flat(obj, prefix: str = "") -> dict:
    """A config dataclass as {dotted key: value}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def with_iterations(cfg, n: int):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, number_of_iterations=n))


class Recorder:
    """Wraps the method's step entry and the optimizer's update.  Armed for
    the check, it keeps each step's loss, the parameters each step receives
    and the first gradient as the optimizer's first update receives it
    (before its clipping and weight decay); armed for the window, it records
    a CUDA event on the current stream at each step's start (no
    synchronisation)."""

    def __init__(self, method, optimizer):
        self.capture = False
        self.events: Optional[List[torch.cuda.Event]] = None
        self.calls = 0
        self.losses: List[torch.Tensor] = []
        self.params_in: List[Dict[str, torch.Tensor]] = []
        self.grad1: Optional[Dict[str, torch.Tensor]] = None
        vag, update = method.value_and_grad_fn, optimizer.update

        def value_and_grad_fn(forward_fn, params, key, **kw):
            if self.events is not None:
                self.events[self.calls].record()
            if self.capture:
                self.params_in.append({k: v.detach().clone() for k, v in params.items()})
            out = vag(forward_fn, params, key, **kw)
            if self.capture:
                self.losses.append(out["loss"].detach().clone())
            self.calls += 1
            return out

        def opt_update(grads, state, params):
            if self.capture and state.count == 0:
                self.grad1 = {k: v.detach().clone() for k, v in grads.items()}
            return update(grads, state, params)

        method.value_and_grad_fn = value_and_grad_fn
        optimizer.update = opt_update

    def program_readings(self, params0, n_steps: int) -> ref_common.Readings:
        if len(self.losses) <= n_steps or self.grad1 is None:
            raise RuntimeError("the check steps did not run through the step entry and the optimizer")
        norm = lambda t: float(torch.linalg.vector_norm(t.double()))
        return ref_common.Readings(
            losses=[float(l) for l in self.losses[:n_steps]],
            grad1={k: norm(g) for k, g in self.grad1.items()},
            change={k: norm(self.params_in[n_steps][k] - params0[k]) for k in params0},
        )


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: Dict[str, object]
    check: Dict[str, dict]
    breakdown: Optional[dict] = None
    notes: List[str] = field(default_factory=list)   # phase times, for standard error


def build(cell: Cell, seed: int, device: str, extra_overrides=()):
    """(cfg, trainer, params0, recorder, settings as run) made from the seed
    as the port's CLI makes them, with the initial weights drawn by the
    benchmark; raises where the program's resolved configuration departs
    from the cell's settings."""
    from pde_inverse_torch import config as config_lib, rng
    from pde_inverse_torch.device import resolve_device, setup_precision
    from pde_inverse_torch.methods import functional_forward
    from pde_inverse_torch.registry import check_supported, get_method, get_pde_instance
    from pde_inverse_torch.training.metrics import NullWriter
    from pde_inverse_torch.training.optimizers import get_optimizer
    from pde_inverse_torch.training.trainer import Trainer

    traffic = [f"{k}={v}" for k, v in cell.workload["traffic"].items()]
    overrides = [*cell.config["overrides"], *traffic, f"seed={seed}", *extra_overrides]
    cfg = config_lib.preset(cell.config["preset"], overrides)
    ran = flat(cfg)
    stated = {**cell.settings, "seed": seed}
    if not extra_overrides:
        differ = {k: (v, ran.get(k)) for k, v in stated.items() if ran.get(k) != v}
        if differ:
            raise RuntimeError(f"the program's configuration departs from the cell's: {differ}")
    check_supported(cfg)
    dev = resolve_device(device)
    setup_precision()
    key_problem, key_method, key_trainer, _ = rng.split(cfg.seed, 4)
    inst = get_pde_instance(cfg)(cfg, key_problem, dev)
    method = get_method(cfg)(inst, cfg, key_method, dev)
    model, program_params = method.create_model_fn()
    params0 = cell.module("inits").initial_params(ran, seed, dev)
    shapes = {k: tuple(v.shape) for k, v in program_params.items()}
    if shapes != {k: tuple(v.shape) for k, v in params0.items()}:
        raise RuntimeError(f"the model's leaves {shapes} are not the configuration's")
    optimizer = get_optimizer(cfg.train.optimizer)
    recorder = Recorder(method, optimizer)
    trainer = Trainer(cfg=cfg, method=method, key=key_trainer, forward_fn=functional_forward(model),
                      params={k: v.clone() for k, v in params0.items()}, optimizer=optimizer,
                      writer=NullWriter())
    return cfg, trainer, params0, recorder, ran


def check_steps(cfg, trainer, rec, params0, n_check: int) -> ref_common.Readings:
    """The first n_check + 1 steps through ``Trainer.fit``, recorded."""
    rec.capture = True
    trainer.cfg = with_iterations(cfg, n_check + 1)
    trainer.fit()
    rec.capture = False
    return rec.program_readings(params0, n_check)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", extra_overrides=()) -> Outcome:
    """Set-up, then the window (or, traced, the profiled chunk), then the
    check.  `extra_overrides` and a CPU `device` are for tests at a small
    size."""
    wl = cell.workload
    n_check = wl["check_steps"]
    notes = []
    cfg, trainer, params0, rec, ran = build(cell, seed, device, extra_overrides)
    dev = trainer.method.device
    cuda = dev.type == "cuda"

    # set-up: the check steps (which also build the kernels and warm every
    # shape the window uses, the test's included), then a calibration
    t0 = time.perf_counter()
    program = check_steps(cfg, trainer, rec, params0, n_check)
    notes.append(f"check steps (with any build) {time.perf_counter() - t0:.3f} s")
    calib = wl["calibration_steps"]
    trainer.cfg = with_iterations(cfg, calib)
    _sync(dev)
    t0 = time.perf_counter()
    trainer.fit()
    _sync(dev)
    rate = calib / (time.perf_counter() - t0)
    notes.append(f"calibration {calib} steps at {rate:.4f} steps/s")

    metrics, device_info, breakdown = {}, {}, None
    if traced:
        # the same chunk twice: untraced for the time a step (the profiler
        # slows the host that paces a step), then under the profiler
        n_win = wl["trace_steps"]
        trainer.cfg = with_iterations(cfg, n_win)
        _sync(dev)
        t0 = time.perf_counter()
        trainer.fit()
        _sync(dev)
        step_s = (time.perf_counter() - t0) / n_win
        notes.append(f"untraced {n_win} steps at {step_s * 1e3:.4f} ms a step")
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            trainer.fit()
            _sync(dev)
            window_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        summary = trace.summarize(prof, ROOT / "pde_inverse_torch" / "csrc")
        notes.append(f"traced {n_win} steps in {window_s:.4f} s, read in {time.perf_counter() - t1:.3f} s")
        ctx = trace.Context(summary=summary, steps=n_win, window_s=window_s, step_s=step_s,
                            work=cell.module("work").cell_work(ran, cell.config["problem"]),
                            peak=work.peak(device_kind(dev)))
        attributed = [k for m in cell.spec["per_layer"]
                      for k in getattr(load_metric(m["name"]), "KERNELS", ())]
        stray = trace.unattributed(summary, attributed)
        if stray:
            raise RuntimeError(f"port kernels that no layer names take > 1 % of device time: {stray}")
        metrics = read_layer_metrics(cell, ctx)
        device_info = {"busy_s": summary.busy_s, "window_s": window_s}
        breakdown = summary.breakdown()
    else:
        n_win = max(10, int(round(seconds * rate / 10.0)) * 10)
        trainer.cfg = with_iterations(cfg, n_win)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n_win + 1)] if cuda else None
        rec.calls, rec.events = 0, events
        setup_s = time.perf_counter() - t_start
        _sync(dev)
        host0 = host_readings()
        t0 = time.perf_counter()
        trainer.fit()
        if cuda:
            events[n_win].record()
        _sync(dev)
        window_s = time.perf_counter() - t0
        host1 = host_readings()
        rec.events = None
        notes.append(f"window {n_win} steps in {window_s:.4f} s; host over it: "
                     + ", ".join(f"{k} {host1[k] - host0[k]:.3f}" for k in host0))
        metrics["steps_per_s"] = {"value": n_win / window_s, "unit": "steps/s"}
        if cuda:
            step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_win)]
            metrics["step_ms_p95"] = {"value": float(np.percentile(step_ms, 95)), "unit": "ms"}
            metrics["peak_mem_gib"] = {"value": torch.cuda.max_memory_allocated(dev) / 2**30,
                                       "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    losses = trainer.losses
    failed = int(np.sum(~np.isfinite(losses[-n_win:])))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": device_kind(dev), "count": cell.entry["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0,
                   **device_info}

    # the program's state goes before the reference runs on the same card
    del trainer, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = cell.module("reference")
    changed = {o.partition("=")[0]: ran[o.partition("=")[0]] for o in extra_overrides}
    ref_cfg = {"settings": {**cell.settings, **changed, "seed": seed}, "problem": cell.config["problem"]}
    t0 = time.perf_counter()
    ref = reference.follow_cell(ref_cfg, seed, params0, dev, n_steps=n_check)
    notes.append(f"reference {time.perf_counter() - t0:.3f} s")
    gaps = check.gaps(program, ref)
    limits = wl["limits"]
    compared = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                                  for v in compared.values())
    return Outcome(correct, n_win, failed, metrics, device_info, compared, breakdown, notes)


def host_readings() -> Dict[str, float]:
    """The process's CPU seconds and the machine's stolen seconds (the time a
    hypervisor ran others on this machine's CPUs, from /proc/stat), so that
    a window's notes tell a slow host from a busy one."""
    out = {"cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def device_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def read_layer_metrics(cell: Cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric that lists this cell (or lists none) from its
    reader; a reader that finds nothing returns None and is left out."""
    out = {}
    for m in cell.spec["per_layer"]:
        if "workloads" in m and cell.name not in m["workloads"]:
            continue
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def load_metric(name: str, bench_dir: Path = BENCH):
    """metrics/<name>.py, loaded from its file (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  bench_dir / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
