"""The control: the reference in the precision below the configuration's
(float32 with TF32 products), put in the program's place, fails the cell's
limits.  On the card only (on the CPU TF32 does not exist); the readings at
the cells' own sizes come from ``benchmark/control.py``."""

import json

import pytest
import torch

from benchmark import check, harness
from benchmark.tests.held_out import SPEC
from benchmark.tests.test_bench_run import CELLS, SMALL


def _value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_tf32_control_is_not_correct(cell_name, cuda_device):
    cell = harness.find_cell(cell_name, spec=SPEC)
    small = {k: _value(v) for k, v in (o.split("=", 1) for o in SMALL[cell_name])}
    seed = 2**31 + 5
    cfg = {"settings": {**cell.settings, **small, "seed": seed}, "problem": cell.config["problem"]}
    params0 = cell.module("inits").initial_params(cfg["settings"], seed, cuda_device)
    reference = cell.module("reference")
    ref = reference.follow_cell(cfg, seed, params0, cuda_device)
    control = reference.follow_cell(cfg, seed, params0, cuda_device, dtype=torch.float32, tf32=True)
    gaps = check.gaps(control, ref)
    limits = cell.workload["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps
