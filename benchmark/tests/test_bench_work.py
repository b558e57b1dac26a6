"""The benchmark's own counts of the work the step's functions need, held
to hand counts, and the Philox generator the SDE reference draws from, held
to the generator's published known-answer vectors."""

import pytest
import torch

from benchmark import harness, work
from benchmark.tests.held_out import SPEC
from benchmark.work import kfp_pointwise, kmv_pairwise
from benchmark.reference import philox


def test_pairwise_count_is_48000_fmas_a_pair_at_the_kmv_mlp():
    fm = kmv_pairwise.pairwise_fmas([20] * 8)
    assert fm == {"forward": 12_000, "vjp": 36_000}


def test_pointwise_vjp_is_ten_products():
    chain = [64, 64, 256]
    f = work.mlp_products(chain)
    assert f == 64 * 64 + 64 * 256
    assert kfp_pointwise.pointwise_fmas(chain) == {"forward": 4 * f, "vjp": 10 * f}


def test_cell_work_at_the_cells_sizes():
    cell = harness.find_cell("kmv-mlp.pairs28m", spec=SPEC)
    kmv = cell.module("work").cell_work(cell.settings, cell.config["problem"])
    assert kmv["step"]["flops"] == 2.0 * 28_000_000 * 48_000
    cell = harness.find_cell("kgmm-np-online.paths250k", spec=SPEC)
    kg = cell.module("work").cell_work(cell.settings, cell.config["problem"])
    peak = work.peak("NVIDIA H100 80GB HBM3")
    assert kg["pointwise"]["flops"] == 2.0 * 250_000 * 14 * 20_480
    # K3 + K4's least time: 0.611 + 1.528 ms
    assert work.least_seconds(kg["pointwise"], peak) == pytest.approx(2.139e-3, rel=2e-3)
    assert kg["step"]["flops"] > kg["pointwise"]["flops"] + kg["langevin"]["flops"]


def test_peak_table_knows_only_what_it_holds():
    assert work.peak("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12
    assert work.peak("cpu") is None


@pytest.mark.parametrize("counter, key, expected", [
    ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, 0xFFFFFFFFFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), 0xA4093822 | (0x299F31D0 << 32),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    words = philox.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in words) == expected


def test_philox_normals_are_standard():
    z = philox.normals(torch.arange(200_000, dtype=torch.int64), 3, 12345, 4, torch.float64)
    assert abs(float(z.mean())) < 5e-3 and abs(float(z.std()) - 1.0) < 5e-3
