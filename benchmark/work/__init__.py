"""The work a training step's functions need, counted from the cell's
settings, and the table of peaks it is held against.

Each configuration names its counter (``"work"`` in its file): a module
``work/<name>.py`` whose ``cell_work(settings, problem)`` gives
``{"<layer>": {"flops", "bytes"}, ..., "step": {"flops"}}`` of one training
step under the settings (dotted keys) and the problem's constants.

The counts are of what each function needs, whatever route computes it,
so that no change to a kernel changes them: an FMA is 2 FP32 operations, a
transcendental 1, integer work none; each input byte is read once and each
output byte written once.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def counter(name: str):
    """The counter module ``work/<name>.py``."""
    return importlib.import_module(f"benchmark.work.{name}")


def mlp_products(widths) -> int:
    return sum(a * b for a, b in zip(widths, widths[1:]))


def hidden_widths(s: dict) -> list:
    return [s["neural_network.hidden_dim"]] * s["neural_network.layers"]


def peak(kind: str) -> Optional[dict]:
    """The peaks of the device named `kind`, or None for a device the table
    does not hold."""
    with open(PEAKS) as f:
        devices = json.load(f)["devices"]
    for name, p in devices.items():
        if name in kind:
            return p
    return None


def least_seconds(w: dict, p: dict) -> float:
    """The least time of work `w` at FP32 peaks `p`: the larger of its
    operations over the peak rate and its bytes over the memory rate."""
    return max(w["flops"] / p["fp32_flops"], w["bytes"] / p["bytes_per_s"])
