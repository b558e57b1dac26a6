"""The numbers that decide ``correct``: how far the program's first training
steps lie from the reference's.

* ``loss_gap``: the largest gap of a step's loss, over the steps the
  reference follows, against the sum of the magnitudes of the loss's terms
  in the reference (the terms cancel: a loss near zero would make a
  relative gap read its rounding many times over);
* ``grad_gap``: the largest gap, over the leaves, between the norms of the
  first gradient as the optimizer received it (before its clipping and
  weight decay, which would hide a gradient scaled wrong), against the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same for the parameters' change after the steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  Adam by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict

from benchmark.reference.common import Readings

MOVING_SHARE = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def gaps(prog: Readings, ref: Readings) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / s for p, r, s in zip(prog.losses, ref.losses, ref.loss_scales))
    leaves = list(ref.grad1)
    med = statistics.median(ref.grad1.values())
    moving = [k for k in leaves if ref.grad1[k] >= MOVING_SHARE * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(prog.grad1, ref.grad1, leaves),
            "change_gap": _worst(prog.change, ref.change, moving)}
