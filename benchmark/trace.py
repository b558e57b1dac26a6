"""Reading a torch.profiler trace of the traced window: device time by
kernel, the device's busy time (the union of its operations' intervals),
the longest idle gaps named by what the host was running in them, and the
kernels the port's own sources define (so that each is attributed to a
layer)."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.work import least_seconds

UNATTRIBUTED_SHARE = 0.01  # a port kernel above this share of device time needs a layer


def port_kernel_names(csrc: Path) -> List[str]:
    """The __global__ functions that the port's CUDA sources define."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return sorted(names)


def matches(kernel: str, names) -> bool:
    return any(re.search(r"(?<![A-Za-z0-9_])" + re.escape(n) + r"(?![A-Za-z0-9_])", kernel)
               for n in names)


@dataclass
class Summary:
    device_us: Dict[str, float]           # device microseconds by kernel name
    counts: Dict[str, int]                # launches by kernel name
    busy_s: float
    port_kernels: List[str]
    gaps: List[Tuple[str, float]]         # longest idle gaps, named

    @property
    def total_us(self) -> float:
        return sum(self.device_us.values())

    def layer_us(self, names) -> Tuple[float, int]:
        """(device microseconds, launches) of the kernels matching `names`."""
        us = sum(v for k, v in self.device_us.items() if matches(k, names))
        n = sum(v for k, v in self.counts.items() if matches(k, names))
        return us, n

    def breakdown(self) -> dict:
        top = sorted(self.device_us.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v * 1e-6] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def summarize(prof, csrc: Path) -> Summary:
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us, counts = defaultdict(float), defaultdict(int)
    spans = []
    for e in dev:
        start, end = e.time_range.start, e.time_range.end
        device_us[e.name] += end - start
        counts[e.name] += 1
        spans.append((start, end))
    spans.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    named = [(_host_name(host, a, b), (b - a) * 1e-6) for a, b in longest]
    return Summary(dict(device_us), dict(counts), busy * 1e-6, port_kernel_names(csrc), named)


def _host_name(host, a: float, b: float) -> str:
    """The innermost host operation running at the gap's middle, with the
    outermost one around it."""
    mid = 0.5 * (a + b)
    around = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
    if not around:
        return "host idle"
    around.sort(key=lambda e: e.time_range.end - e.time_range.start)
    inner, outer = around[0].name, around[-1].name
    return inner if inner == outer else f"{outer} > {inner}"


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    summary: Summary
    steps: int
    window_s: float       # the traced window's length
    step_s: float         # seconds a step of the same chunk, untraced
    work: Dict[str, dict]
    peak: Optional[dict]

    def per_step_ms(self, names) -> Optional[float]:
        """Device milliseconds a step of the kernels `names`, or None when
        none of them ran."""
        us, n = self.summary.layer_us(names)
        return None if n == 0 else 1e-3 * us / self.steps


def unattributed(summary: Summary, attributed) -> List[str]:
    """Port kernels above UNATTRIBUTED_SHARE of device time that no layer
    names."""
    total = summary.total_us
    return [k for k, us in summary.device_us.items()
            if matches(k, summary.port_kernels) and not matches(k, attributed)
            and us > UNATTRIBUTED_SHARE * total]


def roofline_share(ctx: Context, layer: str, kernels) -> Optional[float]:
    """100 x the least time of `layer`'s work over its kernels' device time,
    or None where the layer did not run or the device has no peaks."""
    ms = ctx.per_step_ms(kernels)
    if ms is None or ctx.peak is None or layer not in ctx.work:
        return None
    return 100.0 * least_seconds(ctx.work[layer], ctx.peak) / (1e-3 * ms)
