"""Plain PyTorch pieces that both references use: the seed derivation, the
PotentialMLP's jets, the optimizer chain and the first three training steps.

Nothing here imports the program.  The seed derivation is written out from
its definition (a key is folded with data through numpy's SeedSequence and
seeds a ``torch.Generator``), so that the references draw the same random
numbers as the program from the same seed, and compute everything else
themselves.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

_MASK63 = (1 << 63) - 1
Params = Dict[str, torch.Tensor]


def fold_in(key: int, data: int) -> int:
    seq = np.random.SeedSequence([int(key) & _MASK63, int(data) & _MASK63])
    return int(seq.generate_state(1, np.uint64)[0]) & _MASK63


def split(key: int, n: int) -> List[int]:
    return [fold_in(key, i) for i in range(n)]


def generator(key: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(key))


@contextmanager
def matmul_precision(tf32: bool):
    """TF32 products on or off inside the block (the control turns them on)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- the potential network ------------------------------------------------------


@dataclass(frozen=True)
class Net:
    """A PotentialMLP: V(y) = |h(y)|^2 with h = Dense_L o tanh o ... o Dense_0
    applied to y, or to [y, cos(yB), sin(yB)] with a Fourier front end."""

    dim: int
    hidden: tuple
    feature: int
    fourier: int

    @property
    def n_layers(self) -> int:
        return len(self.hidden) + 1

    def shapes(self) -> Dict[str, tuple]:
        """Leaf shapes in the program's parameter order."""
        widths = [self.dim + 2 * self.fourier, *self.hidden, self.feature]
        out = {"fourier_B": (self.dim, self.fourier)} if self.fourier else {}
        for k in range(len(widths) - 1):
            out[f"Dense_{k}.weight"] = (widths[k + 1], widths[k])
            out[f"Dense_{k}.bias"] = (widths[k + 1],)
        return out


def net_from_config(cfg: dict) -> Net:
    s = cfg["settings"]
    if s["neural_network.activation"] != "tanh" or s["neural_network.quadratic_head"]:
        raise NotImplementedError("the reference covers tanh PotentialMLPs without a quadratic head")
    return Net(dim=s["pde_instance.domain_dim"],
               hidden=(s["neural_network.hidden_dim"],) * s["neural_network.layers"],
               feature=s["neural_network.feature_dim"], fourier=s["neural_network.fourier_features"])


def jets(net: Net, params: Params, y: torch.Tensor, U: torch.Tensor, second: bool):
    """(h [P, F], dh [P, m, F], d2h [P, F] or None) of the network's feature
    layer at points y [P, d]: dh along each of the m directions U [P, m, d],
    d2h the second derivative along the last of them."""
    if net.fourier:
        B = params["fourier_B"]
        proj, dproj = y @ B, U @ B  # [P, K], [P, m, K]
        c, s = torch.cos(proj), torch.sin(proj)
        a = torch.cat([y, c, s], -1)
        Ta = torch.cat([U, -s[:, None] * dproj, c[:, None] * dproj], -1)
        dv = dproj[:, -1]
        Sa = torch.cat([torch.zeros_like(y), -c * dv * dv, -s * dv * dv], -1) if second else None
    else:
        a, Ta, Sa = y, U, (torch.zeros_like(y) if second else None)
    for k in range(net.n_layers):
        W, b = params[f"Dense_{k}.weight"], params[f"Dense_{k}.bias"]
        z, Tz = a @ W.T + b, Ta @ W.T
        Sz = Sa @ W.T if second else None
        if k == net.n_layers - 1:
            return z, Tz, Sz
        a = torch.tanh(z)
        d1 = 1.0 - a * a
        if second:
            tv = Tz[:, -1]
            Sa = d1 * Sz - 2.0 * a * d1 * tv * tv
        Ta = d1[:, None] * Tz


def init_params(net: Net, seed_key: int, device, scale_fourier: float) -> Params:
    """The initial weights, from the seed, on the device, in float32: flax's
    he_normal Dense kernels (a normal truncated to two standard deviations,
    scaled to variance 2 / fan-in), zero biases, and N(0, scale^2) Fourier
    frequencies.  Drawn in two calls: one for every kernel, one for B."""
    shapes = net.shapes()
    g = generator(seed_key, device)
    kernels = [k for k in shapes if k.endswith(".weight")]
    total = sum(math.prod(shapes[k]) for k in kernels)
    u = torch.rand((total,), generator=g, device=device, dtype=torch.float64)
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)).clamp_(-2.0, 2.0)
    out, at = {}, 0
    fourier = (torch.randn(shapes["fourier_B"], generator=g, device=device) * scale_fourier
               if net.fourier else None)
    for name, shape in shapes.items():
        if name == "fourier_B":
            out[name] = fourier
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            std = math.sqrt(2.0 / shape[1]) / 0.87962566103423978
            out[name] = (z[at: at + n] * std).reshape(shape).float()
            at += n
    return out


# -- the optimizer chain --------------------------------------------------------


class Chain:
    """[clip_by_global_norm] -> add_decayed_weights -> Adam(0.9, 0.999,
    eps 1e-4) at a cosine-decayed rate, then the EMA of the parameters, as
    the configuration states them."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.count = 0
        self.mu = self.nu = self.ema = None

    def lr(self, count: int) -> float:
        lr = self.opt["learning_rate"]
        if lr["scheduling"] == "None":
            return lr["initial"]
        steps = lr["cosine_decay_steps"]
        cos = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        return lr["initial"] * ((1.0 - lr["cosine_alpha"]) * cos + lr["cosine_alpha"])

    def step(self, params: Params, grads: Params, step: int) -> Params:
        o = self.opt
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.ema = {k: torch.zeros_like(v) for k, v in params.items()}
        g = dict(grads)
        if o["grad_clip_norm"] > 0:
            norm = math.sqrt(sum(float(torch.sum(t * t)) for t in g.values()))
            if norm >= o["grad_clip_norm"]:
                g = {k: t * (o["grad_clip_norm"] / norm) for k, t in g.items()}
        g = {k: t + o["weight_decay"] * params[k] for k, t in g.items()}
        self.mu = {k: 0.1 * g[k] + 0.9 * self.mu[k] for k in g}
        self.nu = {k: 0.001 * g[k] * g[k] + 0.999 * self.nu[k] for k in g}
        self.count += 1
        bc1, bc2 = 1.0 - 0.9 ** self.count, 1.0 - 0.999 ** self.count
        lr = self.lr(self.count - 1)
        new = {k: p - lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-4)
               for k, p in params.items()}
        if o["use_ema"] and step >= o["ema_switch_step"]:
            if step == o["ema_switch_step"]:
                self.ema = dict(new)
            d = o["ema_decay"]
            self.ema = {k: (1.0 - d) * p + d * self.ema[k] for k, p in new.items()}
            if o["ema_mode"] == "switch":
                new = dict(self.ema)
        return new


@dataclass
class Readings:
    """What the first training steps produce: each step's loss, the first
    gradient as the optimizer received it (before its clipping and weight
    decay), and the parameters' change after three updates.
    The reference also gives each step's loss scale: the sum of the
    magnitudes of the loss's terms, which cancel in the loss."""

    losses: List[float]
    grad1: Dict[str, float]      # per-leaf norms
    change: Dict[str, float]     # per-leaf norms
    loss_scales: Optional[List[float]] = None


def optimizer(cfg: dict) -> dict:
    """The optimizer's settings from the configuration's dotted keys."""
    s, pre = cfg["settings"], "train.optimizer."
    out = {k[len(pre):]: v for k, v in s.items() if k.startswith(pre) and "learning_rate" not in k}
    lr = "train.optimizer.learning_rate."
    out["learning_rate"] = {k[len(lr):]: v for k, v in s.items() if k.startswith(lr)}
    return out


def follow(step_fn: Callable, params0: Params, opt: dict, n_steps: int, dtype) -> Readings:
    """Drive `step_fn(params, step) -> (loss, grads, loss scale)` through
    n_steps steps of the optimizer chain from params0, in `dtype`."""
    chain = Chain(opt)
    params = {k: v.detach().to(dtype) for k, v in params0.items()}
    losses, scales, grad1 = [], [], None
    for s in range(n_steps):
        loss, grads, scale = step_fn(params, s)
        losses.append(float(loss))
        scales.append(float(scale))
        if s == 0:
            grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        params = chain.step(params, grads, s)
    change = {k: float(torch.linalg.vector_norm(params[k] - params0[k].to(dtype))) for k in params}
    return Readings(losses, grad1, change, scales)


def blocks(n: int, size: int):
    for start in range(0, n, size):
        yield slice(start, min(n, start + size))
