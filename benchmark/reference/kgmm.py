"""Plain reference of the online non-parametric KGMM training step: the
kinetic Langevin sampler, the kinetic Fokker-Planck consistency loss of a
Fourier PotentialMLP, its parameter gradient, and the optimizer with its EMA.

Problem (the configuration's ``problem`` block): dq = p dt, dp = -(grad U(q)
+ gamma p) dt + sqrt(2) dW with U(q) = -log sum_k exp(-|q - mu_k|^2 / 2),
the means mu_k ~ U[-4, 4]^d drawn from the seed, and z0 ~ N(0, diag(4 I,
0.1 I)).  A step draws `batch` trajectories of `n_steps` BAOAB steps of
dt = T / n_steps, each with a random phase tau0 in (0, dt] (a first step of
tau0, n_steps - 1 of dt, a closing one of dt - tau0), keeps every
`path_stride`-th state, simulates `multiple` x batch more particles to T and
draws as many initial points, and evaluates

    loss = E_path |grad V|^2 - 2 E_path v^T Hess V v + 2 gamma E_path grad V.v
         + E_path |grad U|^2 + (2 / T) (E_term grad V.v - E_init grad V.v).

The noise: on the card the simulator's counter-based Philox stream
(``philox.py``); on the CPU the plain simulator's ``torch.Generator``
stream (a phase draw, then one [n, d] normal draw per step).
"""

from __future__ import annotations

import torch

from benchmark.reference import common as c
from benchmark.reference import philox

POINTS_PER_BLOCK = 1 << 15


class Problem:
    def __init__(self, cfg: dict, device, dtype):
        s, pb = cfg["settings"], cfg["problem"]
        self.device, self.dtype = torch.device(device), dtype
        self.d = d = s["pde_instance.domain_dim"]
        self.T = s["pde_instance.total_evolving_time"]
        self.n_steps = s["pde_instance.n_steps"]
        self.gamma = pb["gamma_friction"]
        self.batch = s["solver.train.batch_size_0T"]
        self.stride = s["solver.train.path_stride"]
        self.multiple = pb["boundary_multiple"]
        key_problem = c.split(s["seed"], 4)[0]
        key_config = c.split(key_problem, 2)[0]
        lo, hi = pb["means_range"]
        mus = torch.rand((pb["n_components"], d), generator=c.generator(key_config)) * (hi - lo) + lo
        self.mus = mus.to(device, torch.float64)
        self.scale0 = torch.tensor([pb["initial_q_var"] ** 0.5] * d + [pb["initial_p_var"] ** 0.5] * d,
                                   dtype=torch.float64, device=device)

    def force(self, q):
        diff = q[:, None, :] - self.mus
        w = torch.softmax(-0.5 * torch.sum(diff * diff, -1), -1)
        return torch.einsum("nk,nkd->nd", w, diff)

    def initial(self, key: int, n: int):
        eps = torch.randn((n, 2 * self.d), generator=c.generator(key, self.device), device=self.device)
        return eps.double() * self.scale0

    def simulate(self, key: int, z0, trajectory: bool):
        """BAOAB in float64: (final [n, 2d], states after steps 0..n_steps-1
        [n, n_steps, 2d] or None)."""
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=c.generator(key)))
        n, d, dt, gamma = z0.shape[0], self.d, self.T / self.n_steps, self.gamma
        ids = torch.arange(n, device=self.device, dtype=torch.int64)
        if self.device.type == "cuda":
            tau0 = (philox.phases(ids, seed, torch.float32) * dt).double()
            noise = lambda s: philox.normals(ids, s, seed, d, torch.float64)
        else:
            g = c.generator(seed, self.device)
            tau0 = (torch.rand((n,), generator=g, device=self.device) * dt).double()
            noise = lambda s: torch.randn((n, d), generator=g, device=self.device).double()
        q, p = z0[:, :d].clone(), z0[:, d:].clone()
        f = self.force(q)
        states = []
        for s in range(self.n_steps + 1):
            h = tau0[:, None] if s == 0 else (dt - tau0[:, None] if s == self.n_steps else dt)
            c1 = torch.exp(-gamma * torch.as_tensor(h, dtype=torch.float64, device=self.device))
            c2 = torch.sqrt((1.0 - c1 * c1) / gamma)
            xi = noise(s)
            p = p - 0.5 * h * f
            q = q + 0.5 * h * p
            p = c1 * p + c2 * xi
            q = q + 0.5 * h * p
            f = self.force(q)
            p = p - 0.5 * h * f
            if trajectory and s < self.n_steps:
                states.append(torch.cat([q, p], -1))
        final = torch.cat([q, p], -1)
        return final, (torch.stack(states, 1) if trajectory else None)

    def sample(self, key_sample: int):
        """{initial, terminal, 0T} of one step (float64)."""
        _, _, key_0T = c.split(key_sample, 3)
        k_traj, k_term, k_i0, k_i1, k_i2 = c.split(key_0T, 5)
        _, traj = self.simulate(k_traj, self.initial(k_i0, self.batch), True)
        path = traj[:, :: self.stride].reshape(-1, 2 * self.d)
        initial = self.initial(k_i1, self.batch * self.multiple)
        terminal, _ = self.simulate(k_term, self.initial(k_i2, self.batch * self.multiple), False)
        return {"initial": initial, "terminal": terminal, "0T": path}


def loss_and_grad(net, params, data, prob: Problem):
    """(loss, grads, scale), the loss's per-point means accumulated over
    blocks; scale is the sum of its terms' magnitudes."""
    d, dtype = prob.d, next(iter(params.values())).dtype
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    path = data["0T"]
    U_true = prob.force(path[:, :d])
    true_term = float(torch.mean(torch.sum(U_true * U_true, -1)))
    terms = torch.zeros(5, dtype=torch.float64)
    eye = torch.eye(d, dtype=dtype, device=path.device)

    def accumulate(part, at):
        gs = torch.autograd.grad(part.sum(), list(leaves.values()))
        terms[at: at + part.numel()] += part.detach().double().cpu()
        for k, g in zip(leaves, gs):
            grads[k] += g

    n = path.shape[0]
    for sl in c.blocks(n, POINTS_PER_BLOCK):
        x, v = path[sl, :d].to(dtype), path[sl, d:].to(dtype)
        U = torch.cat([eye.expand(x.shape[0], d, d), v[:, None]], 1)
        with torch.enable_grad():
            h, dh, d2h = c.jets(net, leaves, x, U, second=True)
            grad = 2.0 * torch.einsum("pf,pkf->pk", h, dh[:, :d])
            quad = 2.0 * (torch.sum(dh[:, d] ** 2, -1) + torch.sum(h * d2h, -1))
            part = torch.stack([torch.sum(grad * grad), -2.0 * torch.sum(quad),
                                2.0 * prob.gamma * torch.sum(grad * v)]) / n
            accumulate(part, 0)
    for at, (name, sign) in enumerate((("terminal", 1.0), ("initial", -1.0)), 3):
        z = data[name]
        m = z.shape[0]
        for sl in c.blocks(m, POINTS_PER_BLOCK):
            x, v = z[sl, :d].to(dtype), z[sl, d:].to(dtype)
            with torch.enable_grad():
                h, dh, _ = c.jets(net, leaves, x, v[:, None], second=False)
                part = sign * (2.0 / prob.T) * torch.sum(2.0 * torch.sum(h * dh[:, 0], -1)) / m
                accumulate(part[None], at)
    return float(terms.sum()) + true_term, grads, float(terms.abs().sum()) + abs(true_term)


def follow_cell(cfg: dict, seed: int, params0, device, dtype=torch.float64, tf32=False,
                fault=None, n_steps=3) -> c.Readings:
    """The first `n_steps` training steps from params0 with the data the
    program's seed derivation gives each step.  `fault`: "half_batch" (half
    the trajectories and boundary points, the mean over the rest) or
    "altered" (the first leaf's gradient 10 % off)."""
    net = c.net_from_config(cfg)
    prob = Problem(cfg, device, dtype)
    s = cfg["settings"]
    key_trainer = c.split(s["seed"], 4)[2]
    train_key = c.split(key_trainer, 2)[0]

    def step(params, k):
        key_sample = c.split(c.fold_in(train_key, k), 2)[0]
        data = prob.sample(key_sample)
        if fault == "half_batch":
            data = {name: z[: z.shape[0] // 2] for name, z in data.items()}
        loss, grads, scale = loss_and_grad(net, params, data, prob)
        if fault == "altered":
            first = next(iter(grads))
            grads[first] = grads[first] * 1.1
        return loss, grads, scale

    with c.matmul_precision(tf32):
        return c.follow(step, {k: p.to(device) for k, p in params0.items()}, c.optimizer(cfg),
                        n_steps, dtype)
