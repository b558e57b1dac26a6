"""Plain reference of the streamed offline non-parametric KGMM training step:
the offline store's trajectories, initial and terminal sets as the store's
generation specifies them, the streaming loader's draw, the kinetic
Fokker-Planck consistency loss of a Fourier PotentialMLP with the PSD
quadratic skip head, its parameter gradient, and the optimizer with its
tracked EMA.

Problem (the configuration's ``problem`` block): the GMM potential and the
initial law of ``kgmm.py``, the means drawn from the seed as there.  The
store holds ``sample_initial_size`` exact initial draws,
``sample_terminal_size`` particles simulated ``n_steps_terminal`` BAOAB
steps to T, and ``sample_0T_size`` trajectories of ``n_steps_0T`` steps of
dt = T / n_steps_0T, each with its random phase.  It is generated in
shards of at most STORE_SHARD_ELEMENTS floats, a shard keyed by
``fold_in(part key, first row)``: the initial set by its own key, a
terminal or trajectory shard by the two halves of its key (initial draw,
simulation).  A step draws, from numpy's Philox generator keyed by the
step's key, a time shift in [0, 5) and ``offline_traj_batch`` trajectories
(sorted), and takes every fifth state from the shift; with the full
initial and terminal sets it evaluates

    loss = E_path |grad V|^2 - 2 E_path v^T Hess V v + 2 gamma E_path grad V.v
         + E_path |grad U|^2 + (2 / T) (E_term grad V.v - E_init grad V.v)

with V(x) = |h(x)|^2 + |A x|^2 / 2 + b.x.  Only the trajectories the
followed steps gather are simulated again, in float64: on the card from
the simulator's Philox counters of their rows in the shard; on the CPU,
where the plain simulator's ``torch.Generator`` stream runs over the whole
shard, the whole shard.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import common as c
from benchmark.reference import kgmm, philox

STORE_SHARD_ELEMENTS = 64_000_000  # the store's largest shard, in floats
STRIDE = 5  # the offline subsample's time stride


def net_from_config(cfg: dict) -> c.Net:
    """The network under the quadratic head (which ``loss_and_grad`` adds in
    closed form)."""
    s = cfg["settings"]
    if s["neural_network.activation"] != "tanh" or not s["neural_network.quadratic_head"]:
        raise NotImplementedError("this reference covers tanh PotentialMLPs with a quadratic head")
    return c.Net(dim=s["pde_instance.domain_dim"],
                 hidden=(s["neural_network.hidden_dim"],) * s["neural_network.layers"],
                 feature=s["neural_network.feature_dim"], fourier=s["neural_network.fourier_features"])


def shards(total: int, per_item: int):
    """(first row, rows) of each shard of a part of `total` items of
    `per_item` floats."""
    size = max(1, min(total, STORE_SHARD_ELEMENTS // per_item))
    return [(start, min(size, total - start)) for start in range(0, total, size)]


def draws(key: int, n_traj: int, n_time: int, batch: int):
    """(shift, sorted trajectory rows) of one step's gather."""
    t_len = max(1, n_time // STRIDE)
    gen = np.random.Generator(np.random.Philox(key=int(key)))
    shift = int(gen.integers(n_time - (t_len - 1) * STRIDE))
    return shift, np.sort(gen.permutation(n_traj)[:min(batch, n_traj)])


class Problem:
    force = kgmm.Problem.force
    initial = kgmm.Problem.initial

    def __init__(self, cfg: dict, device):
        s, pb = cfg["settings"], cfg["problem"]
        self.device = torch.device(device)
        self.d = d = s["pde_instance.domain_dim"]
        self.T = s["pde_instance.total_evolving_time"]
        self.gamma = pb["gamma_friction"]
        self.n_init, self.n_term = s["pde_instance.sample_initial_size"], s["pde_instance.sample_terminal_size"]
        self.n_traj, self.n_time = s["pde_instance.sample_0T_size"], s["pde_instance.n_steps_0T"]
        self.n_steps_term = s["pde_instance.n_steps_terminal"]
        self.batch = s["solver.train.offline_traj_batch"]
        key_problem = c.split(s["seed"], 4)[0]
        key_config, key_dataset = c.split(key_problem, 2)
        lo, hi = pb["means_range"]
        mus = torch.rand((pb["n_components"], d), generator=c.generator(key_config)) * (hi - lo) + lo
        self.mus = mus.to(device, torch.float64)
        self.scale0 = torch.tensor([pb["initial_q_var"] ** 0.5] * d + [pb["initial_p_var"] ** 0.5] * d,
                                   dtype=torch.float64, device=device)
        self.k_init, self.k_term, self.k_0T = c.split(key_dataset, 3)

    def simulate(self, key: int, z0, n_steps: int, rows, trajectory: bool):
        """BAOAB in float64 of the shard's particles `rows` (int64 [m]) from
        the shard's initial states z0 [n, 2d]: (final [m, 2d], states after
        steps 0..n_steps-1 [m, n_steps, 2d] or None)."""
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=c.generator(key)))
        d, dt, gamma = self.d, self.T / n_steps, self.gamma
        if self.device.type == "cuda":
            ids = rows.to(self.device)
            z = z0[ids]
            tau0 = (philox.phases(ids, seed, torch.float32) * dt).double()
            noise = lambda s: philox.normals(ids, s, seed, d, torch.float64)
        else:
            z, ids = z0, None
            g = c.generator(seed, self.device)
            tau0 = (torch.rand((z.shape[0],), generator=g, device=self.device) * dt).double()
            noise = lambda s: torch.randn((z.shape[0], d), generator=g, device=self.device).double()
        q, p = z[:, :d].clone(), z[:, d:].clone()
        f = self.force(q)
        states = []
        for s in range(n_steps + 1):
            h = tau0[:, None] if s == 0 else (dt - tau0[:, None] if s == n_steps else dt)
            c1 = torch.exp(-gamma * torch.as_tensor(h, dtype=torch.float64, device=self.device))
            c2 = torch.sqrt((1.0 - c1 * c1) / gamma)
            xi = noise(s)
            p = p - 0.5 * h * f
            q = q + 0.5 * h * p
            p = c1 * p + c2 * xi
            q = q + 0.5 * h * p
            f = self.force(q)
            p = p - 0.5 * h * f
            if trajectory and s < n_steps:
                states.append(torch.cat([q, p], -1))
        final = torch.cat([q, p], -1)
        traj = torch.stack(states, 1) if trajectory else None
        if ids is None:  # the whole shard was simulated
            sel = rows.to(self.device)
            return final[sel], (traj[sel] if trajectory else None)
        return final, traj

    def boundary(self):
        """{initial, terminal}: the store's full sets (float64)."""
        d2 = 2 * self.d
        initial = torch.cat([self.initial(c.fold_in(self.k_init, start), n)
                             for start, n in shards(self.n_init, d2)])
        terminal = []
        for start, n in shards(self.n_term, d2):
            k0, k1 = c.split(c.fold_in(self.k_term, start), 2)
            rows = torch.arange(n, dtype=torch.int64)
            terminal.append(self.simulate(k1, self.initial(k0, n), self.n_steps_term, rows, False)[0])
        return {"initial": initial, "terminal": torch.cat(terminal)}

    def trajectories(self, wanted: np.ndarray):
        """{row: states [n_steps_0T, 2d]} of the store's trajectories `wanted`."""
        out = {}
        for start, n in shards(self.n_traj, self.n_time * 2 * self.d):
            rows = wanted[(wanted >= start) & (wanted < start + n)]
            if rows.size == 0:
                continue
            k0, k1 = c.split(c.fold_in(self.k_0T, start), 2)
            local = torch.from_numpy(rows - start).to(torch.int64)
            _, traj = self.simulate(k1, self.initial(k0, n), self.n_time, local, True)
            out.update(zip(rows.tolist(), traj))
        return out


def loss_and_grad(net, params, data, prob: Problem):
    """(loss, grads, scale), the loss's per-point means accumulated over
    blocks; scale is the sum of its terms' magnitudes.  The quadratic head
    adds A^T A x + b to grad V, |A v|^2 to v^T Hess V v."""
    d, dtype = prob.d, next(iter(params.values())).dtype
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    A, b = leaves["quad_A"], leaves["quad_b"]
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
    for sl in c.blocks(n, kgmm.POINTS_PER_BLOCK):
        x, v = path[sl, :d].to(dtype), path[sl, d:].to(dtype)
        U = torch.cat([eye.expand(x.shape[0], d, d), v[:, None]], 1)
        with torch.enable_grad():
            h, dh, d2h = c.jets(net, leaves, x, U, second=True)
            Ax, Av = x @ A.T, v @ A.T
            grad = 2.0 * torch.einsum("pf,pkf->pk", h, dh[:, :d]) + Ax @ A + b
            quad = 2.0 * (torch.sum(dh[:, d] ** 2, -1) + torch.sum(h * d2h, -1)) + torch.sum(Av * Av, -1)
            part = torch.stack([torch.sum(grad * grad), -2.0 * torch.sum(quad),
                                2.0 * prob.gamma * torch.sum(grad * v)]) / n
            accumulate(part, 0)
    for at, (name, sign) in enumerate((("terminal", 1.0), ("initial", -1.0)), 3):
        z = data[name]
        m = z.shape[0]
        for sl in c.blocks(m, kgmm.POINTS_PER_BLOCK):
            x, v = z[sl, :d].to(dtype), z[sl, d:].to(dtype)
            with torch.enable_grad():
                h, dh, _ = c.jets(net, leaves, x, v[:, None], second=False)
                dv = 2.0 * torch.sum(h * dh[:, 0], -1) + torch.sum((x @ A.T) * (v @ A.T), -1) + v @ b
                part = sign * (2.0 / prob.T) * torch.sum(dv) / m
                accumulate(part[None], at)
    return float(terms.sum()) + true_term, grads, float(terms.abs().sum()) + abs(true_term)


def follow_cell(cfg: dict, seed: int, params0, device, dtype=torch.float64, tf32=False,
                fault=None, n_steps=3) -> c.Readings:
    """The first `n_steps` training steps from params0 with the data the
    program's seed derivation gives each step.  `fault`: "half_batch" (the
    first half of the path points, in the gather's order, and of the
    boundary sets; the mean over them) or "altered" (the first leaf's
    gradient 10 % off)."""
    net = net_from_config(cfg)
    prob = Problem(cfg, device)
    s = cfg["settings"]
    key_trainer = c.split(s["seed"], 4)[2]
    train_key = c.split(key_trainer, 2)[0]
    steps = [draws(c.fold_in(train_key, k), prob.n_traj, prob.n_time, prob.batch) for k in range(n_steps)]
    states = prob.trajectories(np.unique(np.concatenate([rows for _, rows in steps])))
    bnd = prob.boundary()
    t_len = max(1, prob.n_time // STRIDE)

    def step(params, k):
        shift, rows = steps[k]
        stamps = torch.arange(t_len, device=prob.device) * STRIDE + shift
        path = torch.stack([states[r] for r in rows.tolist()])[:, stamps].reshape(-1, 2 * prob.d)
        data = {**bnd, "0T": path}
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
