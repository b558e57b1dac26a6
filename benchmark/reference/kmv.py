"""Plain reference of the KMV MLP training step: the exact-law sampler, the
kinetic McKean-Vlasov consistency loss of a PotentialMLP interaction kernel
over every pair at a stamp, its parameter gradient, and the optimizer.

Problem (the configuration's ``problem`` block): dz = A z dt + sqrt(L) dW
with A = [[0, I], [-F, -gamma I]], L = diag(0, 2I), z0 ~ N(0, I), and the
interaction Phi_true(x) = x^T F x / 2, F = G G^T for G [d, d+1] drawn from
``truth_seed``.  A step draws stratified stamps t_s = s T / nt + U[0, T/nt),
samples z ~ N(m(t), P(t)) at each (moments by Van Loan's matrix exponential,
float64), and evaluates

    loss = E ||E_r grad Phi(x - r)||^2 - 2 E E_r[v^T Hess Phi(x - r) v]
         + 2 E[E_r Phi(x - r) w(t, x)] + E ||E_r grad Phi_true(x - r)||^2,

the expectations over the samples and the refs r at the same stamp (the
point itself included), w = d2s log rho + (ds log rho)^2 + gamma ds log rho
of the position marginal, its time derivatives taken by autodiff through
the moments' second-order Taylor expansion in t.
"""

from __future__ import annotations

import torch

from benchmark.reference import common as c

PAIRS_PER_BLOCK = 1 << 18


def _moments(A, L, P0, ts):
    """(m [T, D], P [T, D, D]) of the linear SDE from z0 ~ N(0, P0)."""
    n = A.shape[0]
    out_m, out_P = [], []
    for t in ts.tolist():
        block = torch.zeros((2 * n, 2 * n), dtype=torch.float64)
        block[:n, :n], block[:n, n:], block[n:, n:] = -A, L, A.T
        G = torch.linalg.matrix_exp(block * t)
        phi = G[n:, n:].T
        P = phi @ P0 @ phi.T + phi @ G[:n, n:]
        out_m.append(torch.zeros(n, dtype=torch.float64))
        out_P.append(0.5 * (P + P.T))
    return torch.stack(out_m), torch.stack(out_P)


def _log_density_derivatives(A, L, m, P, x, d):
    """(d/ds, d2/ds2) of log N(x; m(s)[:d], P(s)[:d, :d]) at the stamps:
    m, P [T, D, ...], x [n, T, d] -> two [n, T]."""
    dm, dP = m @ A.T, A @ P + P @ A.T + L
    d2m, d2P = dm @ A.T, A @ dP + dP @ A.T
    eps = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device, requires_grad=True)
    e = eps[..., None]
    mm = (m + e * dm + 0.5 * e * e * d2m)[..., :d]
    PP = (P + e[..., None] * dP + 0.5 * (e * e)[..., None] * d2P)[..., :d, :d]
    u = x - mm
    logp = (-0.5 * torch.logdet(PP)
            - 0.5 * torch.sum(u * torch.linalg.solve(PP, u[..., None])[..., 0], -1))
    d1, = torch.autograd.grad(logp.sum(), eps, create_graph=True)
    d2, = torch.autograd.grad(d1.sum(), eps)
    return d1.detach(), d2


class Problem:
    def __init__(self, cfg: dict, device, dtype):
        s, pb = cfg["settings"], cfg["problem"]
        self.device, self.dtype = torch.device(device), dtype
        self.d = s["pde_instance.domain_dim"]
        self.T = s["pde_instance.total_evolving_time"]
        self.gamma = pb["gamma_friction"]
        self.nt, self.n = s["solver.train.n_time_stamps"], s["solver.train.sample_per_time"]
        d = self.d
        G = torch.randn((d, d + 1), generator=c.generator(pb["truth_seed"])).double()
        self.F = G @ G.T
        eye, zero = torch.eye(d, dtype=torch.float64), torch.zeros((d, d), dtype=torch.float64)
        self.A = torch.cat([torch.cat([zero, eye], 1), torch.cat([-self.F, -self.gamma * eye], 1)], 0)
        self.L = torch.block_diag(zero, 2.0 * eye)
        self.P0 = torch.eye(2 * d, dtype=torch.float64)

    def sample(self, key_sample: int):
        """(x [n, T, d], v [n, T, d], w [n, T], |E_r grad Phi_true|^2 mean)."""
        dev = self.device
        _, _, key_0T = c.split(key_sample, 3)
        key_t, key_x = c.split(key_0T, 2)
        u = torch.rand((self.nt,), generator=c.generator(key_t, dev), device=dev)
        base = torch.linspace(0.0, self.T, self.nt + 1, device=dev)[:-1]
        ts = base.double() + u.double() * (self.T / self.nt)
        m, P = _moments(self.A, self.L, self.P0, ts.cpu())
        eps = torch.randn((self.n, self.nt, 2 * self.d), generator=c.generator(key_x, dev), device=dev)
        chol = torch.linalg.cholesky(P).to(dev)
        z = torch.einsum("tij,ntj->nti", chol, eps.double()) + m.to(dev)
        x, v = z[..., : self.d], z[..., self.d:]
        d1, d2 = _log_density_derivatives(self.A.to(dev), self.L.to(dev), m.to(dev), P.to(dev), x, self.d)
        w = d2 + d1 * d1 + self.gamma * d1
        F = self.F.to(dev)
        nabla_true = (x - x.mean(0, keepdim=True)) @ F.T
        true_term = torch.mean(torch.sum(nabla_true ** 2, -1))
        return x.to(self.dtype), v.to(self.dtype), w.to(self.dtype), true_term.to(self.dtype)


def loss_and_grad(net, params, x, v, w, true_term):
    """(loss, grads, scale) of the consistency loss over every pair at each
    stamp, accumulated over blocks of rows (each block holds whole rows, so
    its part of the loss is complete); scale is the sum of its terms'
    magnitudes."""
    n, nt, d = x.shape
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    terms = torch.zeros(3, dtype=torch.float64)
    rows = max(1, PAIRS_PER_BLOCK // n)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    for t in range(nt):
        xt, vt, wt = x[:, t], v[:, t], w[:, t]
        for sl in c.blocks(n, rows):
            r = xt[sl].shape[0]
            y = (xt[sl, None, :] - xt[None, :, :]).reshape(-1, d)
            U = torch.cat([eye.expand(r * n, d, d),
                           vt[sl, None, None, :].expand(r, n, 1, d).reshape(-1, 1, d)], 1)
            with torch.enable_grad():
                h, dh, d2h = c.jets(net, leaves, y, U, second=True)
                grad = 2.0 * torch.einsum("pf,pkf->pk", h, dh[:, :d])
                quad = 2.0 * (torch.sum(dh[:, d] ** 2, -1) + torch.sum(h * d2h, -1))
                val = torch.sum(h * h, -1)
                N = grad.reshape(r, n, d).mean(1)
                part = torch.stack([torch.sum(N * N), -2.0 * torch.sum(quad.reshape(r, n).mean(1)),
                                    2.0 * torch.sum(val.reshape(r, n).mean(1) * wt[sl])]) / (n * nt)
                gs = torch.autograd.grad(part.sum(), list(leaves.values()))
            terms += part.detach().double().cpu()
            for k, g in zip(leaves, gs):
                grads[k] += g
    true_term = float(true_term)
    return float(terms.sum()) + true_term, grads, float(terms.abs().sum()) + abs(true_term)


def follow_cell(cfg: dict, seed: int, params0, device, dtype=torch.float64, tf32=False,
                fault=None, n_steps=3) -> c.Readings:
    """The first `n_steps` training steps from params0 with the data the
    program's seed derivation gives each step.  `fault`: "half_batch" (half
    the samples of each stamp, the mean over the rest) or "altered" (the
    first leaf's gradient 10 % off) plants a fault in the reference put in
    the program's place."""
    net = c.net_from_config(cfg)
    prob = Problem(cfg, device, dtype)
    s = cfg["settings"]
    key_trainer = c.split(s["seed"], 4)[2]
    train_key = c.split(key_trainer, 2)[0]

    def step(params, k):
        key_sample = c.split(c.fold_in(train_key, k), 2)[0]
        x, v, w, true_term = prob.sample(key_sample)
        if fault == "half_batch":
            half = x.shape[0] // 2
            x, v, w = x[:half], v[:half], w[:half]
            true_term = torch.mean(torch.sum(((x - x.mean(0, keepdim=True)) @ prob.F.to(x).T) ** 2, -1))
        loss, grads, scale = loss_and_grad(net, params, x, v, w, true_term)
        if fault == "altered":
            first = next(iter(grads))
            grads[first] = grads[first] * 1.1
        return loss, grads, scale

    with c.matmul_precision(tf32):
        return c.follow(step, {k: p.to(device) for k, p in params0.items()}, c.optimizer(cfg),
                        n_steps, dtype)
