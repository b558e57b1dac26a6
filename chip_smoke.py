#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs a CUDA device and fails (exit
code != 0, no result line) without one; it never falls back to the CPU.
Phases, each printing its own line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles K1 (``pde_inverse_torch/csrc/langevin.cu``), K3/K4
   (``csrc/pointwise.cu``) and K5-K8 (``csrc/pairwise.cu``) with nvcc, one
   process per source, together;
3. K1 against its plain PyTorch version on the card, at the KGMM main
   path's shapes (d=4; GMM with k=3 and a Quadratic potential; 2,500
   particles with a trajectory and 75,000 without; 200 steps; EM and
   BAOAB), plus the antithetic pairing and the exact OU moment law;
4. K3 and K4 against their plain versions, both held against a float64
   run of the plain version, at the non-parametric main path's shape
   (250,000 path points, layers 64->64->256, tanh), a ragged n, and silu
   and softplus; K4's outputs bitwise equal on two calls;
   K5-K8 against their plain versions, held the same way, at the KMV main
   path's shape (7 stamps x 2,000 points x 2,000 refs, layers 20 x 8 ->
   128, tanh), a ragged n and m with masked refs, and silu and softplus;
   K6's and K8's outputs bitwise equal on two calls;
5. the main paths: ``pde_inverse_torch.main.run`` on preset KGMM, then on
   preset KGMM-nonparametric-online, each at full width for 20 steps with
   the launch counts set to 0 just before and read just after; the split
   of one step's time between sampling and loss/gradient (for the
   non-parametric path with kfp_fused auto, xla and off); one loss/gradient
   step of each on the card against the same step on the CPU.  Then the
   KMV paths, each read the same way: the MLP configuration (the JAX
   package's ``mlp_pairwise`` bench row) for 20 steps with kmv_pallas=auto
   (K7/K8), a shorter run with kmv_pallas=on (K5/K6), preset KMV
   (parametric, closed form) for 20 steps; the KMV step's split by
   kmv_pallas mode; one np KMV step on the card against the CPU;
6. timing of K1 and K3-K8 against their plain versions with CUDA events.

The line before the last is a JSON object describing each kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, each with its reason.
# Noiseless K1 vs its plain version after 200 f32 steps: the same arithmetic
# in another order (fused multiply-adds in the kernel, separate torch ops in
# the plain version).  Particles that pass near a ridge between two GMM wells
# amplify last-bit differences by up to exp(lambda T) (lambda ~ 4 for means in
# [-4, 4]^4), so a fixed absolute bound is either loose or flaky.  The gate is
# relative to that amplification: both runs are held against a float64 run of
# the plain version, and the kernel may be at most NOISELESS_FACTOR times as
# far from it as the float32 plain version is, plus NOISELESS_ATOL.
NOISELESS_FACTOR = 8.0
NOISELESS_ATOL = 1e-5
# +/- antithetic pair mean vs the noiseless run with zero force: the update
# is affine in the noise, so only f32 rounding separates them.
PAIR_MEAN_ATOL = 5e-5
# OU law at n=75,000 particles: Monte Carlo error (about 0.01) plus the
# O(dt) weak error of the integrators at dt = 0.01.
OU_MEAN_ATOL = 0.05
OU_COV_ATOL = 0.1
# one loss/gradient step on the card vs the CPU on the same batch: f32 sums
# over 1,280 path points in another order
STEP_RTOL = 1e-4
# K3/K4 vs a float64 run of the plain version, relative to each output's
# max-abs (weight gradients are sums over all points): the kernel may be at
# most F64_FACTOR times as far from it as the float32 plain version is,
# plus F64_FLOOR.  Both differ from it only by f32 rounding in another
# order (FMA chains in the kernel, blocked cuBLAS sums in the plain version).
F64_FACTOR = 8.0
F64_FLOOR = 1e-6
# one non-parametric loss/gradient step, card (K3/K4) vs CPU (autodiff), on
# one shared batch: loss and gap relative, each gradient leaf relative to
# its max-abs (tests/test_fused_pointwise.py: 1e-5 and 3e-4 for the fused
# path against autodiff in f32), with room for the card's summation order
NP_LOSS_RTOL = 1e-4
NP_GRAD_RTOL = 3e-4

# one KMV loss/gradient step, card (K7/K8) vs CPU (the plain |f|^2
# formulation), on a shared batch: the collapsed head reassociates the
# feature contraction, so the JAX package's own gate for the packed kernels
# against its plain path applies (tests/test_pallas_packed.py: 2e-4 on the
# loss, 5e-3 relative per gradient leaf)
KMV_LOSS_RTOL = 2e-4
KMV_GRAD_RTOL = 5e-3

D, K, N_STEPS, T, GAMMA = 4, 3, 200, 2.0, 0.5
DT = T / N_STEPS
N_PATH, N_TERMINAL = 2_500, 75_000
# KGMM-nonparametric-online: 2,500 trajectories x 200 steps at stride 2; the
# PotentialMLP's first layer is 4 + 2 x 64 -> 64, then 64 -> 64 -> 256
N_POINTS, WIDTHS = 250_000, (64, 64, 256)
# the KMV MLP configuration: 7 stamps x 2,000 samples (refs = the samples at
# the same stamp), PotentialMLP 2 -> 20 x 8 -> 128, tanh
KMV_NT, KMV_N, KMV_WIDTHS = 7, 2_000, (20,) * 8 + (128,)
KMV_MLP = ["preset=KMV-nonparametric-fourier", "neural_network.model=mlp",
           "neural_network.fourier_features=0", "neural_network.fourier_trainable=False",
           "solver.train.kmv_field_reg=0.0", "train.optimizer.weight_decay=1e-1",
           "logging.writer=none"]
KMV_RUN = KMV_MLP + ["train.number_of_iterations=20", "train.steps_per_chunk=10", "test.frequency=20"]
KMV_ON_STEPS = 4
NP_RUN = ["preset=KGMM-nonparametric-online", "train.number_of_iterations=20",
          "train.steps_per_chunk=10", "test.frequency=20", "logging.writer=none",
          "train.optimizer.ema_switch_step=10"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def ou_moments(F: np.ndarray, L: np.ndarray, m0: np.ndarray, P0: np.ndarray, t: float):
    """Exact (mean, cov) at time t of dz = F z dt + sqrt(L) dW (Van Loan, float64)."""
    n = F.shape[0]
    block = np.zeros((2 * n, 2 * n))
    block[:n, :n], block[:n, n:], block[n:, n:] = -F, L, F.T
    G = torch.linalg.matrix_exp(torch.from_numpy(block * t)).numpy()
    phi = G[n:, n:].T
    cov = phi @ P0 @ phi.T + phi @ G[:n, n:]
    return phi @ m0, 0.5 * (cov + cov.T)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def registers(lib_path) -> list:
    return [int(ln.split("Used ")[1].split()[0]) for ln in
            lib_path.with_suffix(".log").read_text().splitlines() if "Used " in ln]


def pointwise_inputs(dev, n, dtype, seed, widths=WIDTHS):
    """Layers after the first, first-layer streams and cotangents, from a
    seed (the same numbers in float32 and float64)."""
    gen = torch.Generator().manual_seed(seed)
    mids = [(torch.randn((a, b), generator=gen) / a**0.5, torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    streams = [torch.randn((n, widths[0]), generator=gen) * s for s in (1.0, 0.7, 0.3)]
    cot = [torch.randn(n, generator=gen), torch.randn((n, widths[0]), generator=gen)]
    to = lambda t: t.to(dev, dtype)
    return [(to(W), to(b)) for W, b in mids], [to(t) for t in streams], [to(t) for t in cot]


def pairwise_inputs(dev, nt, n, m, dtype, seed, zero_refs=()):
    """Layers after the first, ax, av, ar, mask and the cotangents of the
    pairwise kernels, from a seed (the same numbers in float32 and float64)."""
    gen = torch.Generator().manual_seed(seed)
    widths = KMV_WIDTHS
    mids = [(torch.randn((a, b), generator=gen) / a**0.5, torch.randn(b, generator=gen) * 0.1)
            for a, b in zip(widths, widths[1:])]
    w0 = widths[0]
    ax, av, ar = (torch.randn((nt, k, w0), generator=gen) * s for k, s in ((n, 1.0), (n, 0.7), (m, 1.0)))
    mask = torch.ones(m)
    mask[list(zero_refs)] = 0.0
    cot = [torch.randn((nt, n), generator=gen), torch.randn((nt, n), generator=gen),
           torch.randn((nt, n, w0), generator=gen)]
    to = lambda t: t.to(dev, dtype)
    return [(to(W), to(b)) for W, b in mids], [to(t) for t in (ax, av, ar, mask)], [to(t) for t in cot]


def pairwise_call(kid, fn, act, mids, tensors, cot):
    """Call K5-K8 (or a plain version) the way the provider does: K7/K8 take
    the hidden layers and the collapsed head M = W_F W_F^T, u = 2 W_F b_F."""
    if kid in ("K7", "K8"):
        WF, bF = mids[-1]
        args = (mids[:-1], WF @ WF.T, 2.0 * (WF @ bF))
    else:
        args = (mids,)
    return fn(*args, act, *tensors, *(cot if kid in ("K6", "K8") else []))


def flat(out) -> list:
    """A kernel's outputs (a dict, or a tuple of tensors and [(Wbar, bbar)]
    lists) as a list of tensors."""
    if isinstance(out, dict):
        return [out["value"], out["hess"], out["s_dz0"]]
    res = []
    for item in out:
        res += [t for pair in item for t in pair] if isinstance(item, list) else [item]
    return res




def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this runs on the card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from pde_inverse_torch import rng
    from pde_inverse_torch.device import setup_precision
    from pde_inverse_torch.main import parse_args, run
    from pde_inverse_torch.methods import functional_forward
    from pde_inverse_torch.ops.cuda import build
    from pde_inverse_torch.ops.cuda.langevin import langevin, langevin_plain
    from pde_inverse_torch.ops.cuda.pointwise import (
        mlp_grad_quad, mlp_grad_quad_bwd, mlp_grad_quad_bwd_plain, mlp_grad_quad_plain,
    )
    from pde_inverse_torch.ops.cuda import pairwise as pw
    from pde_inverse_torch.ops.simulate import simulate
    from pde_inverse_torch.potentials import GMMPotential, QuadraticPotential
    from pde_inverse_torch.registry import get_method, get_pde_instance

    dev = torch.device("cuda")
    setup_precision()

    # -- 1. device -------------------------------------------------------------
    print(nvidia_smi())
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_k1, lib_pw, lib_pair = build.build_all(["langevin", "pointwise", "pairwise"])
    build_s = time.perf_counter() - t0
    for what, lib_path in (("K1", lib_k1), ("K3/K4", lib_pw), ("K5-K8", lib_pair)):
        regs = registers(lib_path)
        own_s = lib_path.with_suffix(".log").read_text().splitlines()[1]
        print(f"[build] {what} {lib_path.name} ({own_s.strip('# ')}; all sources together in "
              f"{build_s:.1f} s): {len(regs)} kernels, {min(regs)}..{max(regs)} registers per "
              f"thread", flush=True)

    # -- 3. K1 against its plain version -----------------------------------------
    gen = torch.Generator().manual_seed(20261016)
    mus = (torch.rand((K, D), generator=gen) * 8.0 - 4.0).to(dev)
    gmm = GMMPotential.create(mus, 1.0)
    A = torch.randn((D, D + 1), generator=gen, dtype=torch.float64)
    tF = (A @ A.T / D).numpy()
    quad = QuadraticPotential(
        mu=torch.zeros(D, device=dev),
        inv_cov=torch.as_tensor(tF, dtype=torch.float32, device=dev),
    )
    as_f64 = {
        "gmm": GMMPotential.create(mus.double(), 1.0),
        "quadratic": QuadraticPotential(mu=quad.mu.double(), inv_cov=quad.inv_cov.double()),
    }
    scale = torch.tensor([2.0] * D + [math.sqrt(0.1)] * D)

    def initial(n):  # the KGMM initial law N(0, diag(4 I, 0.1 I))
        return (torch.randn((n, 2 * D), generator=gen) * scale).to(dev)

    def max_diff(xs, ys) -> float:
        return max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(xs, ys) if a is not None)

    max_err = 0.0
    rows = []
    for pot_name, pot in (("gmm", gmm), ("quadratic", quad)):
        for integ in ("euler", "baoab"):
            for n, with_traj in ((N_PATH, True), (N_TERMINAL, False)):
                z0 = initial(n)
                kw = dict(return_trajectory=with_traj, random_phase=False,
                          noise_scale=0.0, integrator=integ)
                got = langevin(3, z0, N_STEPS, DT, pot, GAMMA, **kw)
                want = langevin_plain(3, z0, N_STEPS, DT, pot, GAMMA, **kw)
                ref = langevin_plain(3, z0.double(), N_STEPS, DT, as_f64[pot_name], GAMMA, **kw)
                torch.cuda.synchronize()
                err, err_k, err_p = max_diff(got, want), max_diff(got, ref), max_diff(want, ref)
                bound = NOISELESS_FACTOR * err_p + NOISELESS_ATOL
                check(math.isfinite(err) and err_k <= bound,
                      f"noiseless {pot_name}/{integ}/n={n}: kernel vs f64 {err_k:.3e} > "
                      f"{NOISELESS_FACTOR} x plain-f32 vs f64 {err_p:.3e} + {NOISELESS_ATOL}")
                max_err = max(max_err, err)
                rows.append(f"{pot_name}/{integ}/{n}: {err:.2e} ({err_k:.2e} vs {err_p:.2e})")
    print(f"[k1-vs-plain] noiseless, 200 steps, max abs err kernel vs plain (kernel vs f64, "
          f"plain f32 vs f64): {'; '.join(rows)}; gate kernel-vs-f64 <= {NOISELESS_FACTOR} x "
          f"plain-vs-f64 + {NOISELESS_ATOL}: pass", flush=True)

    key = 424242
    z0 = initial(N_PATH)
    pair = simulate(key, z0, N_STEPS, DT, gmm, GAMMA, antithetic=True, z0_mirror=-z0)
    plain = simulate(key, z0, N_STEPS, DT, gmm, GAMMA)
    torch.cuda.synchronize()
    for a, b in zip(pair, plain):
        check(torch.equal(a[:N_PATH], b), "+1 half of the antithetic call is not bitwise a plain call")
    free = QuadraticPotential(mu=torch.zeros(D, device=dev), inv_cov=torch.zeros((D, D), device=dev))
    pair_err = 0.0
    for integ in ("euler", "baoab"):
        runs = {s: langevin(99, z0, N_STEPS, DT, free, GAMMA, return_trajectory=True,
                            noise_scale=s, integrator=integ) for s in (1.0, -1.0, 0.0)}
        for idx in (0, 1):
            mean = 0.5 * (runs[1.0][idx] + runs[-1.0][idx])
            pair_err = max(pair_err, float((mean - runs[0.0][idx]).abs().max()))
        check(torch.equal(runs[1.0][2], runs[-1.0][2]), "antithetic halves differ in phase")
        check(float((runs[1.0][0] - runs[0.0][0]).abs().max()) > 0.1, "noise has no effect")
    check(pair_err <= PAIR_MEAN_ATOL, f"antithetic pair mean vs noiseless: {pair_err:.3e}")
    print(f"[k1-antithetic] +1 half bitwise equal to a plain call; force-free pair mean "
          f"vs noiseless max abs err {pair_err:.3e} <= {PAIR_MEAN_ATOL}", flush=True)

    F = np.block([[np.zeros((D, D)), np.eye(D)], [-tF, -GAMMA * np.eye(D)]])
    L = np.block([[np.zeros((D, D)), np.zeros((D, D))], [np.zeros((D, D)), 2.0 * np.eye(D)]])
    mean_ex, cov_ex = ou_moments(F, L, np.zeros(2 * D), np.eye(2 * D), T)
    z0 = torch.randn((N_TERMINAL, 2 * D), generator=gen).to(dev)
    ou_errs = []
    for integ in ("euler", "baoab"):
        final, _, _ = langevin(7, z0, N_STEPS, DT, quad, GAMMA, integrator=integ)
        f = final.double().cpu().numpy()
        e_mean = float(np.abs(f.mean(0) - mean_ex).max())
        e_cov = float(np.abs(np.cov(f.T) - cov_ex).max())
        check(e_mean <= OU_MEAN_ATOL and e_cov <= OU_COV_ATOL,
              f"OU law {integ}: mean err {e_mean:.3e}, cov err {e_cov:.3e}")
        ou_errs.append(f"{integ} mean {e_mean:.3e} cov {e_cov:.3e}")
    print(f"[k1-ou-law] Quadratic d=4, 75000 particles, T=2: {'; '.join(ou_errs)} "
          f"(<= {OU_MEAN_ATOL} / {OU_COV_ATOL})", flush=True)

    # -- 4. K3/K4 against their plain versions ----------------------------------------
    k34_err = {"K3": 0.0, "K4": 0.0}
    for name, kernel, plain in (("K3", mlp_grad_quad, mlp_grad_quad_plain),
                                ("K4", mlp_grad_quad_bwd, mlp_grad_quad_bwd_plain)):
        rows = []
        for act, n in (("tanh", N_POINTS), ("tanh", 4_099), ("silu", 20_000), ("softplus", 20_000)):
            mids, streams, cot = pointwise_inputs(dev, n, torch.float32, 5)
            mids64, streams64, cot64 = pointwise_inputs(dev, n, torch.float64, 5)
            args, args64 = streams + (cot if name == "K4" else []), streams64 + (cot64 if name == "K4" else [])
            got, want = flat(kernel(mids, act, *args)), flat(plain(mids, act, *args))
            ref = flat(plain(mids64, act, *args64))
            torch.cuda.synchronize()
            worst_k, worst_p = 0.0, 0.0
            for k_, p_, r_ in zip(got, want, ref):
                scale = float(r_.abs().max())
                err_k = float((k_.double() - r_).abs().max()) / scale
                err_p = float((p_.double() - r_).abs().max()) / scale
                check(bool(torch.isfinite(k_).all()) and err_k <= F64_FACTOR * err_p + F64_FLOOR,
                      f"{name} {act} n={n} output {tuple(k_.shape)}: kernel vs f64 {err_k:.3e} > "
                      f"{F64_FACTOR} x plain-f32 vs f64 {err_p:.3e} + {F64_FLOOR}")
                worst_k, worst_p = max(worst_k, err_k), max(worst_p, err_p)
                k34_err[name] = max(k34_err[name], float((k_ - p_).abs().max()))
            rows.append(f"{act}/{n}: {worst_k:.2e} vs {worst_p:.2e}")
            del got, want, ref
        print(f"[{name.lower()}-vs-plain] layers 64->64->256, worst output error relative to its "
              f"max-abs, kernel vs f64 / plain f32 vs f64: {'; '.join(rows)}; gate <= "
              f"{F64_FACTOR} x plain + {F64_FLOOR}: pass; max abs err kernel vs plain "
              f"{k34_err[name]:.3e}", flush=True)
    mids, streams, cot = pointwise_inputs(dev, N_POINTS, torch.float32, 6)
    a = flat(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot))
    b = flat(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot))
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "K4 outputs differ between two calls")
    print(f"[k4-repeat] n={N_POINTS}: two calls bitwise equal in all {len(a)} outputs", flush=True)
    del a, b

    kernels = {"K5": (pw.mlp_pairwise_sums, pw.mlp_pairwise_sums_plain),
               "K6": (pw.mlp_pairwise_sums_bwd, pw.mlp_pairwise_sums_bwd_plain),
               "K7": (pw.mlp_pairwise_sums_packed, pw.mlp_pairwise_sums_packed_plain),
               "K8": (pw.mlp_pairwise_sums_packed_bwd, pw.mlp_pairwise_sums_packed_bwd_plain)}
    pair_cases = (("tanh", KMV_NT, KMV_N, KMV_N, ()), ("tanh", KMV_NT, 1_999, 1_013, (0, 7, 500, 1_012)),
                  ("silu", 2, 300, 257, (3,)), ("softplus", 2, 300, 257, (3,)))
    pair_err = {kid: 0.0 for kid in kernels}
    for kid, (kernel, plain) in kernels.items():
        rows = []
        for act, nt_, n_, m_, zeros in pair_cases:
            mids, tens, cot = pairwise_inputs(dev, nt_, n_, m_, torch.float32, 8, zeros)
            mids64, tens64, cot64 = pairwise_inputs(dev, nt_, n_, m_, torch.float64, 8, zeros)
            got = flat(pairwise_call(kid, kernel, act, mids, tens, cot))
            want = flat(pairwise_call(kid, plain, act, mids, tens, cot))
            ref = flat(pairwise_call(kid, plain, act, mids64, tens64, cot64))
            torch.cuda.synchronize()
            worst_k, worst_p = 0.0, 0.0
            for k_, p_, r_ in zip(got, want, ref):
                scale = float(r_.abs().max())
                err_k = float((k_.double() - r_).abs().max()) / scale
                err_p = float((p_.double() - r_).abs().max()) / scale
                check(bool(torch.isfinite(k_).all()) and err_k <= F64_FACTOR * err_p + F64_FLOOR,
                      f"{kid} {act} {nt_}x{n_}x{m_} output {tuple(k_.shape)}: kernel vs f64 {err_k:.3e} > "
                      f"{F64_FACTOR} x plain-f32 vs f64 {err_p:.3e} + {F64_FLOOR}")
                worst_k, worst_p = max(worst_k, err_k), max(worst_p, err_p)
                pair_err[kid] = max(pair_err[kid], float((k_ - p_).abs().max()))
            rows.append(f"{act}/{nt_}x{n_}x{m_}{'/masked' if zeros else ''}: {worst_k:.2e} vs {worst_p:.2e}")
            del got, want, ref
        print(f"[{kid.lower()}-vs-plain] layers 20x8->128, worst output error relative to its max-abs, "
              f"kernel vs f64 / plain f32 vs f64: {'; '.join(rows)}; gate <= {F64_FACTOR} x plain + "
              f"{F64_FLOOR}: pass; max abs err kernel vs plain {pair_err[kid]:.3e}", flush=True)
    for kid in ("K6", "K8"):
        mids, tens, cot = pairwise_inputs(dev, KMV_NT, KMV_N, KMV_N, torch.float32, 9)
        a = flat(pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot))
        b = flat(pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot))
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{kid} outputs differ between two calls")
        print(f"[{kid.lower()}-repeat] {KMV_NT}x{KMV_N}x{KMV_N}: two calls bitwise equal in all "
              f"{len(a)} outputs", flush=True)
        del a, b

    # -- 5. main paths ---------------------------------------------------------------
    cfg, _ = parse_args(["preset=KGMM", "train.number_of_iterations=20",
                         "train.steps_per_chunk=10", "test.frequency=20", "logging.writer=none"])
    check(cfg.pde_instance.domain_dim == D and cfg.solver.train.batch_size_0T == N_PATH
          and cfg.pde_instance.n_steps == N_STEPS, "KGMM preset width changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    langevin.launches = mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
    result = run(cfg, "cuda")
    torch.cuda.synchronize()
    launches = langevin.launches
    peak = torch.cuda.max_memory_allocated()
    n_iter = cfg.train.number_of_iterations
    check(len(result.losses) == n_iter and bool(np.isfinite(result.losses).all()),
          f"losses not finite: {result.losses}")
    check(launches >= 2 * n_iter, f"K1 launched {launches} times in {n_iter} steps")
    check(result.rel_l2 is not None and math.isfinite(result.rel_l2), "rel-L2 not finite")
    check(all(math.isfinite(v) for v in result.test_metrics.values()), "test metrics not finite")
    sps = result.test_metrics["steps_per_sec"]
    print(f"[main-path] KGMM full width (d=4, batch_size_0T=2500, n_steps=200): {n_iter} steps, "
          f"loss {result.losses[0]:.4e} -> {result.losses[-1]:.4e}, {sps:.3f} steps/s, "
          f"K1 launches {launches}, peak memory {peak} B ({peak / 2**30:.3f} GiB)", flush=True)

    # where one full-width step's time goes: sampling (two K1 launches) vs the
    # loss and its gradient, host clock around synchronised work
    key_problem, key_method, key_trainer, _ = rng.split(cfg.seed, 4)
    inst = get_pde_instance(cfg)(cfg, key_problem, dev)
    method = get_method(cfg)(inst, cfg, key_method, dev)
    model, params = method.create_model_fn()
    loss_mod, fwd = method._loss_module(), functional_forward(model)
    t_sample, t_loss = [], []
    for s in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = method.sample_data(rng.fold_in(key_trainer, s))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = loss_mod.value_and_grad_fn(fwd, params, batch, inst)
        float(out["loss"])
        t2 = time.perf_counter()
        if s:  # the first step warms up
            t_sample.append(t1 - t0)
            t_loss.append(t2 - t1)
    ms_sample, ms_loss = 1e3 * float(np.median(t_sample)), 1e3 * float(np.median(t_loss))
    print(f"[step-split] full-width step, median of 5: sampling (2 K1 launches + initial "
          f"draws) {ms_sample:.3f} ms, loss+gradient {ms_loss:.3f} ms", flush=True)

    # one loss/gradient step on the card vs the CPU, on one shared small batch
    cfg_s, _ = parse_args(["preset=KGMM", "solver.train.batch_size_0T=64", "pde_instance.n_steps=20"])
    key_problem, key_method, key_trainer, _ = rng.split(cfg_s.seed, 4)
    outs = {}
    batch = None
    for name in ("cuda", "cpu"):
        d = torch.device(name)
        inst = get_pde_instance(cfg_s)(cfg_s, key_problem, d)
        method = get_method(cfg_s)(inst, cfg_s, key_method, d)
        model, params = method.create_model_fn()
        if batch is None:
            batch = {k: v.cpu() for k, v in method.sample_data(key_trainer).items()}
        outs[name] = method._loss_module().value_and_grad_fn(
            functional_forward(model), params, {k: v.to(d) for k, v in batch.items()}, inst
        )
    rel = max(
        float((outs["cuda"][n].cpu() - outs["cpu"][n]).abs().max() / outs["cpu"][n].abs().max())
        for n in ("loss", "loss ground truth")
    )
    g_rel = float((outs["cuda"]["grad"]["mus"].cpu() - outs["cpu"]["grad"]["mus"]).abs().max()
                  / outs["cpu"]["grad"]["mus"].abs().max())
    check(max(rel, g_rel) <= STEP_RTOL, f"card vs CPU step: loss rel {rel:.3e}, grad rel {g_rel:.3e}")
    print(f"[main-path-vs-cpu] one step on a shared batch: loss/gap rel err {rel:.3e}, "
          f"grad rel err {g_rel:.3e} <= {STEP_RTOL}", flush=True)

    # the non-parametric main path: K1 samples, K3/K4 carry the path batch's
    # gradient and quadform; EMA switches at step 10
    cfg_np, _ = parse_args(NP_RUN)
    net = cfg_np.neural_network
    check(cfg_np.solver.train.batch_size_0T == N_PATH and cfg_np.solver.train.path_stride == 2
          and (net.hidden_dim, net.layers, net.feature_dim, net.fourier_features)
          == (64, 2, 256, 64) and cfg_np.train.optimizer.use_ema, "np preset width changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    langevin.launches = mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
    result_np = run(cfg_np, "cuda")
    torch.cuda.synchronize()
    np_launches = {"K1": langevin.launches, "K3": mlp_grad_quad.launches,
                   "K4": mlp_grad_quad_bwd.launches}
    peak_np = torch.cuda.max_memory_allocated()
    n_iter = cfg_np.train.number_of_iterations
    check(len(result_np.losses) == n_iter and bool(np.isfinite(result_np.losses).all()),
          f"np losses not finite: {result_np.losses}")
    check(np_launches["K1"] >= 2 * n_iter and np_launches["K3"] >= n_iter
          and np_launches["K4"] >= n_iter, f"np launches {np_launches} in {n_iter} steps")
    metrics_np = {**result_np.test_metrics, **result_np.result_metrics}
    check(len(result_np.result_metrics) == 3 and all(math.isfinite(v) for v in metrics_np.values()),
          f"np test metrics not finite: {metrics_np}")
    print(f"[main-path-np] KGMM-nonparametric-online full width (250000 path points, "
          f"PotentialMLP 132->64->64->256 tanh, EMA switch at 10): {n_iter} steps, loss "
          f"{result_np.losses[0]:.4e} -> {result_np.losses[-1]:.4e}, "
          f"{result_np.test_metrics['steps_per_sec']:.3f} steps/s, launches {np_launches}, "
          f"peak memory {peak_np} B ({peak_np / 2**30:.3f} GiB); result "
          + " ".join(f"{k.split()[-1]}={v:.4e}" for k, v in result_np.result_metrics.items()),
          flush=True)

    # where one full-width np step's time goes, by kfp_fused mode
    splits = {}
    for mode in ("auto", "xla", "off"):
        cfg_m, _ = parse_args(NP_RUN + [f"solver.train.kfp_fused={mode}"])
        key_problem, key_method, key_trainer, _ = rng.split(cfg_m.seed, 4)
        inst = get_pde_instance(cfg_m)(cfg_m, key_problem, dev)
        method = get_method(cfg_m)(inst, cfg_m, key_method, dev)
        model, params = method.create_model_fn()
        loss_mod, fwd = method._loss_module(), functional_forward(model)
        t_sample, t_loss = [], []
        for s_ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = method.sample_data(rng.fold_in(key_trainer, s_))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = loss_mod.value_and_grad_fn(fwd, params, batch, inst, **method._fused_kwargs())
            float(out["loss"])
            t2 = time.perf_counter()
            if s_:
                t_sample.append(t1 - t0)
                t_loss.append(t2 - t1)
        splits[mode] = (1e3 * float(np.median(t_sample)), 1e3 * float(np.median(t_loss)))
        del out, batch
    print("[step-split-np] full-width np step, median of 5: " + "; ".join(
        f"kfp_fused={m}: sampling {a:.3f} ms, loss+gradient {b:.3f} ms"
        for m, (a, b) in splits.items()), flush=True)

    # one np loss/gradient step on the card (K3/K4) vs the CPU (autodiff)
    cfg_s, _ = parse_args(NP_RUN + ["solver.train.batch_size_0T=64", "pde_instance.n_steps=20"])
    key_problem, key_method, key_trainer, _ = rng.split(cfg_s.seed, 4)
    outs, batch = {}, None
    for name in ("cuda", "cpu"):
        d = torch.device(name)
        inst = get_pde_instance(cfg_s)(cfg_s, key_problem, d)
        method = get_method(cfg_s)(inst, cfg_s, key_method, d)
        model, params = method.create_model_fn()
        if batch is None:
            batch = {k: v.cpu() for k, v in method.sample_data(key_trainer).items()}
            params_cpu = {k: v.cpu() for k, v in params.items()}
        before = mlp_grad_quad_bwd.launches
        outs[name] = method._loss_module().value_and_grad_fn(
            functional_forward(model), {k: v.to(d) for k, v in params_cpu.items()},
            {k: v.to(d) for k, v in batch.items()}, inst, **method._fused_kwargs()
        )
        check((mlp_grad_quad_bwd.launches > before) == (name == "cuda"),
              f"np step on {name}: K4 launched {mlp_grad_quad_bwd.launches - before} times")
    rel = max(float(abs(float(outs["cuda"][n]) - float(outs["cpu"][n])) / abs(float(outs["cpu"][n])))
              for n in ("loss", "loss ground truth"))
    g_rel = max(float((outs["cuda"]["grad"][k].cpu() - g).abs().max() / g.abs().max())
                for k, g in outs["cpu"]["grad"].items())
    check(rel <= NP_LOSS_RTOL and g_rel <= NP_GRAD_RTOL,
          f"np card vs CPU step: loss rel {rel:.3e}, grad rel {g_rel:.3e}")
    print(f"[main-path-np-vs-cpu] one np step on a shared batch (640 path points), K3/K4 on the "
          f"card vs autodiff on the CPU: loss/gap rel err {rel:.3e} <= {NP_LOSS_RTOL}, worst "
          f"gradient leaf rel err {g_rel:.3e} <= {NP_GRAD_RTOL}", flush=True)

    # the KMV MLP path (K7/K8 with kmv_pallas=auto), then K5/K6 (kmv_pallas=on)
    pair_launch = lambda: {"K5": pw.mlp_pairwise_sums.launches, "K6": pw.mlp_pairwise_sums_bwd.launches,
                           "K7": pw.mlp_pairwise_sums_packed.launches,
                           "K8": pw.mlp_pairwise_sums_packed_bwd.launches}

    def zero_pair_launches():
        for fn in (pw.mlp_pairwise_sums, pw.mlp_pairwise_sums_bwd, pw.mlp_pairwise_sums_packed,
                   pw.mlp_pairwise_sums_packed_bwd):
            fn.launches = 0

    kmv_launches = {}
    for mode, extra, n_iter in (("auto", [], 20),
                                ("on", [f"train.number_of_iterations={KMV_ON_STEPS}",
                                        f"train.steps_per_chunk={KMV_ON_STEPS // 2}",
                                        f"test.frequency={KMV_ON_STEPS}"], KMV_ON_STEPS)):
        cfg_k, _ = parse_args(KMV_RUN + extra + [f"solver.train.kmv_pallas={mode}"])
        tr, net = cfg_k.solver.train, cfg_k.neural_network
        check((tr.n_time_stamps, tr.sample_per_time) == (KMV_NT, KMV_N)
              and (net.hidden_dim, net.layers, net.feature_dim, net.fourier_features) == (20, 8, 128, 0),
              "KMV MLP configuration width changed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        langevin.launches = mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
        zero_pair_launches()
        result_k = run(cfg_k, "cuda")
        torch.cuda.synchronize()
        launches_k = pair_launch()
        peak_k = torch.cuda.max_memory_allocated()
        check(len(result_k.losses) == n_iter and bool(np.isfinite(result_k.losses).all()),
              f"KMV {mode} losses not finite: {result_k.losses}")
        pair = ("K7", "K8") if mode == "auto" else ("K5", "K6")
        others = [k for k in launches_k if k not in pair]
        check(all(launches_k[k] >= n_iter for k in pair) and all(launches_k[k] == 0 for k in others),
              f"KMV kmv_pallas={mode}: launches {launches_k} in {n_iter} steps")
        metrics_k = {**result_k.test_metrics, **result_k.result_metrics}
        check(len(result_k.result_metrics) == 1 and all(math.isfinite(v) for v in metrics_k.values()),
              f"KMV test metrics not finite: {metrics_k}")
        kmv_launches[mode] = launches_k
        print(f"[main-path-kmv-{mode}] KMV MLP full width ({KMV_NT} stamps x {KMV_N} samples, refs at "
              f"the same stamp: {KMV_NT * KMV_N * KMV_N} pairs per step; PotentialMLP 2->20x8->128 "
              f"tanh), kmv_pallas={mode}: {n_iter} steps, loss {result_k.losses[0]:.4e} -> "
              f"{result_k.losses[-1]:.4e}, {result_k.test_metrics['steps_per_sec']:.3f} steps/s, "
              f"launches {launches_k}, peak memory {peak_k} B ({peak_k / 2**30:.3f} GiB); result "
              + " ".join(f"{k}={v:.4e}" for k, v in result_k.result_metrics.items()), flush=True)

    # parametric KMV (closed form, no kernel)
    cfg_q, _ = parse_args(["preset=KMV", "train.number_of_iterations=20", "train.steps_per_chunk=10",
                           "test.frequency=20", "logging.writer=none"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_pair_launches()
    result_q = run(cfg_q, "cuda")
    torch.cuda.synchronize()
    peak_q = torch.cuda.max_memory_allocated()
    check(len(result_q.losses) == 20 and bool(np.isfinite(result_q.losses).all())
          and result_q.rel_l2 is not None and math.isfinite(result_q.rel_l2),
          f"KMV parametric: losses {result_q.losses}, rel-L2 {result_q.rel_l2}")
    check(sum(pair_launch().values()) == 0, "the closed-form KMV path launched a pairwise kernel")
    print(f"[main-path-kmv-parametric] preset KMV full width (d=2, 1 stamp x 5000 samples, closed "
          f"form): 20 steps, loss {result_q.losses[0]:.4e} -> {result_q.losses[-1]:.4e}, "
          f"{result_q.test_metrics['steps_per_sec']:.3f} steps/s, peak memory {peak_q} B "
          f"({peak_q / 2**30:.3f} GiB); recovered-parameter rel-L2 {result_q.rel_l2:.4e}", flush=True)

    # where one full-width KMV MLP step's time goes, by kmv_pallas mode
    splits_k = {}
    for mode in ("auto", "on", "off"):
        cfg_m, _ = parse_args(KMV_RUN + [f"solver.train.kmv_pallas={mode}"])
        key_problem, key_method, key_trainer, _ = rng.split(cfg_m.seed, 4)
        inst = get_pde_instance(cfg_m)(cfg_m, key_problem, dev)
        method = get_method(cfg_m)(inst, cfg_m, key_method, dev)
        model, params = method.create_model_fn()
        loss_mod, fwd = method._loss_module(), functional_forward(model)
        t_sample, t_loss = [], []
        for s_ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = method.sample_data(rng.fold_in(key_trainer, s_))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = loss_mod.value_and_grad_fn(fwd, params, batch, inst, **method._kmv_kwargs())
            float(out["loss"])
            t2 = time.perf_counter()
            if s_:
                t_sample.append(t1 - t0)
                t_loss.append(t2 - t1)
        splits_k[mode] = (1e3 * float(np.median(t_sample)), 1e3 * float(np.median(t_loss)))
        del out, batch
    print("[step-split-kmv] full-width KMV MLP step, median of 3: " + "; ".join(
        f"kmv_pallas={m}: sampling {a:.3f} ms, loss+gradient {b:.3f} ms"
        for m, (a, b) in splits_k.items()), flush=True)

    # one KMV MLP loss/gradient step on the card (K7/K8) vs the CPU (plain)
    cfg_s, _ = parse_args(KMV_MLP + ["solver.train.sample_per_time=64"])
    key_problem, key_method, key_trainer, _ = rng.split(cfg_s.seed, 4)
    outs, batch = {}, None
    for name in ("cuda", "cpu"):
        d = torch.device(name)
        inst = get_pde_instance(cfg_s)(cfg_s, key_problem, d)
        method = get_method(cfg_s)(inst, cfg_s, key_method, d)
        model, params = method.create_model_fn()
        if batch is None:
            batch = {k: v.cpu() for k, v in method.sample_data(key_trainer).items()}
            params_cpu = {k: v.cpu() for k, v in params.items()}
        before = pw.mlp_pairwise_sums_packed_bwd.launches
        outs[name] = method._loss_module().value_and_grad_fn(
            functional_forward(model), {k: v.to(d) for k, v in params_cpu.items()},
            {k: v.to(d) for k, v in batch.items()}, inst, **method._kmv_kwargs()
        )
        check((pw.mlp_pairwise_sums_packed_bwd.launches > before) == (name == "cuda"),
              f"KMV step on {name}: K8 launched {pw.mlp_pairwise_sums_packed_bwd.launches - before} times")
    rel = max(float(abs(float(outs["cuda"][n]) - float(outs["cpu"][n])) / abs(float(outs["cpu"][n])))
              for n in ("loss", "loss ground truth"))
    g_rel = max(float((outs["cuda"]["grad"][k].cpu() - g).abs().max() / g.abs().max())
                for k, g in outs["cpu"]["grad"].items())
    check(rel <= KMV_LOSS_RTOL and g_rel <= KMV_GRAD_RTOL,
          f"KMV card vs CPU step: loss rel {rel:.3e}, grad rel {g_rel:.3e}")
    print(f"[main-path-kmv-vs-cpu] one KMV MLP step on a shared batch ({KMV_NT} x 64 samples), K7/K8 on "
          f"the card vs the plain formulation on the CPU: loss/gap rel err {rel:.3e} <= {KMV_LOSS_RTOL}, "
          f"worst gradient leaf rel err {g_rel:.3e} <= {KMV_GRAD_RTOL}", flush=True)

    # -- 6. timing ---------------------------------------------------------------------
    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    shapes = {"path": (initial(N_PATH), True), "terminal": (initial(N_TERMINAL), False)}
    times = {}
    for shape, (z, with_traj) in shapes.items():
        kernel = lambda: langevin(5, z, N_STEPS, DT, gmm, GAMMA, return_trajectory=with_traj)
        plain = lambda: langevin_plain(5, z, N_STEPS, DT, gmm, GAMMA, return_trajectory=with_traj)
        p1, k1, k2, p2 = time_ms(plain, 3), time_ms(kernel, 20), time_ms(kernel, 20), time_ms(plain, 3)
        times[shape] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[timing] K1 {shape} batch (GMM d=4, n={z.shape[0]}, 200 steps, "
              f"trajectory={with_traj}): kernel {times[shape][0]:.4f} ms, plain torch "
              f"{times[shape][1]:.4f} ms (runs: plain {p1:.4f}, kernel {k1:.4f}, "
              f"kernel {k2:.4f}, plain {p2:.4f})", flush=True)

    mids, streams, cot = pointwise_inputs(dev, N_POINTS, torch.float32, 7)
    for name, kernel, plain, args in (
        ("K3", mlp_grad_quad, mlp_grad_quad_plain, streams),
        ("K4", mlp_grad_quad_bwd, mlp_grad_quad_bwd_plain, streams + cot),
    ):
        k_fn = lambda: kernel(mids, "tanh", *args)
        p_fn = lambda: plain(mids, "tanh", *args)
        p1, k1, k2, p2 = time_ms(p_fn, 5), time_ms(k_fn, 20), time_ms(k_fn, 20), time_ms(p_fn, 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[timing] {name} full width (n={N_POINTS}, layers 64->64->256, tanh): kernel "
              f"{times[name][0]:.4f} ms, plain torch {times[name][1]:.4f} ms (runs: plain "
              f"{p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f})", flush=True)

    mids, tens, cot = pairwise_inputs(dev, KMV_NT, KMV_N, KMV_N, torch.float32, 10)
    for kid, (kernel, plain) in kernels.items():
        k_fn = lambda: pairwise_call(kid, kernel, "tanh", mids, tens, cot)
        p_fn = lambda: pairwise_call(kid, plain, "tanh", mids, tens, cot)
        p1, k1, k2, p2 = time_ms(p_fn, 2), time_ms(k_fn, 3), time_ms(k_fn, 3), time_ms(p_fn, 2)
        times[kid] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[timing] {kid} full width ({KMV_NT}x{KMV_N}x{KMV_N} pairs, layers 20x8->128, tanh): "
              f"kernel {times[kid][0]:.4f} ms, plain torch {times[kid][1]:.4f} ms (runs: plain "
              f"{p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f})", flush=True)

    check("jax" not in sys.modules, "JAX was imported")
    print(json.dumps({"kernels": [{
        "name": "K1 kinetic Langevin (EM/BAOAB, GMM or Quadratic force)",
        "route": "cuda",
        "source": "pde_inverse_torch/csrc/langevin.cu",
        "replaces": "pde_inverse_tpu/ops/pallas/langevin_kernel.py:110",
        "launches": launches,
        "max_abs_err": max_err,
        # one training step's two launches: path (2500, trajectory) + terminal (75000)
        "ms": times["path"][0] + times["terminal"][0],
        "plain_ms": times["path"][1] + times["terminal"][1],
    }, *({
        "name": name,
        "route": "cuda",
        "source": "pde_inverse_torch/csrc/pointwise.cu",
        "replaces": f"pde_inverse_tpu/ops/pallas/pointwise_kernel.py:{line}",
        "launches": np_launches[kid],
        "max_abs_err": k34_err[kid],
        "ms": times[kid][0],
        "plain_ms": times[kid][1],
    } for kid, name, line in (
        ("K3", "K3 fused pointwise forward (second-order MLP streams, quad and delta)", 67),
        ("K4", "K4 fused pointwise VJP (4-stream forward, reverse sweep, weight gradients)", 186),
    )), *({
        "name": name,
        "route": "cuda",
        "source": "pde_inverse_torch/csrc/pairwise.cu",
        "replaces": replaces,
        # K7/K8 from the kmv_pallas=auto run, K5/K6 from the kmv_pallas=on run
        "launches": kmv_launches["auto" if kid in ("K7", "K8") else "on"][kid],
        "max_abs_err": pair_err[kid],
        "ms": times[kid][0],
        "plain_ms": times[kid][1],
    } for kid, name, replaces in (
        ("K5", "K5 pairwise mean-field sums, |f|^2 head (value, vHv, dPhi/dz0 over refs)",
         "pde_inverse_tpu/ops/pallas/pairwise_kernel.py:136"),
        ("K6", "K6 VJP of K5 (4-stream forward, reverse sweep, weight and ar gradients)",
         "pde_inverse_tpu/ops/pallas/pairwise_kernel.py:340"),
        ("K7", "K7 pairwise sums through the collapsed head g.Mg + u.g",
         "pde_inverse_tpu/ops/pallas/pairwise_packed.py:219"),
        ("K8", "K8 VJP of K7 (mids, M, u, ax, av, ar)",
         "pde_inverse_tpu/ops/pallas/pairwise_packed.py:468"),
    ))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
