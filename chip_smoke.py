#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs a CUDA device and fails (exit
code != 0, no result line) without one; it never falls back to the CPU.
Phases, each printing its own line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles K1/K2 (``pde_inverse_torch/csrc/langevin.cu``), K3/K4
   (``csrc/pointwise.cu``), K5-K8 and S1 (``csrc/pairwise.cu``) and S2/S3
   (``csrc/mma_tf32.cu``) with nvcc, one process per source, together, and
   prints registers, the Langevin kernels that spill and every K3, K4, K5
   (``k5_kernel``), K6 (``k6_kernel``), K7 and K8 instantiation's registers
   and spill;
3. K1 and K2 (pack=2) against their plain PyTorch version on the card, at
   the KGMM main path's shapes (d=4; GMM with k=3 and a Quadratic
   potential; 2,500 particles with a trajectory and 75,000 without; 200
   steps; EM and BAOAB), the antithetic pairing and the exact OU moment
   law; K2 (pack 2, 4, 8) against K1 bit for bit with noise, random phase
   and both antithetic signs, and K2's OU law;
4. K3 and K4 against their plain versions, both held against a float64
   run of the plain version, at the non-parametric main path's shape
   (250,000 path points, layers 64->64->256, tanh), a ragged n, silu and
   softplus, and at the offline preset's shape (320,000 points, layers
   32->32->128) with a ragged n; K3's and K4's outputs bitwise equal on two
   calls; K9 and K10 (the Fourier front end, d 4, F 64, w0 64) held the same
   way at 250,000 points, a ragged n and the loss's strided halves of a
   batch, their outputs bitwise equal on two calls;
   K5-K8 against their plain versions, held the same way, at the KMV main
   path's shape (7 stamps x 2,000 points x 2,000 refs, layers 20 x 8 ->
   128, tanh), a ragged n and m with masked refs, and silu and softplus,
   and K5, K7 and K8 also at width 32 and on a chain 20 -> 32 -> 8 -> 20
   padded to 32; K5 runs ``k5_kernel`` and K6 ``k6_kernel`` at these
   widths; on a chain of hidden width 64 (64 -> 64 -> 128), held the same
   way, K5 runs ``pw_fwd_kernel`` and K6 ``k6_kernel`` on lane octets, and
   ``pw_bwd_kernel`` is held on a chain wider than 64 (72 -> 72 -> 16); K5's,
   K6's (both widths), K7's and K8's outputs bitwise equal on two calls;
5. the main paths: ``pde_inverse_torch.main.run`` on preset KGMM (K1), on
   preset KGMM with langevin_pack=2 (K2), then on preset
   KGMM-nonparametric-online, each at full width with the launch counts set
   to 0 just before and read just after; the split of one step's time
   between sampling and loss/gradient (for the non-parametric path with
   kfp_fused auto, xla and off); one loss/gradient step of each on the card
   against the same step on the CPU.  Then the KMV paths, each read the
   same way: the MLP configuration (the JAX package's ``mlp_pairwise``
   bench row) with kmv_pallas=auto (K7/K8), a shorter run with
   kmv_pallas=on (K5/K6 through k5_kernel and k6_kernel), two steps of the
   same configuration at hidden width 64 with kmv_pallas=auto (K5 through
   pw_fwd_kernel, K6 through k6_kernel on lane octets), at 64 x 2 -> 128 and
   64 x 3 -> 128, preset KMV (parametric, closed form); the KMV
   step's split by kmv_pallas mode; one np KMV step on the card against the
   CPU.  Then the offline paths: preset KGMM-offline with langevin_pack 0
   (K1) and 2 (K2), dataset generation included; preset
   KGMM-nonparametric (K3/K4); preset KGMM-nonparametric-offline-XL, its
   200,000 x 400 store generated into a fresh directory under ``.scratch/``
   and removed afterwards, then streamed steps; the offline step's split;
   one offline step on the card against the CPU;
6. the diagnostics S1-S3 (``pde_inverse_torch/scripts/``), each with its
   counts read the same way;
7. timing of every kernel against its plain version with CUDA events, K2
   against K1 at the offline shapes, K3 and K4 also at the XL and offline
   steps' shapes, K9 and K10 beside the same front end as PyTorch operations
   at 1,000,000 points, K5 and K6 also at the hidden-64 chain, S1-S3 beside one PyTorch
   call that computes the same function (also by their device time,
   ``torch.profiler``), and
   ``sum_rows``, the fixed-order row sum that finishes K7's and K8's partial
   rows (S2's sum mode), at the KMV MLP's full-width partial shapes, bit for
   bit against its plain version.

The line before the last is a JSON object describing each kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# the other presets that run K3/K4: KGMM-nonparametric (320,000 path points a
# step, layers 32 -> 32 -> 128) and KGMM-nonparametric-offline-XL (655,360
# points a step at the full width)
N_POINTS_OFFLINE, WIDTHS_OFFLINE = 320_000, (32, 32, 128)
N_POINTS_XL = 655_360
# the Fourier front end (d, F, w0) of the online and XL presets, and the
# path points of the online preset at 10,000 trajectories (the benchmark's
# kgmm-np-online.paths1m), where K9 and K10 are timed
FRONT = (4, 64, 64)
N_PATHS_1M = 1_000_000
K4_PRODUCTS = 10  # layer products a point in K4: 4 forward, 3 weight-gradient, 3 input-cotangent
# the KMV MLP configuration: 7 stamps x 2,000 samples (refs = the samples at
# the same stamp), PotentialMLP 2 -> 20 x 8 -> 128, tanh
KMV_NT, KMV_N, KMV_WIDTHS = 7, 2_000, (20,) * 8 + (128,)
KMV_MLP = ["preset=KMV-nonparametric-fourier", "neural_network.model=mlp",
           "neural_network.fourier_features=0", "neural_network.fourier_trainable=False",
           "solver.train.kmv_field_reg=0.0", "train.optimizer.weight_decay=1e-1",
           "logging.writer=none"]
KMV_RUN = KMV_MLP + ["train.number_of_iterations=20", "train.steps_per_chunk=10", "test.frequency=20"]
KMV_ON_STEPS = 4
# K5 and K6 where a width before the feature layer exceeds 32 (K5's
# pw_fwd_kernel, K6's k6_kernel on lane octets): the KMV MLP at hidden width
# 64 with neural_network.layers=2 (64 x 2 -> 128, the chain of K6_WIDE) and
# with layers=3 (64 x 3 -> 128, the chain of K6_WIDE3, which pw_bwd_kernel's
# 32-point tile cannot hold); pw_bwd_kernel itself at a chain wider than 64,
# which k6_kernel does not take
K6_WIDE = (64, 64, 128)
K6_WIDE3 = (64, 64, 64, 128)
K6_WIDER = (72, 72, 16)
KMV_WIDE = ["neural_network.hidden_dim=64", "neural_network.layers=2", "train.number_of_iterations=2",
            "train.steps_per_chunk=1", "test.frequency=2", "solver.train.kmv_pallas=auto"]
KMV_WIDE3 = [o if o != "neural_network.layers=2" else "neural_network.layers=3" for o in KMV_WIDE]
NP_RUN = ["preset=KGMM-nonparametric-online", "train.number_of_iterations=20",
          "train.steps_per_chunk=10", "test.frequency=20", "logging.writer=none",
          "train.optimizer.ema_switch_step=10"]
# the offline paths: 10 steps in chunks of 5, tested at the end
OFFLINE_STEPS = ["train.number_of_iterations=10", "train.steps_per_chunk=5", "test.frequency=10",
                 "logging.writer=none"]
# one offline step on the card vs the CPU on one shared dataset and subsample:
# f32 sums over 3,000 + 2,000 + 40 x 10 points in another order
OFFLINE_SMALL = ["preset=KGMM-offline", "pde_instance.sample_initial_size=3000",
                 "pde_instance.sample_terminal_size=2000", "pde_instance.sample_0T_size=200",
                 "pde_instance.n_steps_0T=50", "pde_instance.n_steps_terminal=50"]

# The card's peaks for bound_ms (NVIDIA's data sheet, H100 SXM, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12


def bound(n_bytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the least time for the work, the larger of its
    bytes over the memory rate and its operations over the peak rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def langevin_work(n: int, n_steps: int, d: int, k: int, with_traj: bool):
    """(bytes, FP32 operations) of one K1/K2 launch, GMM force with k
    components, Euler: z0 read and final state, phases and trajectory
    written once; per particle and step, counted from csrc/langevin.cu
    (an FMA is 2 operations, a transcendental 1, Philox's integer work
    none): Box-Muller normals 6 a coordinate, the force's two passes
    k (8 d + 5) + d + 1, the update 10 d + 3, over n_steps + 1 steps."""
    n_bytes = 4 * n * (2 * d + 2 * d + 1 + (n_steps * 2 * d if with_traj else 0))
    per_step = 6 * d + k * (8 * d + 5) + d + 1 + 10 * d + 3
    return n_bytes, float(n) * (n_steps + 1) * per_step


def mlp_products(widths) -> int:
    """Multiply-adds of one stream through the layers of `widths`."""
    return sum(a * b for a, b in zip(widths, widths[1:]))


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


def resources(lib_path) -> dict:
    """{kernel: (registers, spill store bytes)} of every kernel, from the
    compiler's -Xptxas=-v report."""
    out, name, spill = {}, None, 0
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
    return out


def spills(lib_path) -> dict:
    """resources() of the kernels that spill."""
    return {k: v for k, v in resources(lib_path).items() if v[1]}


def k7_name(mangled: str, kernel: str = "k7_kernel"):
    """'k7_kernel<W, ACT>' (or k8_kernel's) as 'W=20 tanh', or None for
    another kernel."""
    m = re.search(kernel + r"ILi(\d+)ELi(\d)E", mangled)
    return None if m is None else f"W={m.group(1)} {('tanh', 'silu', 'softplus')[int(m.group(2))]}"


def langevin_name(mangled: str) -> str:
    """'langevin_kernel<D, POT, INTEG, PACK>' as 'd=4 GMM euler pack=8'."""
    m = re.search(r"langevin_kernelILi(\d)ELi(\d)ELi(\d)ELi(\d)E", mangled)
    if m is None:
        return mangled
    d, pot, integ, pack = m.groups()
    return (f"d={d} {'GMM' if pot == '1' else 'Quadratic'} {'baoab' if integ == '1' else 'euler'} "
            f"pack={pack}")


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


def front_inputs(dev, n, dtype, seed, batch):
    """(x, v, B, W0, b0) of the front end FRONT and the cotangents of K9's
    five outputs, from a seed (the same numbers in float32 and float64);
    x ~ N(0, 4 I) and v ~ N(0, 0.1 I) as the KGMM path's, so |p| reaches
    tens.  With `batch`, x and v are the halves of one [n, 2d] batch."""
    d, nf, w0 = FRONT
    gen = torch.Generator().manual_seed(seed)
    xv = torch.randn((n, 2 * d), generator=gen) * torch.tensor([2.0] * d + [math.sqrt(0.1)] * d)
    B = torch.randn((d, nf), generator=gen)
    W0 = torch.randn((d + 2 * nf, w0), generator=gen) / (d + 2 * nf) ** 0.5
    b0 = torch.randn(w0, generator=gen) * 0.1
    bars = [torch.randn((n, w), generator=gen) for w in (w0, w0, w0, nf, nf)]
    to = lambda t: t.to(dev, dtype)
    xv = to(xv)
    x, v = (xv[:, :d], xv[:, d:]) if batch else (xv[:, :d].contiguous(), xv[:, d:].contiguous())
    return (x, v, to(B), to(W0), to(b0)), [to(t) for t in bars]


def pairwise_inputs(dev, nt, n, m, dtype, seed, zero_refs=(), widths=KMV_WIDTHS):
    """Layers after the first, ax, av, ar, mask and the cotangents of the
    pairwise kernels, from a seed (the same numbers in float32 and float64)."""
    gen = torch.Generator().manual_seed(seed)
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
    from pde_inverse_torch.ops.cuda import pointwise as pt
    from pde_inverse_torch.ops.cuda.pointwise import (
        front_streams, front_streams_bwd, front_streams_bwd_plain, front_streams_plain,
        mlp_grad_quad, mlp_grad_quad_bwd, mlp_grad_quad_bwd_plain, mlp_grad_quad_plain,
    )
    from pde_inverse_torch.ops.cuda import mma_tf32
    from pde_inverse_torch.ops.cuda import pairwise as pw
    from pde_inverse_torch.ops.simulate import simulate
    from pde_inverse_torch.scripts import diag_packed_onchip as s1
    from pde_inverse_torch.scripts import microtest_blkdiag_dot as s3
    from pde_inverse_torch.scripts import microtest_sublane_reduce as s2
    from pde_inverse_torch.scripts import time_diag
    from pde_inverse_torch.potentials import GMMPotential, QuadraticPotential
    from pde_inverse_torch.registry import get_method, get_pde_instance

    dev = torch.device("cuda")
    setup_precision()
    here = os.path.dirname(os.path.abspath(__file__))

    def zero_langevin():
        langevin.launches = 0
        langevin.launches_by_pack = dict.fromkeys(langevin.launches_by_pack, 0)

    # -- 1. device -------------------------------------------------------------
    print(nvidia_smi())
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_k1, lib_pw, lib_pair, lib_mma = build.build_all(["langevin", "pointwise", "pairwise", "mma_tf32"])
    build_s = time.perf_counter() - t0
    for what, lib_path in (("K1/K2", lib_k1), ("K3/K4", lib_pw), ("K5-K8, S1", lib_pair),
                           ("S2/S3", lib_mma)):
        regs = registers(lib_path)
        own_s = lib_path.with_suffix(".log").read_text().splitlines()[1]
        print(f"[build] {what} {lib_path.name} ({own_s.strip('# ')}; all sources together in "
              f"{build_s:.1f} s): {len(regs)} kernels, {min(regs)}..{max(regs)} registers per "
              f"thread", flush=True)
    spilled = spills(lib_k1)
    print(f"[build] Langevin kernels that spill ({len(spilled)} of {len(registers(lib_k1))}: registers, "
          f"spill-store bytes): " + ("; ".join(f"{langevin_name(k)}: {r}, {b}" for k, (r, b) in
                                               sorted(spilled.items(), key=lambda kv: langevin_name(kv[0])))
                                     or "none"), flush=True)
    other = {lib.name: len(spills(lib)) for lib in (lib_pw, lib_pair, lib_mma)}
    print(f"[build] kernels that spill in the other sources: {other}", flush=True)
    for kid, kernel in (("K3", "k3_kernel"), ("K4", "k4_kernel")):
        res = {("tanh", "silu", "softplus")[int(m.group(1))]: v for k, v in resources(lib_pw).items()
               if (m := re.search(kernel + r"ILi(\d)E", k))}
        check(len(res) == 3, f"{kid} instantiations in the build report: {sorted(res)}")
        print(f"[build] {kid} instantiations (registers, spill-store bytes): "
              + "; ".join(f"{k}: {r}, {b}" for k, (r, b) in sorted(res.items())), flush=True)
    for kid, kernel in (("K9", "k9_kernel"), ("K10", "k10_kernel")):
        res = {k: v for k, v in resources(lib_pw).items() if kernel in k}
        check(len(res) == len(pt.FRONT_SHAPES), f"{kid} instantiations in the build report: {sorted(res)}")
        print(f"[build] {kid} instantiations (registers, spill-store bytes): "
              + "; ".join(f"{k}: {r}, {b}" for k, (r, b) in sorted(res.items())), flush=True)
    for kid, kernel in (("K5", "k5_kernel"), ("K6", "k6_kernel"), ("K7", "k7_kernel"), ("K8", "k8_kernel")):
        res = {k7_name(k, kernel): v for k, v in resources(lib_pair).items() if k7_name(k, kernel)}
        want = 3 * len(pw.K6_WIDTHS if kid == "K6" else pw.K7_WIDTHS)  # K6 also at 48 and 64
        check(len(res) == want, f"{kid} instantiations in the build report: {sorted(res)}")
        print(f"[build] {kid} instantiations (registers, spill-store bytes): " + "; ".join(
            f"{k}: {r}, {b}" for k, (r, b) in sorted(res.items(), key=lambda kv: (int(kv[0][2:4]), kv[0]))),
            flush=True)

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

    max_err = {1: 0.0, 2: 0.0}  # by pack: K1, K2
    rows = {1: [], 2: []}
    for pot_name, pot in (("gmm", gmm), ("quadratic", quad)):
        for integ in ("euler", "baoab"):
            for n, with_traj in ((N_PATH, True), (N_TERMINAL, False)):
                z0 = initial(n)
                kw = dict(return_trajectory=with_traj, random_phase=False,
                          noise_scale=0.0, integrator=integ)
                want = langevin_plain(3, z0, N_STEPS, DT, pot, GAMMA, **kw)
                ref = langevin_plain(3, z0.double(), N_STEPS, DT, as_f64[pot_name], GAMMA, **kw)
                for pack in (1, 2):
                    got = langevin(3, z0, N_STEPS, DT, pot, GAMMA, pack=pack, **kw)
                    torch.cuda.synchronize()
                    err, err_k, err_p = max_diff(got, want), max_diff(got, ref), max_diff(want, ref)
                    gate = NOISELESS_FACTOR * err_p + NOISELESS_ATOL
                    check(math.isfinite(err) and err_k <= gate,
                          f"noiseless pack={pack} {pot_name}/{integ}/n={n}: kernel vs f64 {err_k:.3e} > "
                          f"{NOISELESS_FACTOR} x plain-f32 vs f64 {err_p:.3e} + {NOISELESS_ATOL}")
                    max_err[pack] = max(max_err[pack], err)
                    rows[pack].append(f"{pot_name}/{integ}/{n}: {err:.2e} ({err_k:.2e} vs {err_p:.2e})")
    for pack, kid in ((1, "k1"), (2, "k2")):
        print(f"[{kid}-vs-plain] pack={pack}, noiseless, 200 steps, max abs err kernel vs plain (kernel "
              f"vs f64, plain f32 vs f64): {'; '.join(rows[pack])}; gate kernel-vs-f64 <= "
              f"{NOISELESS_FACTOR} x plain-vs-f64 + {NOISELESS_ATOL}: pass", flush=True)

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
    z0_law = torch.randn((N_TERMINAL, 2 * D), generator=gen).to(dev)
    ou_errs = []
    for integ in ("euler", "baoab"):
        final, _, _ = langevin(7, z0_law, N_STEPS, DT, quad, GAMMA, integrator=integ)
        f = final.double().cpu().numpy()
        e_mean = float(np.abs(f.mean(0) - mean_ex).max())
        e_cov = float(np.abs(np.cov(f.T) - cov_ex).max())
        check(e_mean <= OU_MEAN_ATOL and e_cov <= OU_COV_ATOL,
              f"OU law {integ}: mean err {e_mean:.3e}, cov err {e_cov:.3e}")
        ou_errs.append(f"{integ} mean {e_mean:.3e} cov {e_cov:.3e}")
    print(f"[k1-ou-law] Quadratic d=4, 75000 particles, T=2: {'; '.join(ou_errs)} "
          f"(<= {OU_MEAN_ATOL} / {OU_COV_ATOL})", flush=True)

    # K2 against K1: the same Philox counters, so the same numbers bit for bit
    k2_worst, k2_cases = 0.0, 0
    for pack in (2, 4, 8):
        for integ in ("euler", "baoab"):
            for n, with_traj in ((N_PATH, True), (N_TERMINAL, False), (37, True), (700, True)):
                z0 = initial(n)
                for sign in (1.0, -1.0):
                    kw = dict(return_trajectory=with_traj, noise_scale=sign, integrator=integ)
                    a = langevin(23, z0, N_STEPS, DT, gmm, GAMMA, pack=1, **kw)
                    b = langevin(23, z0, N_STEPS, DT, gmm, GAMMA, pack=pack, **kw)
                    k2_worst = max(k2_worst, max_diff(a, b))
                    k2_cases += 1
    # bitwise, or else held to K1's gate against float64 above ([k2-vs-plain])
    print(f"[k2-vs-k1] pack 2/4/8, GMM d=4, 200 steps, noise, random phase, noise_scale +1 and -1, "
          f"euler and baoab, n = 2500 (trajectory), 75000, 37, 700: {k2_cases} cases, largest "
          f"difference from K1 {k2_worst:.3e} ({'bitwise equal' if k2_worst == 0.0 else 'NOT bitwise; K2 held to K1 gate vs f64 instead'})",
          flush=True)
    k2_ou = []
    for pack in (2, 8):
        for integ in ("euler", "baoab"):
            final, _, _ = langevin(7, z0_law, N_STEPS, DT, quad, GAMMA, integrator=integ, pack=pack)
            f = final.double().cpu().numpy()
            e_mean = float(np.abs(f.mean(0) - mean_ex).max())
            e_cov = float(np.abs(np.cov(f.T) - cov_ex).max())
            check(e_mean <= OU_MEAN_ATOL and e_cov <= OU_COV_ATOL,
                  f"K2 OU law pack={pack} {integ}: mean err {e_mean:.3e}, cov err {e_cov:.3e}")
            k2_ou.append(f"pack={pack} {integ} mean {e_mean:.3e} cov {e_cov:.3e}")
    print(f"[k2-ou-law] Quadratic d=4, 75000 particles, T=2: {'; '.join(k2_ou)} "
          f"(<= {OU_MEAN_ATOL} / {OU_COV_ATOL})", flush=True)

    # -- 4. K3/K4 against their plain versions ----------------------------------------
    k34_err = {"K3": 0.0, "K4": 0.0}
    for name, kernel, plain in (("K3", mlp_grad_quad, mlp_grad_quad_plain),
                                ("K4", mlp_grad_quad_bwd, mlp_grad_quad_bwd_plain)):
        rows = []
        for act, n, widths in (("tanh", N_POINTS, WIDTHS), ("tanh", 4_099, WIDTHS),
                               ("silu", 20_000, WIDTHS), ("softplus", 20_000, WIDTHS),
                               ("tanh", N_POINTS_OFFLINE, WIDTHS_OFFLINE),
                               ("tanh", 20_011, WIDTHS_OFFLINE)):
            mids, streams, cot = pointwise_inputs(dev, n, torch.float32, 5, widths)
            mids64, streams64, cot64 = pointwise_inputs(dev, n, torch.float64, 5, widths)
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
            rows.append(f"{act}/{n}{'' if widths == WIDTHS else '/layers ' + '->'.join(map(str, widths))}: "
                        f"{worst_k:.2e} vs {worst_p:.2e}")
            del got, want, ref
        print(f"[{name.lower()}-vs-plain] layers 64->64->256, worst output error relative to its "
              f"max-abs, kernel vs f64 / plain f32 vs f64: {'; '.join(rows)}; gate <= "
              f"{F64_FACTOR} x plain + {F64_FLOOR}: pass; max abs err kernel vs plain "
              f"{k34_err[name]:.3e}", flush=True)
    mids, streams, cot = pointwise_inputs(dev, N_POINTS, torch.float32, 6)
    a = flat(mlp_grad_quad(mids, "tanh", *streams))
    b = flat(mlp_grad_quad(mids, "tanh", *streams))
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "K3 outputs differ between two calls")
    print(f"[k3-repeat] n={N_POINTS}: two calls bitwise equal in both outputs (quad, delta)", flush=True)
    a = flat(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot))
    b = flat(mlp_grad_quad_bwd(mids, "tanh", *streams, *cot))
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "K4 outputs differ between two calls")
    print(f"[k4-repeat] n={N_POINTS}: two calls bitwise equal in all {len(a)} outputs", flush=True)
    del a, b

    # K9/K10 against their plain versions, held to float64 as K3/K4 are
    k910_err = {"K9": 0.0, "K10": 0.0}
    rows = []
    for n, batch in ((N_POINTS, True), (4_099, False), (20_011, True)):
        args, bars = front_inputs(dev, n, torch.float32, 8, batch)
        args64, bars64 = front_inputs(dev, n, torch.float64, 8, False)
        for name, kernel, plain, a, a64 in (
                ("K9", front_streams, front_streams_plain, args, args64),
                ("K10", front_streams_bwd, front_streams_bwd_plain, (*args[:4], *bars), (*args64[:4], *bars64))):
            got, want, ref = kernel(*a), plain(*a), plain(*a64)
            torch.cuda.synchronize()
            worst_k, worst_p = 0.0, 0.0
            for k_, p_, r_ in zip(got, want, ref):
                scale = float(r_.abs().max())
                err_k = float((k_.double() - r_).abs().max()) / scale
                err_p = float((p_.double() - r_).abs().max()) / scale
                check(bool(torch.isfinite(k_).all()) and err_k <= F64_FACTOR * err_p + F64_FLOOR,
                      f"{name} n={n} output {tuple(k_.shape)}: kernel vs f64 {err_k:.3e} > "
                      f"{F64_FACTOR} x plain-f32 vs f64 {err_p:.3e} + {F64_FLOOR}")
                worst_k, worst_p = max(worst_k, err_k), max(worst_p, err_p)
                k910_err[name] = max(k910_err[name], float((k_ - p_).abs().max()))
            rows.append(f"{name} n={n}{' (strided x, v)' if batch else ''}: {worst_k:.2e} vs {worst_p:.2e}")
            del got, want, ref
    print(f"[k9-k10-vs-plain] front end d 4, F 64, w0 64, worst output error relative to its max-abs, "
          f"kernel vs f64 / plain f32 vs f64: {'; '.join(rows)}; gate <= {F64_FACTOR} x plain + "
          f"{F64_FLOOR}: pass; max abs err kernel vs plain K9 {k910_err['K9']:.3e}, K10 "
          f"{k910_err['K10']:.3e}", flush=True)
    args, bars = front_inputs(dev, N_POINTS, torch.float32, 9, True)
    for name, fn, a in (("K9", front_streams, args), ("K10", front_streams_bwd, (*args[:4], *bars))):
        first, again = fn(*a), fn(*a)
        check(all(torch.equal(x, y) for x, y in zip(first, again)), f"{name} outputs differ between two calls")
        print(f"[{name.lower()}-repeat] n={N_POINTS}: two calls bitwise equal in all {len(first)} outputs",
              flush=True)
    del args, bars, first, again

    kernels = {"K5": (pw.mlp_pairwise_sums, pw.mlp_pairwise_sums_plain),
               "K6": (pw.mlp_pairwise_sums_bwd, pw.mlp_pairwise_sums_bwd_plain),
               "K7": (pw.mlp_pairwise_sums_packed, pw.mlp_pairwise_sums_packed_plain),
               "K8": (pw.mlp_pairwise_sums_packed_bwd, pw.mlp_pairwise_sums_packed_bwd_plain)}
    pair_cases = (("tanh", KMV_NT, KMV_N, KMV_N, (), KMV_WIDTHS),
                  ("tanh", KMV_NT, 1_999, 1_013, (0, 7, 500, 1_012), KMV_WIDTHS),
                  ("silu", 2, 300, 257, (3,), KMV_WIDTHS), ("softplus", 2, 300, 257, (3,), KMV_WIDTHS))
    # K5, K7 and K8 also at their widest instantiation and on an unequal chain padded to it
    k7_cases = (("tanh", 2, 300, 257, (3,), (32,) * 8 + (128,)),
                ("silu", 2, 300, 257, (3,), (20, 32, 8, 20, 128)))
    pair_err = {kid: 0.0 for kid in kernels}
    for kid, (kernel, plain) in kernels.items():
        rows = []
        for act, nt_, n_, m_, zeros, widths in pair_cases + (k7_cases if kid in ("K5", "K7", "K8") else ()):
            mids, tens, cot = pairwise_inputs(dev, nt_, n_, m_, torch.float32, 8, zeros, widths)
            mids64, tens64, cot64 = pairwise_inputs(dev, nt_, n_, m_, torch.float64, 8, zeros, widths)
            before = pw.mlp_pairwise_sums.launches
            got = flat(pairwise_call(kid, kernel, act, mids, tens, cot))
            check(kid != "K5" or (pw.choose(widths, "on")[0] == "k5" and pw.mlp_pairwise_sums.launches == before + 1),
                  f"K5 {act} {nt_}x{n_}x{m_} did not run k5_kernel")
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
            rows.append(f"{act}/{nt_}x{n_}x{m_}{'/masked' if zeros else ''}"
                        f"{'' if widths == KMV_WIDTHS else '/widths ' + '->'.join(map(str, widths))}: "
                        f"{worst_k:.2e} vs {worst_p:.2e}")
            del got, want, ref
        print(f"[{kid.lower()}-vs-plain] layers 20x8->128, worst output error relative to its max-abs, "
              f"kernel vs f64 / plain f32 vs f64: {'; '.join(rows)}; gate <= {F64_FACTOR} x plain + "
              f"{F64_FLOOR}: pass; max abs err kernel vs plain {pair_err[kid]:.3e}", flush=True)
    for kid in ("K5", "K6", "K7", "K8"):
        mids, tens, cot = pairwise_inputs(dev, KMV_NT, KMV_N, KMV_N, torch.float32, 9)
        a = flat(pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot))
        b = flat(pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot))
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{kid} outputs differ between two calls")
        print(f"[{kid.lower()}-repeat] {KMV_NT}x{KMV_N}x{KMV_N}: two calls bitwise equal in all "
              f"{len(a)} outputs", flush=True)
        del a, b
    # the hidden-64 chains of [main-path-kmv-wide] and [main-path-kmv-wide3]:
    # K5 through pw_fwd_kernel and K6 through k6_kernel on lane octets, held
    # the same way at the paths' own 7 x 2,000 x 2,000 and at two small
    # ragged, masked shapes, and repeated bitwise at the full shape;
    # pw_bwd_kernel, which keeps the chains k6_kernel does not take, at a
    # chain wider than 64 (small shapes only: no path of the port runs it)
    rows = {"K5": [], "K6": [], "pw_bwd": []}
    wide_err = {"K5": 0.0, "K6": 0.0, "pw_bwd": 0.0}
    counts = lambda: (pw.mlp_pairwise_sums.launches, pw.mlp_pairwise_sums_bwd.launches)
    # (kid, which, widths, the launch count that moves, what runs)
    for kid, which, widths, moved, what in (("K5", "K5", K6_WIDE, 0, "pw_fwd_kernel"),
                                            ("K5", "K5", K6_WIDE3, 0, "pw_fwd_kernel"),
                                            ("K6", "K6", K6_WIDE, 1, "k6_kernel"),
                                            ("K6", "K6", K6_WIDE3, 1, "k6_kernel"),
                                            ("K6", "pw_bwd", K6_WIDER, 1, "pw_bwd_kernel")):
        kernel, plain = kernels[kid]
        shapes = (("tanh", 2, 300, 257, (3,)), ("silu", 1, 77, 45, (0, 44)))
        if which != "pw_bwd":
            shapes = (("tanh", KMV_NT, KMV_N, KMV_N, ()),) + shapes
        for act, nt_, n_, m_, zeros in shapes:
            mids, tens, cot = pairwise_inputs(dev, nt_, n_, m_, torch.float32, 8, zeros, widths)
            mids64, tens64, cot64 = pairwise_inputs(dev, nt_, n_, m_, torch.float64, 8, zeros, widths)
            before = counts()
            got = flat(pairwise_call(kid, kernel, act, mids, tens, cot))
            check(pw.choose(widths, "on")[moved] + "_kernel" == what
                  and counts() == tuple(c + (i == moved) for i, c in enumerate(before)),
                  f"{kid} at layers {widths} did not run {what} alone: launches {before} -> {counts()}")
            want = flat(pairwise_call(kid, plain, act, mids, tens, cot))
            ref = flat(pairwise_call(kid, plain, act, mids64, tens64, cot64))
            worst_k, worst_p = 0.0, 0.0
            for k_, p_, r_ in zip(got, want, ref):
                scale = float(r_.abs().max())
                err_k = float((k_.double() - r_).abs().max()) / scale
                err_p = float((p_.double() - r_).abs().max()) / scale
                check(bool(torch.isfinite(k_).all()) and err_k <= F64_FACTOR * err_p + F64_FLOOR,
                      f"{what} {act} {nt_}x{n_}x{m_} output {tuple(k_.shape)}: kernel vs f64 {err_k:.3e} > "
                      f"{F64_FACTOR} x plain-f32 vs f64 {err_p:.3e} + {F64_FLOOR}")
                worst_k, worst_p = max(worst_k, err_k), max(worst_p, err_p)
                wide_err[which] = max(wide_err[which], float((k_ - p_).abs().max()))
            rows[which].append(f"{'->'.join(map(str, widths))}/{act}/{nt_}x{n_}x{m_}"
                               f"{'/masked' if zeros else ''}: {worst_k:.2e} vs {worst_p:.2e}")
            del got, want, ref
    for widths in (K6_WIDE, K6_WIDE3):
        mids, tens, cot = pairwise_inputs(dev, KMV_NT, KMV_N, KMV_N, torch.float32, 9, (), widths)
        for kid, name in (("K5", "pw_fwd_kernel"), ("K6", "k6_kernel")):
            a = flat(pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot))
            b = flat(pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot))
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{kid} ({name}) at layers {widths} outputs differ between two calls")
            del a, b
    layers = ' and '.join('->'.join(map(str, w)) for w in (K6_WIDE, K6_WIDE3))
    gate = f"gate <= {F64_FACTOR} x plain + {F64_FLOOR}: pass"
    print(f"[k5-wide-vs-plain] layers {layers} through pw_fwd_kernel, worst output error relative to its "
          f"max-abs, kernel vs f64 / plain f32 vs f64: {'; '.join(rows['K5'])}; {gate}; max abs err kernel vs "
          f"plain {wide_err['K5']:.3e}; {KMV_NT}x{KMV_N}x{KMV_N}: two calls bitwise equal at each", flush=True)
    print(f"[k6-wide-vs-plain] layers {layers} through k6_kernel (W=64, eight lanes a pair), worst output error "
          f"relative to its max-abs, kernel vs f64 / plain f32 vs f64: {'; '.join(rows['K6'])}; {gate}; max abs "
          f"err kernel vs plain {wide_err['K6']:.3e}; {KMV_NT}x{KMV_N}x{KMV_N}: two calls bitwise equal at each; "
          f"the kernel as choose gives it", flush=True)
    print(f"[pw-bwd-vs-plain] layers {'->'.join(map(str, K6_WIDER))} through pw_bwd_kernel (as choose gives it), "
          f"worst output error relative to its max-abs, kernel vs f64 / plain f32 vs f64: "
          f"{'; '.join(rows['pw_bwd'])}; {gate}; max abs err kernel vs plain {wide_err['pw_bwd']:.3e}", flush=True)

    # -- 5. main paths ---------------------------------------------------------------
    cfg, _ = parse_args(["preset=KGMM", "train.number_of_iterations=20",
                         "train.steps_per_chunk=10", "test.frequency=20", "logging.writer=none"])
    check(cfg.pde_instance.domain_dim == D and cfg.solver.train.batch_size_0T == N_PATH
          and cfg.pde_instance.n_steps == N_STEPS, "KGMM preset width changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_langevin()
    mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
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

    # the same path with two particles per thread: K2 twice a step
    cfg_k2, _ = parse_args(["preset=KGMM", "pde_instance.langevin_pack=2", "train.number_of_iterations=10",
                            "train.steps_per_chunk=5", "test.frequency=10", "logging.writer=none"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_langevin()
    result_k2 = run(cfg_k2, "cuda")
    torch.cuda.synchronize()
    k2_launches = dict(langevin.launches_by_pack)
    n_iter = cfg_k2.train.number_of_iterations
    check(len(result_k2.losses) == n_iter and bool(np.isfinite(result_k2.losses).all())
          and result_k2.rel_l2 is not None and math.isfinite(result_k2.rel_l2),
          f"KGMM pack=2: losses {result_k2.losses}, rel-L2 {result_k2.rel_l2}")
    check(k2_launches[2] >= 2 * n_iter and k2_launches[1] == 0,
          f"KGMM pack=2: launches by pack {k2_launches} in {n_iter} steps")
    print(f"[main-path-k2] KGMM full width with pde_instance.langevin_pack=2: {n_iter} steps, loss "
          f"{result_k2.losses[0]:.4e} -> {result_k2.losses[-1]:.4e}, "
          f"{result_k2.test_metrics['steps_per_sec']:.3f} steps/s, launches by pack {k2_launches}, "
          f"peak memory {torch.cuda.max_memory_allocated()} B; rel-L2 {result_k2.rel_l2:.4e}", flush=True)

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
    zero_langevin()
    mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
    front_streams.launches = front_streams_bwd.launches = 0
    result_np = run(cfg_np, "cuda")
    torch.cuda.synchronize()
    np_launches = {"K1": langevin.launches, "K3": mlp_grad_quad.launches,
                   "K4": mlp_grad_quad_bwd.launches, "K9": front_streams.launches,
                   "K10": front_streams_bwd.launches}
    peak_np = torch.cuda.max_memory_allocated()
    n_iter = cfg_np.train.number_of_iterations
    check(len(result_np.losses) == n_iter and bool(np.isfinite(result_np.losses).all()),
          f"np losses not finite: {result_np.losses}")
    check(np_launches["K1"] >= 2 * n_iter and np_launches["K3"] >= n_iter
          and np_launches["K4"] >= n_iter, f"np launches {np_launches} in {n_iter} steps")
    check(np_launches["K9"] >= n_iter and np_launches["K10"] >= n_iter,
          f"np front-end launches {np_launches} in {n_iter} steps")
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
                   pw.mlp_pairwise_sums_packed_bwd, pw.sum_rows):
            fn.launches = 0

    kmv_launches, sum_rows_launches = {}, {}
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
        zero_langevin()
        mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
        zero_pair_launches()
        result_k = run(cfg_k, "cuda")
        torch.cuda.synchronize()
        launches_k = pair_launch()
        sum_rows_launches[mode] = pw.sum_rows.launches  # S2's sum mode: 4 a step (K5 + K6, K7 + K8)
        peak_k = torch.cuda.max_memory_allocated()
        check(len(result_k.losses) == n_iter and bool(np.isfinite(result_k.losses).all()),
              f"KMV {mode} losses not finite: {result_k.losses}")
        pair = ("K7", "K8") if mode == "auto" else ("K5", "K6")
        others = [k for k in launches_k if k not in pair]
        check(pw.choose(KMV_WIDTHS, mode) == (("k7", "k8") if mode == "auto" else ("k5", "k6"))
              and all(launches_k[k] >= n_iter for k in pair) and all(launches_k[k] == 0 for k in others)
              and sum_rows_launches[mode] >= 4 * n_iter,
              f"KMV kmv_pallas={mode}: launches {launches_k}, sum_rows {sum_rows_launches[mode]} in "
              f"{n_iter} steps")
        metrics_k = {**result_k.test_metrics, **result_k.result_metrics}
        check(len(result_k.result_metrics) == 1 and all(math.isfinite(v) for v in metrics_k.values()),
              f"KMV test metrics not finite: {metrics_k}")
        kmv_launches[mode] = launches_k
        print(f"[main-path-kmv-{mode}] KMV MLP full width ({KMV_NT} stamps x {KMV_N} samples, refs at "
              f"the same stamp: {KMV_NT * KMV_N * KMV_N} pairs per step; PotentialMLP 2->20x8->128 "
              f"tanh), kmv_pallas={mode}: {n_iter} steps, loss {result_k.losses[0]:.4e} -> "
              f"{result_k.losses[-1]:.4e}, {result_k.test_metrics['steps_per_sec']:.3f} steps/s, "
              f"launches {launches_k}, sum_rows {sum_rows_launches[mode]}, peak memory {peak_k} B "
              f"({peak_k / 2**30:.3f} GiB); result "
              + " ".join(f"{k}={v:.4e}" for k, v in result_k.result_metrics.items()), flush=True)

    # the KMV MLP at hidden width 64: kmv_pallas=auto takes K5's pw_fwd_kernel
    # and K6's k6_kernel (eight lanes a pair), at 64 x 2 -> 128 and at 64 x 3
    # -> 128, which pw_bwd_kernel could not hold
    for tag, overrides, layers, widths in (("wide", KMV_WIDE, 2, K6_WIDE), ("wide3", KMV_WIDE3, 3, K6_WIDE3)):
        cfg_w, _ = parse_args(KMV_MLP + overrides)
        check(cfg_w.neural_network.hidden_dim == 64 and cfg_w.neural_network.layers == layers
              and cfg_w.solver.train.sample_per_time == KMV_N, f"KMV MLP hidden-64 x {layers} configuration changed")
        torch.cuda.synchronize()
        zero_pair_launches()
        result_w = run(cfg_w, "cuda")
        torch.cuda.synchronize()
        launches_w = pair_launch()
        n_iter = cfg_w.train.number_of_iterations
        check(len(result_w.losses) == n_iter and bool(np.isfinite(result_w.losses).all())
              and pw.choose(widths, "auto") == ("pw_fwd", "k6")
              and launches_w["K5"] >= n_iter and launches_w["K6"] >= n_iter
              and launches_w["K7"] == launches_w["K8"] == 0,
              f"KMV hidden 64 x {layers}: losses {result_w.losses}, launches {launches_w}")
        metrics_w = {**result_w.test_metrics, **result_w.result_metrics}
        check(all(math.isfinite(v) for v in metrics_w.values()), f"KMV hidden 64 x {layers} metrics: {metrics_w}")
        kmv_launches[tag] = launches_w
        print(f"[main-path-kmv-{tag}] KMV MLP at hidden width 64 ({KMV_NT} stamps x {KMV_N} samples, PotentialMLP "
              f"2->64x{layers}->128 tanh), kmv_pallas=auto (K5 pw_fwd_kernel, K6 k6_kernel): {n_iter} steps, loss "
              f"{result_w.losses[0]:.4e} -> {result_w.losses[-1]:.4e}, launches {launches_w}; result "
              + " ".join(f"{k}={v:.4e}" for k, v in result_w.result_metrics.items()), flush=True)

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

    # the offline paths: dataset generation (K1 or K2), then steps on it
    def offline_run(tag, overrides):
        cfg_o, _ = parse_args(overrides)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_langevin()
        mlp_grad_quad.launches = mlp_grad_quad_bwd.launches = 0
        result_o = run(cfg_o, "cuda")
        torch.cuda.synchronize()
        launches_o = {**{f"pack{k}": v for k, v in langevin.launches_by_pack.items()},
                      "K3": mlp_grad_quad.launches, "K4": mlp_grad_quad_bwd.launches}
        n_it = cfg_o.train.number_of_iterations
        check(len(result_o.losses) == n_it and bool(np.isfinite(result_o.losses).all()),
              f"{tag}: losses {result_o.losses}")
        metrics_o = {**result_o.test_metrics, **result_o.result_metrics}
        check(all(math.isfinite(v) for v in metrics_o.values())
              and (result_o.rel_l2 is None or math.isfinite(result_o.rel_l2)), f"{tag}: metrics {metrics_o}")
        return cfg_o, result_o, launches_o, torch.cuda.max_memory_allocated()

    def result_line(res) -> str:
        if res.rel_l2 is not None:
            return f"[result] recovered-parameter rel-L2 {res.rel_l2:.4e}"
        return "[result] " + " ".join(f"{k.split()[-1]}={v:.4e}" for k, v in res.result_metrics.items())

    offline_launches = {}
    for pack in (0, 2):
        cfg_o, res_o, launches_o, peak_o = offline_run(
            f"KGMM-offline pack={pack}", ["preset=KGMM-offline", f"pde_instance.langevin_pack={pack}",
                                          *OFFLINE_STEPS])
        p_ = cfg_o.pde_instance
        check((p_.domain_dim, p_.sample_initial_size, p_.sample_terminal_size, p_.sample_0T_size,
               p_.n_steps_terminal, p_.n_steps_0T) == (D, 500_000, 200_000, 20_000, 400, 400),
              "KGMM-offline preset width changed")
        used = 2 if pack == 2 else 1
        others = [k for k in (1, 2, 4, 8) if k != used]
        check(launches_o[f"pack{used}"] >= 2 and all(launches_o[f"pack{k}"] == 0 for k in others),
              f"KGMM-offline pack={pack}: launches {launches_o}")
        offline_launches[pack] = launches_o
        t = res_o.data_timing
        print(f"[main-path-offline] KGMM-offline full width, langevin_pack={pack} (d=4, T=10; dataset "
              f"500000 initial, 200000 terminal x 400 steps, 20000 x 400 trajectories kept, "
              f"{t['bytes']} B): generation initial {1e3 * t['initial_s']:.3f} ms, terminal "
              f"{1e3 * t['terminal_s']:.3f} ms, 0T {1e3 * t['0T_s']:.3f} ms; "
              f"{len(res_o.losses)} steps (500000 + 200000 + 4000 x 80 points), loss "
              f"{res_o.losses[0]:.4e} -> {res_o.losses[-1]:.4e}, "
              f"{res_o.test_metrics['steps_per_sec']:.3f} steps/s, launches {launches_o}, peak memory "
              f"{peak_o} B ({peak_o / 2**30:.3f} GiB); {result_line(res_o)}", flush=True)

    cfg_o, res_o, launches_o, peak_o = offline_run(
        "KGMM-nonparametric", ["preset=KGMM-nonparametric", *OFFLINE_STEPS])
    n_it = cfg_o.train.number_of_iterations
    check(launches_o["K3"] >= n_it and launches_o["K4"] >= n_it and launches_o["pack1"] >= 2,
          f"KGMM-nonparametric: launches {launches_o}")
    t = res_o.data_timing
    print(f"[main-path-offline-np] KGMM-nonparametric full width (T=4, PotentialMLP 4->32->32->128 "
          f"tanh, 320000 path points a step through K3/K4): generation initial "
          f"{1e3 * t['initial_s']:.3f} ms, terminal {1e3 * t['terminal_s']:.3f} ms, 0T "
          f"{1e3 * t['0T_s']:.3f} ms; {n_it} steps, loss {res_o.losses[0]:.4e} -> "
          f"{res_o.losses[-1]:.4e}, {res_o.test_metrics['steps_per_sec']:.3f} steps/s, launches "
          f"{launches_o}, peak memory {peak_o} B ({peak_o / 2**30:.3f} GiB); {result_line(res_o)}",
          flush=True)

    # the XL store, generated into a fresh directory and removed afterwards
    os.makedirs(os.path.join(here, ".scratch"), exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="kgmm-xl-store-", dir=os.path.join(here, ".scratch"))
    try:
        cfg_o, res_o, launches_o, peak_o = offline_run(
            "KGMM-nonparametric-offline-XL",
            ["preset=KGMM-nonparametric-offline-XL", f"pde_instance.dataset_path={store_dir}/store",
             *OFFLINE_STEPS])
    finally:
        shutil.rmtree(store_dir)
    p_, n_it = cfg_o.pde_instance, cfg_o.train.number_of_iterations
    check((p_.sample_0T_size, p_.n_steps_0T, cfg_o.solver.train.offline_traj_batch, p_.offline_streaming)
          == (200_000, 400, 8192, True), "XL preset width changed")
    check(launches_o["K3"] >= n_it and launches_o["K4"] >= n_it and launches_o["pack1"] >= 2,
          f"XL: launches {launches_o}")
    t, gathers = res_o.data_timing, res_o.gather_seconds
    print(f"[main-path-offline-xl] KGMM-nonparametric-offline-XL: store of {t['bytes']} B "
          f"({t['bytes'] / 1e9:.3f} GB; 200000 x 400 BAOAB trajectories) generated on the card in "
          f"{t['generate_s']:.3f} s, copied to the host in {t['to_host_s']:.3f} s, written to the memmap "
          f"in {t['write_s']:.3f} s; {n_it} streamed steps (8192 trajectories x 80 = 655360 path points, "
          f"PotentialMLP 4+128->64->64->256 tanh with quadratic head), host gather per chunk of "
          f"{cfg_o.train.steps_per_chunk}: " + ", ".join(f"{1e3 * g:.1f} ms" for g in gathers)
          + f"; loss {res_o.losses[0]:.4e} -> {res_o.losses[-1]:.4e}, "
          f"{res_o.test_metrics['steps_per_sec']:.3f} steps/s, launches {launches_o}, peak memory "
          f"{peak_o} B ({peak_o / 2**30:.3f} GiB); {result_line(res_o)}", flush=True)

    # where one offline step's time goes: the subsample vs loss and gradient
    cfg_o, _ = parse_args(["preset=KGMM-offline", *OFFLINE_STEPS])
    key_problem, key_method, key_trainer, _ = rng.split(cfg_o.seed, 4)
    inst = get_pde_instance(cfg_o)(cfg_o, key_problem, dev)
    method = get_method(cfg_o)(inst, cfg_o, key_method, dev)
    model, params = method.create_model_fn()
    loss_mod, fwd = method._loss_module(), functional_forward(model)
    t_sample, t_loss = [], []
    for s_ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = method.sample_data(rng.fold_in(key_trainer, s_))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = loss_mod.value_and_grad_fn(fwd, params, batch, inst)
        float(out["loss"])
        t2 = time.perf_counter()
        if s_:
            t_sample.append(t1 - t0)
            t_loss.append(t2 - t1)
    print(f"[step-split-offline] KGMM-offline full-width step, median of 5: subsample "
          f"{1e3 * float(np.median(t_sample)):.3f} ms, loss+gradient {1e3 * float(np.median(t_loss)):.3f} ms",
          flush=True)
    del inst, method, batch, out

    # one offline step on the card vs the CPU, on one shared dataset and subsample
    cfg_s, _ = parse_args(OFFLINE_SMALL)
    key_problem, key_method, key_trainer, _ = rng.split(cfg_s.seed, 4)
    inst_c = get_pde_instance(cfg_s)(cfg_s, key_problem, dev)
    shared = {"mus": inst_c.configuration["mus"].cpu().numpy(),
              "dataset": {k: v.cpu().numpy() for k, v in inst_c.dataset.items()}}
    inst_h = get_pde_instance(cfg_s)(cfg_s, key_problem, "cpu", configuration=shared)
    outs = {}
    draw = None
    for name, inst in (("cpu", inst_h), ("cuda", inst_c)):
        method = get_method(cfg_s)(inst, cfg_s, key_method, inst.device)
        model, params = method.create_model_fn()
        if draw is None:
            draw = method.offline_draw(key_trainer, *inst.dataset["0T"].shape[:2])
        shift, idx = draw
        method.offline_draw = lambda *_a, shift=shift, idx=idx, d=inst.device: (shift, idx.to(d))
        outs[name] = method.value_and_grad_fn(functional_forward(model), params, key_trainer, step=0)
    rel = max(float(abs(float(outs["cuda"][n]) - float(outs["cpu"][n])) / abs(float(outs["cpu"][n])))
              for n in ("loss", "loss ground truth"))
    g_rel = float((outs["cuda"]["grad"]["mus"].cpu() - outs["cpu"]["grad"]["mus"]).abs().max()
                  / outs["cpu"]["grad"]["mus"].abs().max())
    check(max(rel, g_rel) <= STEP_RTOL, f"offline card vs CPU step: loss rel {rel:.3e}, grad rel {g_rel:.3e}")
    print(f"[main-path-offline-vs-cpu] one KGMM-offline step on a shared dataset (generated on the card) "
          f"and subsample: loss/gap rel err {rel:.3e}, grad rel err {g_rel:.3e} <= {STEP_RTOL}", flush=True)

    # -- 6. the diagnostics S1-S3 ---------------------------------------------------------
    for fn in pw.S1_WRAPPERS:
        fn.launches = 0
    s1_out = s1.run("cuda")
    s1_launches = sum(fn.launches for fn in pw.S1_WRAPPERS)
    check(s1_out["ok"] and s1_launches >= 5, f"S1: {s1_out}, launches {s1_launches}")
    print(f"[s1] DIAG OK: {s1_out['checks']} checks, {s1_launches} launches, largest kernel-vs-plain "
          f"difference {s1_out['max_abs_err']:.3e}", flush=True)
    # S2 on two inputs a shape (cancelling columns, and sums that do not
    # cancel): each mode within its float64 bound and against its plain
    # version (sum bit for bit, the column sums within 8 R 2^-24 of sum |x|)
    pw.sum_rows.launches = mma_tf32.column_sum.launches = 0
    s2_out = s2.run("cuda")
    s2_launches = {"sum_rows": pw.sum_rows.launches, "column_sum": mma_tf32.column_sum.launches}
    check(s2_out["ok"] and s2_launches == {"sum_rows": 6, "column_sum": 12},
          f"S2: {s2_out}, launches {s2_launches}")
    print(f"[s2] axis-0 sums within their rounding bounds and against their plain versions, launches "
          f"{s2_launches}, largest kernel-vs-plain difference {s2_out['max_abs_err']:.3e}; rel(cancel-scale) "
          + "; ".join(f"{R}x{w} {mode} {r:.3e}" for R, w, mode, _, _, r in s2_out["rows"]), flush=True)
    mma_tf32.tf32_matmul.launches = 0
    s3_out = s3.run("cuda")
    s3_launches = mma_tf32.tf32_matmul.launches
    check(s3_out["ok"] and s3_launches == 12, f"S3: {s3_out}, launches {s3_launches}")
    print(f"[s3] block-diagonal products within their rounding bounds, {s3_launches} launches; rel "
          + "; ".join(f"{R}x{pw_} {mode} {tag} {r:.3e}" for R, pw_, mode, tag, r in s3_out["rows"]),
          flush=True)

    # -- 7. timing ---------------------------------------------------------------------
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
        for pack, kid in ((1, "K1"), (2, "K2")):
            kernel = lambda: langevin(5, z, N_STEPS, DT, gmm, GAMMA, return_trajectory=with_traj, pack=pack)
            plain = lambda: langevin_plain(5, z, N_STEPS, DT, gmm, GAMMA, return_trajectory=with_traj)
            p1, k1, k2, p2 = time_ms(plain, 3), time_ms(kernel, 20), time_ms(kernel, 20), time_ms(plain, 3)
            times[(kid, shape)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"[timing] {kid} {shape} batch (GMM d=4, n={z.shape[0]}, 200 steps, "
                  f"trajectory={with_traj}, pack={pack}): kernel {times[(kid, shape)][0]:.4f} ms, plain "
                  f"torch {times[(kid, shape)][1]:.4f} ms (runs: plain {p1:.4f}, kernel {k1:.4f}, "
                  f"kernel {k2:.4f}, plain {p2:.4f})", flush=True)

    # K2 against K1 at the online and offline shapes, in turns (K1, K2, K2, K1)
    for n, steps, with_traj, what in ((N_PATH, N_STEPS, True, "online path batch"),
                                      (N_TERMINAL, N_STEPS, False, "online terminal batch"),
                                      (200_000, 400, False, "offline terminal set"),
                                      (20_000, 400, True, "offline 0T set")):
        z = initial(n)
        fn = lambda pack: (lambda: langevin(5, z, steps, DT, gmm, GAMMA, return_trajectory=with_traj,
                                            pack=pack))
        a1, b1, b2, a2 = time_ms(fn(1), 10), time_ms(fn(2), 10), time_ms(fn(2), 10), time_ms(fn(1), 10)
        by_pack = {1: (a1 + a2) / 2, 2: (b1 + b2) / 2, 4: time_ms(fn(4), 10), 8: time_ms(fn(8), 10)}
        least_ms, least_by = bound(*langevin_work(n, steps, D, K, with_traj))
        print(f"[timing] K2 vs K1, {what} (GMM d=4, n={n}, {steps} steps, trajectory={with_traj}): "
              + ", ".join(f"pack={k} {v:.4f} ms" for k, v in by_pack.items())
              + f" (runs: K1 {a1:.4f}, K2 {b1:.4f}, K2 {b2:.4f}, K1 {a2:.4f}); K2/K1 "
              f"{by_pack[2] / by_pack[1]:.3f}; bound {least_ms:.6f} ms ({least_by})", flush=True)

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
    del mids, streams, cot
    args, bars = front_inputs(dev, N_PATHS_1M, torch.float32, 10, True)
    for name, kernel, plain, a in (("K9", front_streams, front_streams_plain, args),
                                   ("K10", front_streams_bwd, front_streams_bwd_plain, (*args[:4], *bars))):
        k_fn, p_fn = lambda: kernel(*a), lambda: plain(*a)
        p1, k1, k2, p2 = time_ms(p_fn, 5), time_ms(k_fn, 20), time_ms(k_fn, 20), time_ms(p_fn, 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[timing] {name} front end (n={N_PATHS_1M}, d 4, F 64, w0 64): kernel {times[name][0]:.4f} ms, "
              f"plain torch {times[name][1]:.4f} ms (runs: plain {p1:.4f}, kernel {k1:.4f}, kernel "
              f"{k2:.4f}, plain {p2:.4f})", flush=True)
    x_, v_, *leaves = args

    def front_torch():  # the same front end as PyTorch operations, forward and backward
        ls = [t.detach().requires_grad_() for t in leaves]
        torch.autograd.backward(front_streams_plain(x_, v_, *ls), bars)

    front_torch_ms = time_ms(front_torch, 5)
    print(f"[timing] the front end as PyTorch operations, forward and backward (n={N_PATHS_1M}): "
          f"{front_torch_ms:.4f} ms; K9 + K10 {times['K9'][0] + times['K10'][0]:.4f} ms", flush=True)
    del args, bars, x_, v_, leaves
    for n, widths, what in ((N_POINTS_XL, WIDTHS, "XL"), (N_POINTS_OFFLINE, WIDTHS_OFFLINE, "offline")):
        mids, streams, cot = pointwise_inputs(dev, n, torch.float32, 7, widths)
        k3_ms = time_ms(lambda: mlp_grad_quad(mids, "tanh", *streams), 10)
        k4_ms = time_ms(lambda: mlp_grad_quad_bwd(mids, "tanh", *streams, *cot), 10)
        ops = 2.0 * n * mlp_products(widths)
        print(f"[timing] K3, K4 at the {what} step's shape (n={n}, layers {'->'.join(map(str, widths))}, "
              f"tanh): K3 {k3_ms:.4f} ms (bound {bound(0, 4 * ops)[0]:.4f}), K4 {k4_ms:.4f} ms (bound "
              f"{bound(0, K4_PRODUCTS * ops)[0]:.4f})", flush=True)
        del mids, streams, cot

    mids, tens, cot = pairwise_inputs(dev, KMV_NT, KMV_N, KMV_N, torch.float32, 10)
    for kid, (kernel, plain) in kernels.items():
        k_fn = lambda: pairwise_call(kid, kernel, "tanh", mids, tens, cot)
        p_fn = lambda: pairwise_call(kid, plain, "tanh", mids, tens, cot)
        p1, k1, k2, p2 = time_ms(p_fn, 2), time_ms(k_fn, 3), time_ms(k_fn, 3), time_ms(p_fn, 2)
        times[kid] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[timing] {kid} full width ({KMV_NT}x{KMV_N}x{KMV_N} pairs, layers 20x8->128, tanh): "
              f"kernel {times[kid][0]:.4f} ms, plain torch {times[kid][1]:.4f} ms (runs: plain "
              f"{p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f})", flush=True)

    mids, tens, cot = pairwise_inputs(dev, KMV_NT, KMV_N, KMV_N, torch.float32, 10, (), K6_WIDE)
    for kid, name in (("K5", "pw_fwd_kernel"), ("K6", "k6_kernel")):
        k_fn = lambda: pairwise_call(kid, kernels[kid][0], "tanh", mids, tens, cot)
        p_fn = lambda: pairwise_call(kid, kernels[kid][1], "tanh", mids, tens, cot)
        p1, k1, k2, p2 = time_ms(p_fn, 1), time_ms(k_fn, 2), time_ms(k_fn, 2), time_ms(p_fn, 1)
        times[f"{kid}-wide"] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[timing] {kid} hidden 64 through {name} ({KMV_NT}x{KMV_N}x{KMV_N} pairs, layers "
              f"{'->'.join(map(str, K6_WIDE))}, tanh): kernel {times[f'{kid}-wide'][0]:.4f} ms, plain torch "
              f"{times[f'{kid}-wide'][1]:.4f} ms (runs: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, "
              f"plain {p2:.4f})", flush=True)
    del mids, tens, cot

    # S1-S3 at their scripts' shapes, beside one PyTorch call for the same function;
    # K9's and K10's library_ms: the PyTorch front end, forward and backward
    library = {"K9": front_torch_ms, "K10": front_torch_ms}
    gen_s = torch.Generator().manual_seed(12)
    ax_s, av_s = (torch.randn((s1.BI, s1.W0), generator=gen_s).to(dev) for _ in range(2))
    ar_s = torch.randn((s1.N_REFS, s1.W0), generator=gen_s).to(dev)
    k_fn = lambda: pw.s1_pair_rows(ax_s, av_s, ar_s)
    p_fn = lambda: pw.s1_pair_rows_plain(ax_s, av_s, ar_s)
    l_fn = lambda: ax_s[None] - ar_s[:, None]
    p1, k1, k2, p2 = time_ms(p_fn, 200), time_ms(k_fn, 200), time_ms(k_fn, 200), time_ms(p_fn, 200)
    times["S1"], library["S1"] = ((k1 + k2) / 2, (p1 + p2) / 2), time_ms(l_fn, 200)
    dev_k, dev_l = time_diag.times(k_fn, 200), time_diag.times(l_fn, 200)
    print(f"[timing] S1 pair rows ({s1.BI} points x {s1.N_REFS} refs, width {s1.W0}): kernel "
          f"{times['S1'][0]:.4f} ms, plain torch {times['S1'][1]:.4f} ms, one PyTorch call "
          f"(ax[None] - ar[:, None]) {library['S1']:.4f} ms; device time (torch.profiler, 200 calls): "
          f"kernel {dev_k['device_ms']:.4f} ms, PyTorch call {dev_l['device_ms']:.4f} ms", flush=True)
    x_s = torch.from_numpy(s2.inputs(2048, 120)).to(dev)
    s2_times = {mode: time_ms(lambda: s2.reduce(mode, x_s), 200) for mode in s2.MODES}
    s2_plain = {mode: time_ms(lambda: s2.reduce_plain(mode, x_s), 20) for mode in s2.MODES}
    s2_dev = {mode: time_diag.times(lambda: s2.reduce(mode, x_s), 200)["device_ms"] for mode in s2.MODES}
    times["S2"], library["S2"] = (s2_times["dot"], s2_plain["dot"]), time_ms(lambda: x_s.sum(0), 200)
    lib_dev = time_diag.times(lambda: x_s.sum(0), 200)["device_ms"]
    print("[timing] S2 axis-0 sum of [2048, 120]: " + ", ".join(
        f"{mode} kernel {s2_times[mode]:.4f} ms (device {s2_dev[mode]:.4f} ms; plain {s2_plain[mode]:.4f} ms)"
        for mode in s2.MODES)
        + f"; one PyTorch call x.sum(0) {library['S2']:.4f} ms (device {lib_dev:.4f} ms)", flush=True)
    sum_rows_err = 0.0
    # sum_rows at the partial rows K7 and K8 finish on the KMV MLP path; the
    # kernels line times it, in turns with its plain version, at K8's
    # weight-gradient partials
    for what, (rows, cols) in time_diag.kmv_partial_shapes(dev).items():
        part = torch.randn((rows, cols), generator=gen_s).to(dev)
        got_rows, plain_rows = pw.sum_rows(part), pw.sum_rows_plain(part)
        sum_rows_err = max(sum_rows_err, float((got_rows - plain_rows).abs().max()))
        check(torch.equal(got_rows, plain_rows),
              f"sum_rows {what} [{rows}, {cols}] differs from its plain version")
        t_rows = time_diag.times(lambda: pw.sum_rows(part), 50)
        print(f"[timing] sum_rows {what} ({rows} rows x {cols} columns, bitwise its plain version): device "
              f"{t_rows['device_ms']:.4f} ms, call {t_rows['call_ms']:.4f} ms, bound "
              f"{1e3 * 4 * (rows + 1) * cols / PEAK_BYTES_PER_S:.4f} ms (bytes); one PyTorch call "
              f"part.sum(0) {time_ms(lambda: part.sum(0), 50):.4f} ms", flush=True)
        if what == "K8 weight gradients":
            k_fn, p_fn = lambda: pw.sum_rows(part), lambda: pw.sum_rows_plain(part)
            p1, k1, k2, p2 = time_ms(p_fn, 5), time_ms(k_fn, 50), time_ms(k_fn, 50), time_ms(p_fn, 5)
            times["sum_rows"] = ((k1 + k2) / 2, (p1 + p2) / 2)
            library["sum_rows"] = time_ms(lambda: part.sum(0), 50)
            sum_rows_shape = (rows, cols)
        del part
    x3, W3 = (torch.from_numpy(a).to(dev) for a in s3.inputs(2048, 20, 6))
    s3_times = {prec: time_ms(lambda: mma_tf32.tf32_matmul(x3, W3, prec), 200) for prec in ("tf32", "3xtf32")}
    s3_plain = {prec: time_ms(lambda: mma_tf32.tf32_matmul_plain(x3, W3, prec), 50)
                for prec in ("tf32", "3xtf32")}
    s3_dev = {f"{prec}{' W^T' if bt else ''}": time_diag.times(
        lambda: mma_tf32.tf32_matmul(x3, W3, prec, bt), 200)["device_ms"]
        for prec in ("tf32", "3xtf32") for bt in (False, True)}
    torch.backends.cuda.matmul.allow_tf32 = True
    lib_tf32 = time_ms(lambda: x3 @ W3, 200)
    lib_tf32_dev = time_diag.times(lambda: x3 @ W3, 200)["device_ms"]
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_f32 = time_ms(lambda: x3 @ W3, 200)
    times["S3"], library["S3"] = (s3_times["tf32"], s3_plain["tf32"]), lib_tf32
    print(f"[timing] S3 [2048, 120] x [120, 120] block-diagonal x @ W: TF32 kernel {s3_times['tf32']:.4f} ms "
          f"(plain {s3_plain['tf32']:.4f} ms), 3xTF32 kernel {s3_times['3xtf32']:.4f} ms (plain "
          f"{s3_plain['3xtf32']:.4f} ms); one PyTorch call x @ W with TF32 allowed {lib_tf32:.4f} ms, "
          f"disallowed {lib_f32:.4f} ms; device time (torch.profiler, 200 calls): kernel "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in s3_dev.items())
          + f", x @ W with TF32 allowed {lib_tf32_dev:.4f} ms", flush=True)

    # bounds, from this run's shapes: each input read once, each output written once
    bounds = {}
    work = [langevin_work(N_PATH, N_STEPS, D, K, True), langevin_work(N_TERMINAL, N_STEPS, D, K, False)]
    bounds["K1"] = bounds["K2"] = bound(sum(w[0] for w in work), sum(w[1] for w in work))
    F = mlp_products(WIDTHS)
    pt_bytes = 4 * N_POINTS * (3 * WIDTHS[0] + 1 + WIDTHS[0])  # 3 streams in; quad, delta out
    bounds["K3"] = bound(pt_bytes, 2.0 * N_POINTS * 4 * F)  # 3 forward streams, 1 reverse
    # K4: 3 streams and 2 cotangents in, 3 stream cotangents out; 4 forward
    # products, and 3 weight-gradient and 3 input products: qbar = g_quad rbar
    # at every layer, so the q stream's two are not computed (the first
    # design computed all 12: its bound was 12 / 10 of this one)
    bounds["K4"] = bound(4 * N_POINTS * (7 * WIDTHS[0] + 1), 2.0 * N_POINTS * K4_PRODUCTS * F)
    # K9: x, v in; z1, dz1, d2z1, cos p, sin p out; three streams over the
    # rows of W0 (d2z1 has no x rows).  K10: x, v and five cotangents in,
    # W0, b0, B out; the weight gradients (three streams) and the cotangents
    # of cos p and sin p (three products over w0 of the 2F cos and sin rows)
    fd, fnf, fw = FRONT
    bounds["K9"] = bound(4 * N_PATHS_1M * (2 * fd + 3 * fw + 2 * fnf),
                         2.0 * N_PATHS_1M * (3 * 2 * fnf + 2 * fd) * fw)
    bounds["K10"] = bound(4 * N_PATHS_1M * (2 * fd + 3 * fw + 2 * fnf),
                          2.0 * N_PATHS_1M * ((3 * 2 * fnf + 2 * fd) * fw + 3 * 2 * fnf * fw + 2 * 2 * fd * fnf))
    pairs = float(KMV_NT * KMV_N * KMV_N)
    x_bytes = 4 * (3 * KMV_NT * KMV_N * KMV_WIDTHS[0] + KMV_N + 2 * KMV_NT * KMV_N
                   + KMV_NT * KMV_N * KMV_WIDTHS[0])  # ax, av, ar, mask in; value, hess, s_dz0 out
    F5, Fh, wm = mlp_products(KMV_WIDTHS), mlp_products(KMV_WIDTHS[:-1]), KMV_WIDTHS[0] ** 2
    bounds["K5"] = bound(x_bytes, 2 * pairs * 4 * F5)
    bounds["K6"] = bound(x_bytes, 2 * pairs * 12 * F5)
    w0w = K6_WIDE[0]
    x_bytes_wide = 4 * (3 * KMV_NT * KMV_N * w0w + KMV_N + 2 * KMV_NT * KMV_N + KMV_NT * KMV_N * w0w)
    bounds["K5-wide"] = bound(x_bytes_wide, 2 * pairs * 4 * mlp_products(K6_WIDE))
    bounds["K6-wide"] = bound(x_bytes_wide, 2 * pairs * 12 * mlp_products(K6_WIDE))
    # K7: 3 streams through the hidden layers, Mg and M gp, 1 reverse stream
    bounds["K7"] = bound(x_bytes, 2 * pairs * (3 * Fh + 2 * wm + Fh))
    bounds["K8"] = bound(x_bytes, 2 * pairs * (4 * (Fh + wm) + 2 * wm + 8 * Fh))
    bounds["S1"] = bound(4 * (2 * s1.BI * s1.W0 + s1.N_REFS * s1.W0 + 2 * s1.N_REFS * s1.BI * s1.W0),
                         float(s1.N_REFS * s1.BI * s1.W0))
    bounds["S2"] = bound(4 * (2048 * 120 + 120), 2.0 * 2048 * 120, PEAK_TF32_FLOPS)  # the ones are registers
    bounds["sum_rows"] = bound(4 * (sum_rows_shape[0] + 1) * sum_rows_shape[1],
                               float(sum_rows_shape[0] * sum_rows_shape[1]))
    bounds["S3"] = bound(4 * (2 * 2048 * 120 + 120 * 120), 2.0 * 2048 * 120 * 120, PEAK_TF32_FLOPS)
    print("[bounds] least time per kernel at the timed shapes (larger of bytes / 3.35 TB/s and "
          "operations / 67 TFLOP/s FP32 or 494.7 TFLOP/s TF32): "
          + "; ".join(f"{k} {v[0]:.6f} ms ({v[1]})" for k, v in bounds.items())
          + f"; K4 under the first design's count of 12 products {bounds['K4'][0] * 12 / K4_PRODUCTS:.6f} ms",
          flush=True)

    check("jax" not in sys.modules, "JAX was imported")

    def row(kid, name, source, replaces, n_launches, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1], "library_ms": library.get(kid)}

    # K1/K2: one training step's two launches, path (2500, trajectory) + terminal (75000)
    step_ms = lambda kid, i: times[(kid, "path")][i] + times[(kid, "terminal")][i]
    rows_out = [
        row("K1", "K1 kinetic Langevin (EM/BAOAB, GMM or Quadratic force)",
            "pde_inverse_torch/csrc/langevin.cu", "pde_inverse_tpu/ops/pallas/langevin_kernel.py:110",
            launches, max_err[1], step_ms("K1", 0), step_ms("K1", 1)),
        # launches from the online KGMM run with langevin_pack=2
        row("K2", "K2 kinetic Langevin, two particles per thread (pde_instance.langevin_pack=2)",
            "pde_inverse_torch/csrc/langevin.cu", "pde_inverse_tpu/ops/pallas/langevin_kernel.py:275",
            k2_launches[2], max_err[2], step_ms("K2", 0), step_ms("K2", 1)),
    ]
    for kid, name, line in (
        ("K3", "K3 fused pointwise forward (second-order MLP streams, quad and delta)", 67),
        ("K4", "K4 fused pointwise VJP (4-stream forward, 3-stream reverse sweep and weight gradients)", 186),
    ):
        rows_out.append(row(kid, name, "pde_inverse_torch/csrc/pointwise.cu",
                            f"pde_inverse_tpu/ops/pallas/pointwise_kernel.py:{line}", np_launches[kid],
                            k34_err[kid], *times[kid]))
    for kid, name in (("K9", "K9 Fourier front end: first-layer streams z1, dz1, d2z1 and cos p, sin p of "
                       "[x, cos xB, sin xB] (timed: 1,000,000 points; library_ms: the PyTorch front end, "
                       "forward and backward)"),
                      ("K10", "K10 VJP of K9: gradients of W0, b0 and B from the cotangents of its five "
                       "outputs (timed: 1,000,000 points; library_ms as K9's)")):
        rows_out.append(row(kid, name, "pde_inverse_torch/csrc/pointwise.cu",
                            "none: XLA's fusion of pde_inverse_tpu/losses/fused_pointwise.py:68-87",
                            np_launches[kid], k910_err[kid], *times[kid]))
    for kid, name, replaces in (
        ("K5", "K5 pairwise mean-field sums, |f|^2 head (value, vHv, dPhi/dz0 over refs) through k5_kernel "
         "(hidden widths <= 32: K7's thread per point, the feature layer streamed in chunks of 4)",
         "pde_inverse_tpu/ops/pallas/pairwise_kernel.py:136"),
        ("K6", "K6 VJP of K5 through k6_kernel (hidden widths <= 32: K8's lane quads, the feature layer "
         "streamed in chunks)", "pde_inverse_tpu/ops/pallas/pairwise_kernel.py:340"),
        ("K7", "K7 pairwise sums through the collapsed head g.Mg + u.g",
         "pde_inverse_tpu/ops/pallas/pairwise_packed.py:219"),
        ("K8", "K8 VJP of K7 (mids, M, u, ax, av, ar)",
         "pde_inverse_tpu/ops/pallas/pairwise_packed.py:468"),
    ):
        # K7/K8 from the kmv_pallas=auto run, K5/K6 from the kmv_pallas=on run
        rows_out.append(row(kid, name, "pde_inverse_torch/csrc/pairwise.cu", replaces,
                            kmv_launches["auto" if kid in ("K7", "K8") else "on"][kid], pair_err[kid],
                            *times[kid]))
    # launches: the hidden-64 x 2 KMV run's (kmv_pallas=auto)
    rows_out.append(row("K5-wide", "K5 hidden > 32: pairwise sums, |f|^2 head, through pw_fwd_kernel (timed: "
                        f"layers {'->'.join(map(str, K6_WIDE))}, {KMV_NT}x{KMV_N}x{KMV_N} pairs)",
                        "pde_inverse_torch/csrc/pairwise.cu", "pde_inverse_tpu/ops/pallas/pairwise_kernel.py:136",
                        kmv_launches["wide"]["K5"], wide_err["K5"], *times["K5-wide"]))
    rows_out.append(row("K6-wide", "K6 hidden 33-64: VJP of K5 through k6_kernel at W = 48 / 64 (eight lanes a "
                        f"pair; timed: W = 64, layers {'->'.join(map(str, K6_WIDE))}, {KMV_NT}x{KMV_N}x{KMV_N} pairs)",
                        "pde_inverse_torch/csrc/pairwise.cu", "pde_inverse_tpu/ops/pallas/pairwise_kernel.py:340",
                        kmv_launches["wide"]["K6"], wide_err["K6"], *times["K6-wide"]))
    rows_out += [
        row("S1", "S1 single-block checks of K5-K8's constructs (timed: pair rows)",
            "pde_inverse_torch/csrc/pairwise.cu", "scripts/diag_packed_onchip.py:47", s1_launches,
            s1_out["max_abs_err"], *times["S1"]),
        # S2's sum mode is sum_rows (below); its launches are the S2 run's
        row("S2", "S2 dot/dot_hi: TF32 tensor-core column sum of [2048, 120] (timed: dot, mma.sync, "
            "ones in registers)", "pde_inverse_torch/csrc/mma_tf32.cu",
            "scripts/microtest_sublane_reduce.py:47", s2_launches["column_sum"], s2_out["max_abs_err"],
            *times["S2"]),
        # launches: the kmv_pallas=auto run's (K7 once, K8 three times a step), counted in the library
        row("sum_rows", "S2 sum: sum_rows, the fixed-order row sum that also finishes K5-K8's partial rows "
            f"(timed: K8's weight-gradient partials [{sum_rows_shape[0]}, {sum_rows_shape[1]}])",
            "pde_inverse_torch/csrc/pairwise.cu", "scripts/microtest_sublane_reduce.py:47",
            sum_rows_launches["auto"], sum_rows_err, *times["sum_rows"]),
        row("S3", "S3 block-diagonal [2048, 120] x [120, 120] (timed: TF32 mma.sync, operands staged, x @ W; "
            f"device {s3_dev['tf32']:.4f} ms against x @ W's {lib_tf32_dev:.4f} ms)",
            "pde_inverse_torch/csrc/mma_tf32.cu", "scripts/microtest_blkdiag_dot.py:37", s3_launches,
            s3_out["max_abs_err"], *times["S3"]),
    ]
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
