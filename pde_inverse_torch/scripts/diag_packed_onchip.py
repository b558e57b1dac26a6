"""S1: on-card checks of the constructs the pairwise kernels K5-K8 run
(counterpart of scripts/diag_packed_onchip.py).

The JAX script checked, one single-cell Pallas kernel each, the TPU lane
packing of the packed pairwise kernels K7/K8.  The port's kernels have no
lane packing.  So this script checks the constructs they do have: steps 1
to 4 in kernels built from the very device functions of K5 and K6 in
``csrc/pairwise.cu`` (K5/K6 walk their refs one 32-pair tile at a time with
every layer's streams in shared memory; the pair rows run a block a ref,
the M layer one block; of K7's and K8's constructs they cover the row sum),
step 5 K7 and K8 whole; all against numpy float64 (tolerance 1e-5, relative
to the largest value):

  1. pair rows: z = ax_i - ar_j and dz = av_i (``pair_rows``);
  2. the ref mask: a masked ref adds exactly 0.0 (on the card the masked
     sums equal, bit for bit, the sums over the unmasked refs alone);
  3. an M layer: M g for the tile's three streams (K5/K6's
     ``forward_product`` with M = W_F W_F^T and a zero bias);
  4. the fixed-order row sum that finishes the kernels' partial rows
     (``sum_rows``);
  5. K7 and K8 with the refs unsplit (nt=2) against their plain versions
     (tolerance 1e-4), with tanh: the JAX script used gelu, which neither
     package's derivative tables cover, so its steps 6/7 raise before they
     compare anything; tanh is the KMV MLP's activation.

Shapes are the JAX script's: 16 points, 48 refs (its P * BJ), width 20,
two 20 x 20 layers, numpy seeds 0-7.  Prints [OK]/[BAD] lines, then DIAG OK
or DIAG MISMATCH; a mismatch exits with 1.

    python -m pde_inverse_torch.scripts.diag_packed_onchip [--device cpu]

(``--device cpu`` runs the plain versions against the same truth.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pde_inverse_torch.device import resolve_device, setup_precision
from pde_inverse_torch.ops.cuda import pairwise as pw

BI, BJ, W0, P = 16, 8, 20, 6
N_REFS = P * BJ
TOL, TOL_KERNEL = 1e-5, 1e-4


def _rel(got, want) -> tuple:
    got = np.asarray(torch.as_tensor(got).double().cpu()) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want))) if want.size else 0.0
    return err, err / max(1e-12, float(np.max(np.abs(want))) or 1.0)


def _flat(out) -> list:
    """K7's dict or K8's (layer grads, M_bar, u_bar, ax_bar, av_bar, ar_bar)
    as a list of tensors."""
    if isinstance(out, dict):
        return [out[k] for k in ("value", "hess", "s_dz0")]
    items = [t for W, b in out[0] for t in (W, b)]
    return items + list(out[1:])


def run(device=None) -> dict:
    """{"ok": every check passed, "checks": their count, "max_abs_err": the
    largest difference of a kernel from its plain version on the same
    inputs (0 on the CPU, where the wrappers run the plain versions)}."""
    dev = resolve_device(device)
    setup_precision()
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    on_card = dev.type == "cuda"
    state = {"ok": True, "checks": 0, "max_abs_err": 0.0}

    def check(name, got, want, tol=TOL, exact=False):
        err, rel = _rel(got, want)
        good = err == 0.0 if exact else rel < tol
        print(f"[{'OK ' if good else 'BAD'}] {name}: max abs {err:.3e} rel {rel:.3e}", flush=True)
        state["ok"] &= good
        state["checks"] += 1

    def vs_plain(kernel_out, plain_out):
        for k_, p_ in zip(kernel_out, plain_out):
            state["max_abs_err"] = max(state["max_abs_err"], float((k_ - p_).abs().max()))

    # 1. pair rows
    ax = np.random.RandomState(2).randn(BI, W0).astype(np.float32)
    av = np.random.RandomState(3).randn(BI, W0).astype(np.float32)
    ar = np.random.RandomState(4).randn(N_REFS, W0).astype(np.float32)
    z, dz = pw.s1_pair_rows(to(ax), to(av), to(ar))
    check("pair rows z", z, ax[None].astype(np.float64) - ar[:, None])
    check("pair rows dz", dz, np.broadcast_to(av[None], (N_REFS, BI, W0)))
    vs_plain((z, dz), pw.s1_pair_rows_plain(to(ax), to(av), to(ar)))

    # the full kernels' inputs (the JAX script's steps 6/7)
    rs = np.random.RandomState(5)
    nt = 2
    mids = [(rs.randn(W0, W0).astype(np.float32) / np.sqrt(W0), rs.randn(W0).astype(np.float32) * 0.1)
            for _ in range(2)]
    WF = rs.randn(W0, 24).astype(np.float32) / np.sqrt(W0)
    M = (WF @ WF.T).astype(np.float32)
    u = rs.randn(W0).astype(np.float32) * 0.1
    axs, avs = (rs.randn(nt, BI, W0).astype(np.float32) for _ in range(2))
    ars = rs.randn(nt, N_REFS, W0).astype(np.float32)
    mask = (rs.rand(N_REFS) > 0.2).astype(np.float32)
    gv, gh = (rs.randn(nt, BI).astype(np.float32) for _ in range(2))
    gd = rs.randn(nt, BI, W0).astype(np.float32)
    tm = [(to(W), to(b)) for W, b in mids]
    t64 = [(torch.from_numpy(W).double(), torch.from_numpy(b).double()) for W, b in mids]
    f64 = lambda a: torch.from_numpy(np.asarray(a)).double()

    # 2. the ref mask: masked refs add exactly 0.0
    mk = (np.random.RandomState(1).rand(N_REFS) > 0.3).astype(np.float32)
    keep = np.flatnonzero(mk)
    masked = pw.s1_packed_sums(tm, to(M), to(u), "tanh", to(axs), to(avs), to(ars), to(mk))
    subset = pw.s1_packed_sums(tm, to(M), to(u), "tanh", to(axs), to(avs), to(ars[:, keep]),
                               to(np.ones(len(keep))))
    truth = pw.mlp_pairwise_sums_packed_plain(t64, f64(M), f64(u), "tanh", f64(axs), f64(avs),
                                              f64(ars[:, keep]), torch.ones(len(keep), dtype=torch.float64))
    for key in ("value", "hess", "s_dz0"):
        check(f"ref mask {key}: {N_REFS - len(keep)} masked refs add exactly 0.0", masked[key],
              np.asarray(subset[key].double().cpu()), exact=on_card)
        check(f"ref mask {key} vs float64", masked[key], truth[key].numpy())

    # 3. the collapsed head's M layer
    g3 = np.random.RandomState(6).randn(3, BI, W0).astype(np.float32)
    mg = pw.s1_m_layer(to(g3), to(M))
    check("M layer (M g, M gp, M gq)", mg, g3.astype(np.float64) @ M.astype(np.float64))
    vs_plain([mg], [pw.s1_m_layer_plain(to(g3), to(M))])

    # 4. the fixed-order row sum of partial rows
    part = np.random.RandomState(7).randn(N_REFS, BI * (2 + W0)).astype(np.float32)
    rows = pw.sum_rows(to(part))
    check("fixed-order row sum", rows, part.astype(np.float64).sum(0))
    vs_plain([rows], [pw.sum_rows_plain(to(part))])

    # 5. K7 and K8, the refs unsplit, against their plain versions
    args = (tm, to(M), to(u), "tanh", to(axs), to(avs), to(ars), to(mask))
    fwd = _flat(pw.s1_packed_sums(*args))
    fwd_plain = _flat(pw.mlp_pairwise_sums_packed_plain(*args))
    for key, k_, p_ in zip(("value", "hess", "s_dz0"), fwd, fwd_plain):
        check(f"fwd[{key}] kernel vs plain", k_, np.asarray(p_.double().cpu()), TOL_KERNEL)
    vs_plain(fwd, fwd_plain)
    cot = (to(gv), to(gh), to(gd))
    bwd = _flat(pw.s1_packed_sums_bwd(*args, *cot))
    bwd_plain = _flat(pw.mlp_pairwise_sums_packed_bwd_plain(*args, *cot))
    for idx, (k_, p_) in enumerate(zip(bwd, bwd_plain)):
        check(f"bwd[{idx}] kernel vs plain", k_, np.asarray(p_.double().cpu()), TOL_KERNEL)
    vs_plain(bwd, bwd_plain)
    print("DIAG", "OK" if state["ok"] else "MISMATCH", flush=True)
    return state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return 0 if run(parser.parse_args(argv).device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
