"""Consistency loss for the kinetic McKean-Vlasov equation (counterpart of
pde_inverse_tpu/losses/kinetic_mckean_vlasov.py).

The unknown is the interaction kernel Phi; the mean-field convolution
(Phi * rho_t)(x) = E_ref[Phi(x - ref)] is estimated with the path samples at
the same stamp.  With the weights
    w(s, x) = d2/ds2 log rho + (d/ds log rho)^2 + gamma d/ds log rho
from the Gaussian-path oracle, the loss is

    loss = E_{n,t} || E_ref grad Phi(x - ref) ||^2
         - 2 E_{n,t} E_ref [ v^T Hess Phi(x - ref) v ]
         + 2 E_{n,t} [ E_ref Phi(x - ref) * w(t, x) ]
         + E_{n,t} || E_ref grad Phi_true(x - ref) ||^2

and the gap E_{n,t} ||E_ref grad Phi_true - E_ref grad Phi||^2 comes from
the same statistics.  The model's mean-field statistics come from, in this
order: the exact per-stamp sufficient statistics for an exactly quadratic
model (``closed_form_quadratic``); the blockwise PotentialMLP reduction
(``losses.pairwise_blockwise``: kernels K5-K8 on CUDA); the generic chunked
reduction over the ref axis with per-pair autodiff, the truth the other two
are held to.  The true side uses the sufficient statistics whenever the
instance declares Phi_true quadratic.

The parameter gradient is taken with ``torch.autograd``: the kernels'
autograd Functions need device pointers in their backward, which tensors
under ``torch.func.grad`` do not have.

Only online grid_time batches (one shared stamp grid ``tau_0T``) are ported:
the offline per-trajectory and grouped stamps, tail-boost weights and the
``kmv_field_reg`` stabiliser raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import grad, jacfwd

from pde_inverse_torch import rng
from pde_inverse_torch.losses import pairwise_blockwise as bw
from pde_inverse_torch.ops import autodiff as ad

# Refs per chunk of the generic reduction, and the element budget that
# scales it down so that chunk * n * nt stays bounded.
REF_CHUNK = 512
_CHUNK_ELEMENT_BUDGET = 4_000_000


def _chunked_ref_sums(fn_stats: Callable, refs: torch.Tensor, chunk: int) -> Dict[str, torch.Tensor]:
    """Sums over the ref axis of fn_stats(ref_chunk [c, nt, d], mask [c]),
    chunk by chunk (the last one padded with masked zero refs).  The chunks
    bound the forward's working set; the autograd graph keeps every chunk
    (torch.utils.checkpoint does not compose with the per-pair torch.func
    derivatives), so this path is for small batches, as the truth of the
    blockwise one."""
    m = refs.shape[0]
    chunk = min(chunk, m)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    refs_p = torch.cat([refs, refs.new_zeros((pad, *refs.shape[1:]))]) if pad else refs
    mask = (torch.arange(n_chunks * chunk, device=refs.device) < m).to(refs.dtype)
    total = None
    for k in range(n_chunks):
        sl = slice(k * chunk, (k + 1) * chunk)
        stats = fn_stats(refs_p[sl], mask[sl])
        total = stats if total is None else {name: total[name] + s for name, s in stats.items()}
    return total


def _pairwise_stats(stats_flat: Callable, x, v, refs, chunk: int, params=None):
    """Mean over refs of flat per-pair statistics: stats_flat(params,
    diff_flat [C, d], v_flat [C, d]) -> dict of [C] or [C, d] with C =
    c * n * nt over (chunk, sample, stamp)."""
    m = refs.shape[0]
    n, nt, d = x.shape

    def fn_stats(ref_c, mask_c):
        c = ref_c.shape[0]
        diff_flat = (x[None] - ref_c[:, None]).reshape(-1, d)
        v_flat = v[None].expand(c, n, nt, d).reshape(-1, d)
        flat = stats_flat(params, diff_flat, v_flat)
        return {
            name: torch.tensordot(mask_c, s.reshape(c, n, nt, *s.shape[1:]), dims=([0], [0]))
            for name, s in flat.items()
        }

    sums = _chunked_ref_sums(fn_stats, refs, chunk)
    return {name: s / m for name, s in sums.items()}


def compute_weights(pde_instance, taus: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w(t, x) = d2s log rho + (ds log rho)^2 + gamma ds log rho: stamps
    taus [nt], x [n, nt, d] -> [n, nt]."""
    xt = x.transpose(0, 1)
    d1 = pde_instance.partial_s_log_density_fn(taus, xt)
    d2 = pde_instance.partial_s2_log_density_fn(taus, xt)
    return (d2 + d1 * d1 + pde_instance.gamma_friction * d1).T


def _quadratic_meanfield_stats(phi: Callable, x: torch.Tensor, v: torch.Tensor):
    """Exact mean-field statistics of an exactly quadratic kernel
    phi(y) = 1/2 y^T H y + g0.y + c over the refs (the samples at the same
    stamp), from per-stamp means mbar_t and covariance traces:

        E_r grad phi(x - r) = H (x - mbar_t) + g0,   E_r v^T Hess phi v = v^T H v,
        E_r phi(x - r) = 1/2 (x - mbar)^T H (x - mbar) + 1/2 tr(H S_t) + g0.(x - mbar) + c.

    (H, g0, c) are read off phi at 0 by autodiff, so gradients with respect
    to phi's parameters flow through them.  x, v [n, nt, d]."""
    n, nt, d = x.shape
    zero = torch.zeros((d,), dtype=x.dtype, device=x.device)
    c0 = phi(zero)
    g0 = grad(phi)(zero)
    H = jacfwd(grad(phi))(zero)
    mbar = torch.mean(x, dim=0)
    diffc = x - mbar
    trHS = torch.einsum("ntd,de,nte->t", diffc, H, diffc) / n
    nabla = torch.einsum("de,nte->ntd", H, diffc) + g0
    hess = torch.einsum("ntd,de,nte->nt", v, H, v)
    value = 0.5 * torch.einsum("ntd,de,nte->nt", diffc, H, diffc) + 0.5 * trHS[None, :] + diffc @ g0 + c0
    return {"nabla": nabla, "hess": hess, "value": value}


def _check_online(data) -> None:
    for key, what in (("tau_0T_groups", "offline grouped stamps"),
                      ("tau_0T_per_traj", "offline per-trajectory stamps")):
        if key in data:
            raise NotImplementedError(f"KMV with {what} is not ported yet: ROADMAP queue 1, item 17")
    if "w_0T" in data:
        raise NotImplementedError(
            "tail-boost KMV weights (w_0T) are not ported yet: ROADMAP queue 1, item 14"
        )
    if "tau_0T" not in data:
        raise ValueError("KMV loss needs time stamps: online grid_time sampling provides 'tau_0T'; "
                         f"got keys {sorted(data)}")


def make_loss_fn(
    forward_fn: Callable,
    data: Dict[str, torch.Tensor],
    pde_instance,
    ref_chunk: int = REF_CHUNK,
    closed_form_quadratic: bool = False,
    element_budget: int = _CHUNK_ELEMENT_BUDGET,
    blockwise_module=None,
    blockwise_rows: int = 0,
    pallas_mode: str = "auto",
):
    """loss_fn(params) -> (loss, gap) over the batch `data` ({"0T"
    [n * nt, 2d] laid out (sample, stamp), "tau_0T" [nt]})."""
    _check_online(data)
    x_0T, v_0T = torch.chunk(data["0T"], 2, dim=-1)
    d = x_0T.shape[-1]
    taus = data["tau_0T"]
    n_time = taus.shape[0]
    x = x_0T.reshape(-1, n_time, d)
    v = v_0T.reshape(-1, n_time, d)
    weights = compute_weights(pde_instance, taus, x)
    refs = x
    per_ref = max(1, x.shape[0] * n_time)
    ref_chunk = max(1, min(ref_chunk, element_budget // per_ref))

    Phi_true = pde_instance.Phi_true_fn
    if closed_form_quadratic or getattr(pde_instance, "phi_true_is_quadratic", False):
        mean_nabla_true = _quadratic_meanfield_stats(Phi_true, x, v)["nabla"]
    else:
        mean_nabla_true = _pairwise_stats(
            lambda _p, diff_flat, v_flat: {"nabla_true": ad.batched_grad(Phi_true, diff_flat)},
            x, v, refs, ref_chunk,
        )["nabla_true"]
    loss_nabla_true = torch.mean(torch.sum(mean_nabla_true ** 2, dim=-1))
    if blockwise_module is not None:
        bw.check_mode(pallas_mode)

    def model_stats(params):
        if closed_form_quadratic:
            return _quadratic_meanfield_stats(lambda xi: forward_fn(params, xi)[0], x, v)
        if blockwise_module is not None:
            kwargs = {"rows_per_chunk": blockwise_rows} if blockwise_rows > 0 else {}
            return bw.mlp_pairwise_stats(blockwise_module, params, x, v, refs,
                                         pallas_mode=pallas_mode, **kwargs)

        def stats_flat(params_l, diff_flat, v_flat):
            val, nabla, hess = ad.batched_value_grad_hvp_quadform(
                lambda xi: forward_fn(params_l, xi)[0], diff_flat, v_flat
            )
            return {"nabla": nabla, "hess": hess, "value": val}

        return _pairwise_stats(stats_flat, x, v, refs, ref_chunk, params=params)

    def loss_fn(params):
        stats = model_stats(params)
        loss_nabla = torch.mean(torch.sum(stats["nabla"] ** 2, dim=-1))
        loss_hessian = torch.mean(stats["hess"])
        loss_value = torch.mean(stats["value"] * weights)
        loss = loss_nabla - 2.0 * loss_hessian + 2.0 * loss_value + loss_nabla_true
        gap = torch.mean(torch.sum((mean_nabla_true - stats["nabla"]) ** 2, dim=-1))
        return loss, gap

    return loss_fn


def value_and_grad_fn(
    forward_fn: Callable,
    params,
    data,
    pde_instance,
    closed_form_quadratic: bool = False,
    element_budget: int = _CHUNK_ELEMENT_BUDGET,
    blockwise_module=None,
    blockwise_rows: int = 0,
    pallas_mode: str = "auto",
) -> Dict[str, object]:
    """{"loss", "grad" (dict like params), "grad_norm", "loss ground truth"}."""
    loss_fn = make_loss_fn(
        forward_fn, data, pde_instance,
        closed_form_quadratic=closed_form_quadratic,
        element_budget=element_budget,
        blockwise_module=blockwise_module,
        blockwise_rows=blockwise_rows,
        pallas_mode=pallas_mode,
    )
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss, gap = loss_fn(leaves)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return {
        "loss": loss.detach(),
        "grad": grads,
        "grad_norm": ad.pytree_l2_norm(grads),
        "loss ground truth": gap.detach(),
    }


def test_fn(
    forward_fn: Callable,
    pde_instance,
    key: int,
    batch_size: int = 10_000,
    n_times: int = 8,
) -> Dict[str, torch.Tensor]:
    """Relative L2 error of grad Phi over differences of exact path samples:
    n_times stamps t ~ U(1e-4, T], batch_size samples at each, each paired
    with a random permutation of all of them."""
    dev = pde_instance.device
    k_t, k_z, k_perm = rng.split(key, 3)
    ts = pde_instance.distribution_time.sample(n_times, rng.generator(k_t, dev))
    means, covs = pde_instance.oracle.moments_grid(ts)
    chols = torch.linalg.cholesky(covs)
    eps = torch.randn((batch_size, n_times, means.shape[-1]), generator=rng.generator(k_z, dev),
                      device=dev)
    z = torch.einsum("tij,ntj->nti", chols, eps) + means
    x = z[..., : pde_instance.dim].reshape(-1, pde_instance.dim)
    partner = torch.randperm(x.shape[0], generator=rng.generator(k_perm, dev), device=dev)
    diff = x - x[partner]
    pred = ad.batched_grad(lambda y: forward_fn(y)[0], diff)
    true = ad.batched_grad(pde_instance.Phi_true_fn, diff)
    rel = torch.sqrt(torch.mean(torch.sum((pred - true) ** 2, -1)) / torch.mean(torch.sum(true ** 2, -1)))
    return {"relative error of interaction gradient": rel}
