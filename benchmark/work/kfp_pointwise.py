"""The online non-parametric KGMM step's work: the pointwise provider over
the path points, the boundary points and the Langevin sampler.

* pointwise provider (PotentialMLP): per path point, over the chain from
  the first hidden layer, F = products of [h..., feature]: the forward
  streams value, gradient and Hessian form (4 F) and the VJP 10 F (4 forward
  products, 3 weight-gradient, 3 input-cotangent).
* Langevin sampler: per particle and step, Box-Muller 6 a coordinate, the
  GMM force's two passes k (8 d + 5) + d + 1, the update 10 d + 3, over
  n_steps + 1 steps; bytes: z0 and final state, phases, trajectory.
* the whole step: the provider's function, the first layer of the path
  points (6 products of its width), the boundary points' gradient and its
  parameter VJP (6 products of the whole network) and the sampler.
"""

from __future__ import annotations

from typing import Dict

from benchmark.work import hidden_widths, mlp_products


def pointwise_fmas(chain) -> Dict[str, int]:
    """FMAs a point of the forward and the VJP over `chain` (first hidden
    width to the feature width)."""
    f = mlp_products(chain)
    return {"forward": 4 * f, "vjp": 10 * f}


def langevin_work(n: int, n_steps: int, d: int, k: int, with_traj: bool):
    n_bytes = 4 * n * (2 * d + 2 * d + 1 + (n_steps * 2 * d if with_traj else 0))
    per_step = 6 * d + k * (8 * d + 5) + d + 1 + 10 * d + 3
    return n_bytes, float(n) * (n_steps + 1) * per_step


def cell_work(s: dict, problem: dict) -> Dict[str, dict]:
    d = s["pde_instance.domain_dim"]
    hidden = hidden_widths(s)
    feature, fourier = s["neural_network.feature_dim"], s["neural_network.fourier_features"]
    batch, n_steps = s["solver.train.batch_size_0T"], s["pde_instance.n_steps"]
    n_path = batch * len(range(0, n_steps, s["solver.train.path_stride"]))
    multiple, k = problem["boundary_multiple"], problem["n_components"]
    n_bnd = 2 * multiple * batch
    chain = [*hidden, feature]
    w0, w_in = hidden[0], d + 2 * fourier
    fm = pointwise_fmas(chain)
    pw_flops = 2.0 * n_path * (fm["forward"] + fm["vjp"])
    path = langevin_work(batch, n_steps, d, k, True)
    term = langevin_work(multiple * batch, n_steps, d, k, False)
    langevin = {"flops": path[1] + term[1], "bytes": float(path[0] + term[0])}
    whole = mlp_products([w_in, *chain])
    return {"pointwise": {"flops": pw_flops,
                          "bytes": 4.0 * n_path * ((3 * w0 + 1 + w0) + (7 * w0 + 1))},
            "langevin": langevin,
            "step": {"flops": pw_flops + 2.0 * n_path * 6 * w_in * w0
                     + 2.0 * n_bnd * 6 * whole + langevin["flops"]}}
