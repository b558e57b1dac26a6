"""The streamed offline non-parametric KGMM step's work: the pointwise
provider over the gathered path points, and the whole step.

* pointwise provider (PotentialMLP): per path point the forward's 4 F and
  the VJP's 10 F FMAs over the chain from the first hidden layer
  (``kfp_pointwise.pointwise_fmas``); bytes as there.  The path points are
  ``offline_traj_batch`` trajectories at every fifth of ``n_steps_0T``
  states.
* the whole step: the provider's function, the first layer of the path
  points (6 products of its width), the boundary points' gradient and its
  parameter VJP (6 products of the whole network) over the full initial
  and terminal sets, and the quadratic head at every point (6 d^2: A x or
  A v, A^T (A x), and their VJP).  The store is made in set-up, so no
  Langevin work is the step's.
* Langevin sampler (K1): the test's, every ``test.frequency`` steps, over
  a step: ``TEST_PROBES`` trajectories of ``pde_instance.n_steps`` BAOAB
  steps kept whole, and ``boundary_multiple`` times as many particles
  simulated to T (``losses/kinetic_fokker_planck.py::test_fn``); counted
  as ``kfp_pointwise.langevin_work`` counts the online step's.
"""

from __future__ import annotations

from typing import Dict

from benchmark.work import hidden_widths, mlp_products
from benchmark.work.kfp_pointwise import langevin_work, pointwise_fmas

STRIDE = 5  # the offline subsample's time stride
TEST_PROBES = 1024  # the test's simulated trajectories (test_fn's sde_probe_trajectories)


def cell_work(s: dict, problem: dict) -> Dict[str, dict]:
    d = s["pde_instance.domain_dim"]
    hidden = hidden_widths(s)
    feature, fourier = s["neural_network.feature_dim"], s["neural_network.fourier_features"]
    n_path = s["solver.train.offline_traj_batch"] * (s["pde_instance.n_steps_0T"] // STRIDE)
    n_bnd = s["pde_instance.sample_initial_size"] + s["pde_instance.sample_terminal_size"]
    chain = [*hidden, feature]
    w0, w_in = hidden[0], d + 2 * fourier
    fm = pointwise_fmas(chain)
    pw_flops = 2.0 * n_path * (fm["forward"] + fm["vjp"])
    whole = mlp_products([w_in, *chain])
    head = 2.0 * (n_path + n_bnd) * 6 * d * d if s["neural_network.quadratic_head"] else 0.0
    n_steps, k, every = s["pde_instance.n_steps"], problem["n_components"], s["test.frequency"]
    path = langevin_work(TEST_PROBES, n_steps, d, k, True)
    term = langevin_work(problem["boundary_multiple"] * TEST_PROBES, n_steps, d, k, False)
    return {"pointwise": {"flops": pw_flops,
                          "bytes": 4.0 * n_path * ((3 * w0 + 1 + w0) + (7 * w0 + 1))},
            "langevin": {"flops": (path[1] + term[1]) / every, "bytes": float(path[0] + term[0]) / every},
            "step": {"flops": pw_flops + 2.0 * n_path * 6 * w_in * w0 + 2.0 * n_bnd * 6 * whole + head}}
