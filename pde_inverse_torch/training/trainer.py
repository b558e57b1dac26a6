"""Chunked training loop (counterpart of pde_inverse_tpu/training/trainer.py).

Steps run eagerly in chunks of ``train.steps_per_chunk``; per-step scalar
metrics stay on the device and are brought to the host once per chunk (one
sync), where the NaN guard checks them and the writer logs them.  Test,
timing and the end-of-run test follow the JAX trainer: periodic events fire
when a chunk crosses a multiple of their frequency (``cadence_fires``), and
steps/s is measured from the end of the first chunk.

Step s draws its data from ``fold_in(train_key, s)`` and the test at step
s from ``fold_in(test_key, s)``: every stream is derivable from (seed, step).

Offline, every step gets the problem's dataset; with offline streaming the
method gathers each chunk's trajectory batches on the host from the
chunk's step keys (``gather_stream_chunk``), the trainer uploads them once
as [K, ...] tensors and hands step i its slice.  ``gather_seconds`` keeps
the host time of each chunk's gather, ``gather_bytes`` the bytes it stages.

EMA (``train.optimizer.use_ema``) follows the JAX trainer: the average
starts at zeros, is reset to the live parameters at ``ema_switch_step``
and from then on is updated after every optimizer step as
``(1 - decay) p + decay ema``.  In "switch" mode the live parameters are
replaced by the average each step; in "track" mode training keeps its full
dynamics and the average is a decoupled Polyak average, which is what the
test and the returned parameters use once engaged.

Each phase runs in a ``tracing.span`` (``pde.step``, ``pde.optimizer``,
``pde.gather``, ``pde.upload``, ``pde.sync``, ``pde.writer``, ``pde.test``;
the method adds
``pde.sample`` and ``pde.loss_grad``, the SDE simulator ``pde.langevin`` and
the kinetic Fokker-Planck loss ``pde.kfp_path`` and ``pde.kfp_boundary``
inside them), which marks it in a profiler's trace and costs one flag check
otherwise.  With ``backend.profile_dir`` set, the
second chunk (the first if it is the only one) runs under
``torch.profiler`` and its chrome trace goes to ``<profile_dir>/trace.json``.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pde_inverse_torch.config import Config, OptimizerConfig
from pde_inverse_torch import rng
from pde_inverse_torch.ops.autodiff import pytree_l2_norm
from pde_inverse_torch.tracing import profile_to, span
from pde_inverse_torch.training.metrics import MetricWriter, NullWriter
from pde_inverse_torch.training.optimizers import Optimizer, apply_updates, get_optimizer


def cadence_fires(prev_step: int, step: int, frequency: int) -> bool:
    """True iff some absolute step s in (prev_step, step] is a multiple of
    ``frequency`` (chunked training crosses multiples rather than hitting
    them)."""
    if frequency <= 0:
        return False
    return step // frequency > prev_step // frequency


def ema_step(ocfg: OptimizerConfig, params, ema, step: int):
    """(params, ema) after the optimizer update of step `step` (0-based):
    from ``ema_switch_step`` on, the average is reset to `params` at the
    switch and then updated; "switch" mode replaces the live parameters by
    it."""
    if not ocfg.use_ema or step < ocfg.ema_switch_step:
        return params, ema
    if step == ocfg.ema_switch_step:
        ema = params
    d = ocfg.ema_decay
    ema = {k: (1 - d) * p + d * ema[k] for k, p in params.items()}
    return (ema if ocfg.ema_mode == "switch" else params), ema


def eval_params(ocfg: OptimizerConfig, params, ema, at_step: int):
    """Parameters to test and return after `at_step` steps: the tracked
    average once engaged (ema_mode=track), the live ones otherwise (in
    "switch" mode the live parameters are the average past the switch)."""
    if ocfg.use_ema and ocfg.ema_mode == "track" and at_step > ocfg.ema_switch_step:
        return ema
    return params


class Trainer:
    def __init__(
        self,
        cfg: Config,
        method,
        key: int,
        forward_fn: Callable,
        params: Dict[str, torch.Tensor],
        optimizer: Optional[Optimizer] = None,
        writer: Optional[MetricWriter] = None,
    ):
        self.cfg = cfg
        self.method = method
        self.train_key, self.test_key = rng.split(key, 2)
        self.forward_fn = forward_fn
        self.params = params
        self.optimizer = optimizer or get_optimizer(cfg.train.optimizer)
        self.writer = writer or NullWriter()
        self.losses = np.zeros((0,), np.float32)  # every step's loss
        self.gather_seconds: list = []  # host time of each chunk's streaming gather
        self.gather_bytes: list = []  # bytes each chunk's streaming gather stages
        self.test_metrics: Dict[str, float] = {}  # the last test's
        ocfg = cfg.train.optimizer
        if ocfg.ema_mode not in ("switch", "track"):
            raise ValueError(
                f"train.optimizer.ema_mode must be 'switch' or 'track', got {ocfg.ema_mode!r}"
            )

    def _step(self, params, opt_state, ema, step: int, dataset=None, stream_batch=None):
        kwargs = {} if dataset is None else {"dataset": dataset}
        if stream_batch is not None:
            kwargs["stream_batch"] = stream_batch
        out = self.method.value_and_grad_fn(
            self.forward_fn, params, rng.fold_in(self.train_key, step), step=step, **kwargs
        )
        grad = out.pop("grad")
        with span("optimizer"):
            updates, opt_state = self.optimizer.update(grad, opt_state, params)
            params = apply_updates(params, updates)
            params, ema = ema_step(self.cfg.train.optimizer, params, ema, step)
            out["params_norm"] = pytree_l2_norm(params)
        return params, opt_state, ema, out

    def fit(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        n_iters = cfg.train.number_of_iterations
        k = min(cfg.train.steps_per_chunk, n_iters)
        params = self.params
        opt_state = self.optimizer.init(params)
        ema = {k: torch.zeros_like(v) for k, v in params.items()}

        inst = getattr(self.method, "pde_instance", None)
        dataset = getattr(inst, "dataset", None)
        stream = getattr(inst, "dataset_stream", None)
        step = 0
        t_start = time.perf_counter()
        warm_step, warm_time = None, None
        # backend.profile_dir traces the second chunk (the first if it is the only one)
        profiled_step = k if n_iters > k else 0
        while step < n_iters:
            profiling = cfg.backend.profile_dir and step == profiled_step
            with profile_to(cfg.backend.profile_dir) if profiling else nullcontext():
                this_k = min(k, n_iters - step)
                batches = None
                if stream is not None:
                    with span("gather"):
                        t0 = time.perf_counter()
                        host = self.method.gather_stream_chunk(
                            stream, [rng.fold_in(self.train_key, s) for s in range(step, step + this_k)])
                        self.gather_seconds.append(time.perf_counter() - t0)
                        self.gather_bytes.append(sum(v.nbytes for v in host.values()))
                    with span("upload"):
                        batches = {name: torch.from_numpy(v).to(inst.device) for name, v in host.items()}
                chunk = []
                for s in range(step, step + this_k):
                    sb = None if batches is None else {n: v[s - step] for n, v in batches.items()}
                    with span("step", s):
                        params, opt_state, ema, out = self._step(params, opt_state, ema, s, dataset, sb)
                    chunk.append(out)
                names = list(chunk[0])
                # one host sync per chunk: [metrics, K] in a single copy
                with span("sync"):
                    stacked = torch.stack(
                        [torch.stack([out[n].detach().float() for out in chunk]) for n in names]
                    ).cpu().numpy()
                host_metrics = dict(zip(names, stacked))
                prev_step, step = step, step + this_k
                if warm_step is None:
                    warm_step, warm_time = step, time.perf_counter()

                with span("writer"):
                    loss = host_metrics["loss"]
                    self.losses = np.concatenate([self.losses, loss])
                    if not np.isfinite(loss).all():
                        bad = int(np.argmax(~np.isfinite(loss)))
                        raise FloatingPointError(f"non-finite loss at step {prev_step + bad}")
                    self.writer.log_chunk(host_metrics, first_step=prev_step)

                # the final chunk always tests
                if cadence_fires(prev_step, step, cfg.test.frequency) or step >= n_iters:
                    with span("test"):
                        test = self.method.test_fn(
                            self.forward_fn,
                            eval_params(cfg.train.optimizer, params, ema, step),
                            rng.fold_in(self.test_key, step),
                        )
                        test = {name: float(v) for name, v in test.items()}
                        since_warm = step > warm_step
                        elapsed = time.perf_counter() - (warm_time if since_warm else t_start)
                        steps_done = step - (warm_step if since_warm else 0)
                        test["steps_per_sec"] = steps_done / max(elapsed, 1e-9)
                        self.test_metrics = test
                        self.writer.log(test, step=step)
                        if cfg.test.verbose:
                            msg = f"[step {step:6d} | {test['steps_per_sec']:8.1f} steps/s] "
                            msg += f"loss {loss[-1]:.3e} "
                            msg += " ".join(f"{n}={v:.3e}" for n, v in test.items())
                            print(msg)

        self.params = eval_params(cfg.train.optimizer, params, ema, step)
        return self.params
