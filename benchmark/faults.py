"""Faults planted in the program for the tests that hold the check to them:
each patches one method of ``pde_inverse_torch`` through pytest's
``monkeypatch``, so that the run or the comparison that follows must read
not correct.

- ``unchanged_state``: the optimizer's updates are zeros, so the
  parameters never move;
- ``half_batch``: every sampled array but the times keeps only its first
  half;
- ``altered_answer``: the first leaf's gradient is 10 % too large.
"""

import torch


def unchanged_state(monkeypatch):
    from pde_inverse_torch.training import optimizers
    update = optimizers.Optimizer.update

    def no_step(self, grads, state, params):
        updates, new_state = update(self, grads, state, params)
        return {k: torch.zeros_like(u) for k, u in updates.items()}, new_state

    monkeypatch.setattr(optimizers.Optimizer, "update", no_step)


def half_batch(monkeypatch):
    from pde_inverse_torch import methods
    sample = methods.ConsistencyBased.sample_data

    def half(self, key, *a, **kw):
        out = sample(self, key, *a, **kw)
        return {k: (v if k.startswith("tau") else v[: v.shape[0] // 2]) for k, v in out.items()}

    monkeypatch.setattr(methods.ConsistencyBased, "sample_data", half)


def altered_answer(monkeypatch):
    from pde_inverse_torch import methods
    step = methods.ConsistencyBased.value_and_grad_fn

    def altered(self, *a, **kw):
        out = step(self, *a, **kw)
        first = next(iter(out["grad"]))
        out["grad"][first] = out["grad"][first] * 1.1
        return out

    monkeypatch.setattr(methods.ConsistencyBased, "value_and_grad_fn", altered)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
