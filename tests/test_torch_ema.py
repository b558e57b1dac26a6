"""The port's EMA (pde_inverse_torch/training/trainer.py) against optax.ema
driven as the JAX trainer drives it (pde_inverse_tpu/training/trainer.py:
reset to the live parameters at ``ema_switch_step``, ``ema.update`` every
step from then on, the live parameters replaced by the average in "switch"
mode, the average tested and returned in "track" mode), on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_torch.training import trainer

torch.set_num_threads(1)

# the same f32 arithmetic ((1 - d) p + d e) on both sides
ATOL = 1e-7
SHAPES = {"w": (3, 2), "b": (2,)}


def _ocfg(mode, switch, decay=0.9, use_ema=True):
    base = config_lib.Config().train.optimizer
    return dataclasses.replace(base, use_ema=use_ema, ema_mode=mode,
                               ema_switch_step=switch, ema_decay=decay)


def _updates(n_steps, seed=0):
    rs = np.random.default_rng(seed)
    return [{k: rs.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(n_steps)]


def _jax_run(ocfg, p0, updates):
    """The JAX trainer's EMA branch, step by step: (live params after each
    step, EmaState after each step)."""
    ema = optax.ema(ocfg.ema_decay)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    es = ema.init(params)
    out = []
    for step, u in enumerate(updates):
        params = {k: params[k] + u[k] for k in params}
        if ocfg.use_ema and step >= ocfg.ema_switch_step:
            if step == ocfg.ema_switch_step:
                es = optax.EmaState(count=jnp.zeros([], jnp.int32), ema=params)
            _, es = ema.update(params, es)
            if ocfg.ema_mode != "track":
                params = es.ema
        out.append((params, es.ema))
    return out


def _torch_run(ocfg, p0, updates):
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    ema = {k: torch.zeros_like(v) for k, v in params.items()}
    out = []
    for step, u in enumerate(updates):
        params = {k: params[k] + torch.from_numpy(u[k]) for k in params}
        params, ema = trainer.ema_step(ocfg, params, ema, step)
        out.append((params, ema))
    return out


@pytest.mark.parametrize("mode", ["switch", "track"])
@pytest.mark.parametrize("switch", [0, 3, 20])
def test_ema_matches_optax_as_the_jax_trainer_drives_it(mode, switch):
    ocfg = _ocfg(mode, switch)
    p0, updates = _updates(1, seed=1)[0], _updates(9)
    live = {k: torch.from_numpy(v) for k, v in p0.items()}
    for step, ((jp, je), (tp, te)) in enumerate(zip(_jax_run(ocfg, p0, updates),
                                                     _torch_run(ocfg, p0, updates))):
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=ATOL)
            np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), rtol=0, atol=ATOL)
        live = {k: live[k] + torch.from_numpy(updates[step][k]) for k in SHAPES}
        if step == switch:  # reset at the switch: the first average is the live iterate
            assert all(torch.allclose(te[k], live[k], rtol=0, atol=1e-6) for k in SHAPES)
        live = tp
        # the evaluated parameters after step + 1 steps (trainer.py:219-225)
        want = je if (mode == "track" and step + 1 > switch) else jp
        got = trainer.eval_params(ocfg, tp, te, step + 1)
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL)


def test_ema_off_leaves_params_alone():
    ocfg = _ocfg("switch", 0, use_ema=False)
    p = {"w": torch.ones(2)}
    e = {"w": torch.zeros(2)}
    assert trainer.ema_step(ocfg, p, e, 5) == (p, e)
    assert trainer.eval_params(ocfg, p, e, 5) is p


class _StubMethod:
    """Fixed gradients per step, no data; records the parameters tested."""

    def __init__(self):
        self.tested = []

    def value_and_grad_fn(self, forward_fn, params, key, step=None):
        g = torch.full((2,), float(step + 1))
        return {"loss": torch.tensor(1.0), "grad": {"w": g}}

    def test_fn(self, forward_fn, params, key):
        self.tested.append(params["w"].clone())
        return {}


@pytest.mark.parametrize("mode", ["switch", "track"])
def test_trainer_tests_and_returns_the_evaluated_params(mode):
    cfg = config_lib.preset("KGMM", [
        "train.number_of_iterations=6", "train.steps_per_chunk=2", "test.frequency=2",
        "train.optimizer.use_ema=True", f"train.optimizer.ema_mode={mode}",
        "train.optimizer.ema_switch_step=2", "train.optimizer.ema_decay=0.5",
        "train.optimizer.learning_rate.scheduling=None",
    ])
    method = _StubMethod()
    t = trainer.Trainer(cfg, method, 0, None, {"w": torch.zeros(2)})
    out = t.fit()
    # the same run written out: Adam on the stub's gradients, then the EMA
    opt = t.optimizer
    params, state = {"w": torch.zeros(2)}, opt.init({"w": torch.zeros(2)})
    ema = {"w": torch.zeros(2)}
    tested = []
    for step in range(6):
        updates, state = opt.update({"w": torch.full((2,), float(step + 1))}, state, params)
        params, ema = trainer.ema_step(cfg.train.optimizer, {"w": params["w"] + updates["w"]}, ema, step)
        if (step + 1) % 2 == 0:
            tested.append(trainer.eval_params(cfg.train.optimizer, params, ema, step + 1)["w"])
    assert len(method.tested) == 3
    for got, want in zip(method.tested, tested):
        assert torch.equal(got, want)
    assert torch.equal(out["w"], tested[-1])
    if mode == "track":  # the average differs from the live iterate once engaged
        assert not torch.equal(out["w"], params["w"])


def test_unknown_ema_mode_raises():
    cfg = config_lib.preset("KGMM", ["train.optimizer.ema_mode=polyak"])
    with pytest.raises(ValueError, match="ema_mode"):
        trainer.Trainer(cfg, _StubMethod(), 0, None, {"w": torch.zeros(2)})
