"""The port's non-parametric hypotheses (pde_inverse_torch/models/mlp.py)
against flax's on converted parameters, on the CPU.

Each flax module is initialised from a fixed key; its parameters go to the
port through ``convert.from_flax_params``.  Both evaluate V, grad V and the
Hessian quadform v^T Hess V v (forward-over-reverse autodiff in both) on the
same numpy-made points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_inverse_tpu import config as config_lib
from pde_inverse_tpu.models import mlp as jmlp
from pde_inverse_tpu.ops import autodiff as jad
from pde_inverse_torch.convert import from_flax_params
from pde_inverse_torch.methods import functional_forward
from pde_inverse_torch.models import mlp as tmlp
from pde_inverse_torch.models.factory import get_model
from pde_inverse_torch.ops import autodiff as tad

torch.set_num_threads(1)

# f32 evaluations of the same network in another operation order
# (tests/test_fused_pointwise.py's tolerances)
RTOL, ATOL = 2e-4, 1e-5
D = 3

# tests/test_fused_pointwise.py MLP_VARIANTS, plus softplus
VARIANTS = {
    "plain": {},
    "fourier": {"fourier_features": 6, "fourier_scale": 0.7},
    "quad_head": {"quadratic_head": True},
    "fourier+quad": {"fourier_features": 4, "quadratic_head": True},
    "silu": {"activation": "silu"},
    "softplus": {"activation": "softplus"},
}


def _pair(kind: str):
    """(flax module, its params as numpy, the port's module)."""
    if kind == "resnet":
        net = jmlp.ResNetPotential(hidden_dim=12, n_blocks=2, feature_dim=8)
        model = tmlp.ResNetPotential(D, hidden_dim=12, n_blocks=2, feature_dim=8)
    elif kind == "bilinear":
        net, model = jmlp.BilinearDebugPotential(), tmlp.BilinearDebugPotential(D)
    else:
        kw = VARIANTS[kind]
        net = jmlp.PotentialMLP(hidden_dims=[16, 16], feature_dim=8, **kw)
        model = tmlp.PotentialMLP(D, [16, 16], feature_dim=8, **kw)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(D))
    return net, jax.tree_util.tree_map(np.asarray, params), model


def _points(n=24, seed=1):
    rs = np.random.default_rng(seed)
    return (rs.normal(size=(n, D)) * 1.5).astype(np.float32), rs.normal(size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("kind", [*VARIANTS, "resnet", "bilinear"])
def test_value_grad_and_quadform_match_flax(kind):
    net, params_np, model = _pair(kind)
    params = from_flax_params(params_np)
    model.load_state_dict(params)  # every flax name maps onto a port parameter
    x, v = _points()
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    jV = lambda xi: net.apply(jp, xi)[0]
    j_val = np.asarray(net.apply(jp, jnp.asarray(x)))
    j_grad, j_quad = jad.batched_grad_and_hvp_quadform(jV, jnp.asarray(x), jnp.asarray(v))

    fwd = functional_forward(model)
    tV = lambda xi: fwd(params, xi)[0]
    t_val = fwd(params, torch.from_numpy(x))
    t_grad, t_quad = tad.batched_grad_and_hvp_quadform(tV, torch.from_numpy(x), torch.from_numpy(v))
    assert t_val.shape == (24,) and fwd(params, torch.from_numpy(x[0])).shape == (1,)
    np.testing.assert_allclose(t_val.detach().numpy(), j_val, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_quad.numpy(), np.asarray(j_quad), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", [*VARIANTS, "resnet", "bilinear"])
def test_parameter_names_and_shapes_match_flax(kind):
    _, params_np, model = _pair(kind)
    converted = from_flax_params(params_np)
    own = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in converted.items()} == {
        k: tuple(v.shape) for k, v in own.items()
    }
    # flax keeps fourier_B as [d, nf] and uses x @ B: not transposed
    if "fourier_B" in converted:
        np.testing.assert_array_equal(converted["fourier_B"].numpy(), params_np["params"]["fourier_B"])


def test_init_follows_flax_initialisers():
    gen = torch.Generator().manual_seed(0)
    model = tmlp.PotentialMLP(4, [256, 256], feature_dim=256, fourier_features=64,
                              fourier_scale=0.5, quadratic_head=True, generator=gen)
    w = model.Dense_1.weight.detach()  # he_normal: truncated normal, std sqrt(2 / fan_in)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(2.0 / 256) / 0.87962566103423978 + 1e-6
    assert float(w.std()) == pytest.approx(np.sqrt(2.0 / 256), rel=0.02)
    assert float(model.Dense_0.bias.abs().max()) == 0.0 and float(model.quad_b.abs().max()) == 0.0
    assert float(model.fourier_B.std()) == pytest.approx(0.5, rel=0.1)
    res = tmlp.ResNetPotential(4, hidden_dim=256, n_blocks=1, generator=gen)
    assert float(res.Dense_1.weight.std()) == pytest.approx(np.sqrt(1.0 / 256), rel=0.02)
    again = tmlp.PotentialMLP(4, [256, 256], feature_dim=256, fourier_features=64,
                              fourier_scale=0.5, quadratic_head=True,
                              generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


class _Problem:
    dim, device = 4, torch.device("cpu")


@pytest.mark.parametrize("overrides,cls", [
    ([], tmlp.PotentialMLP),
    (["neural_network.n_resblocks=2"], tmlp.ResNetPotential),
    (["neural_network.model=bilinear-debug"], tmlp.BilinearDebugPotential),
])
def test_factory_builds_the_configured_hypothesis(overrides, cls):
    cfg = config_lib.preset("KGMM-nonparametric-online", overrides)
    model = get_model(cfg, _Problem(), torch.Generator().manual_seed(1))
    assert type(model) is cls
    if cls is tmlp.PotentialMLP:  # the preset's widths: 4 + 2 * 64 -> 64 -> 64 -> 256
        assert model.Dense_0.weight.shape == (64, 132) and model.Dense_2.weight.shape == (256, 64)
        assert model.fourier_B.shape == (4, 64)


@pytest.mark.parametrize("overrides,item", [
    (["neural_network.model=fourier-kernel"], "item 20"),
    (["neural_network.dtype=bfloat16"], "item 27"),
])
def test_factory_refuses_what_is_not_ported(overrides, item):
    cfg = config_lib.preset("KGMM-nonparametric-online", overrides)
    with pytest.raises(NotImplementedError, match=item):
        get_model(cfg, _Problem(), torch.Generator().manual_seed(1))
