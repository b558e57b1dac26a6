"""The initial weights of a PotentialMLP with the PSD quadratic skip head
(the configuration's settings give its widths), drawn by the benchmark
from the seed on the device, in the program's leaf order: the Dense and
Fourier leaves as ``potential_mlp.py`` draws them, ``quad_A`` from
N(0, 0.1^2) and ``quad_b`` zeros, as the port's model draws them in kind
(``models/mlp.py``)."""

import torch

from benchmark.reference import common as c
from benchmark.reference.kgmm_offline import net_from_config


def initial_params(settings: dict, seed: int, device):
    net = net_from_config({"settings": settings})
    key = c.fold_in(seed, 0x5EED)
    body = c.init_params(net, key, device, settings["neural_network.fourier_scale"])
    d = net.dim
    quad_A = torch.randn((d, d), generator=c.generator(c.fold_in(key, 1), device), device=device) * 0.1
    head = {"quad_A": quad_A, "quad_b": torch.zeros((d,), device=device)}
    fourier = {k: v for k, v in body.items() if k == "fourier_B"}
    return {**fourier, **head, **{k: v for k, v in body.items() if k != "fourier_B"}}
