"""The initial weights of a PotentialMLP (the configuration's settings give
its widths), drawn by the benchmark from the seed on the device: flax's
he_normal Dense kernels, zero biases and N(0, scale^2) Fourier frequencies
(``reference/common.py::init_params``)."""

from benchmark.reference import common as c


def initial_params(settings: dict, seed: int, device):
    net = c.net_from_config({"settings": settings})
    return c.init_params(net, c.fold_in(seed, 0x5EED), device, settings["neural_network.fourier_scale"])
