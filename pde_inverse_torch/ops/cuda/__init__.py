"""Hand-written CUDA kernels for Hopper (sm_90a) and their Python wrappers.

Each wrapper launches its kernel for CUDA tensors and uses the kernel's
plain PyTorch version for CPU tensors only.  Sources live in
``pde_inverse_torch/csrc``; they are compiled with ``nvcc`` at first use
(``build.py``), never at import.
"""

import torch


def device_index(t: torch.Tensor) -> int:
    """The index of the CUDA device `t` lies on."""
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def current_stream(index: int) -> int:
    """The current stream of CUDA device `index`, as an int for ctypes: the
    stream PyTorch's own kernels launch on, by its raw-stream query (no
    ``torch.cuda.Stream`` object is built)."""
    return torch._C._cuda_getCurrentRawStream(index)
