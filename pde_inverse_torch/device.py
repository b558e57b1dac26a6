"""Device resolution.

The port names its device explicitly everywhere.  No device means CUDA,
and a request for CUDA on a machine without it raises instead of silently
running on the CPU: only an explicit ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name: Optional[str] = None) -> torch.device:
    """torch.device for `name` ("cpu", "cuda", "cuda:1", ...).

    None means "cuda".  Raises RuntimeError when a CUDA device is requested
    (or implied) but absent.
    """
    if name is None or name == "":
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def setup_precision() -> None:
    """Full f32 everywhere: TF32 off for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
