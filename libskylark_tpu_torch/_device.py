"""The port's device rule.

Public entry points take ``device=`` and default to ``"cuda"``
(changeable with :func:`set_default_device`).  A tensor argument is
computed where it lies; a numpy (or other array-like) argument moves to
the requested device.  Asking for CUDA where there is none raises: the
port never falls back to the CPU on its own.  Only CPU tensors take the
plain versions of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["set_default_device", "resolve_device", "as_tensor"]

# TF32 is the H100's form of the bf16 truncation the reference guards
# against on the TPU MXU (``sketch/fut.py`` pins precision="highest",
# ``core/precision.py`` splits f32 into exact bf16 parts): a TF32 matmul
# keeps ~10 mantissa bits and would silently degrade every f32 product
# of the port (the WHT factors, the hash one-hot contractions, the
# small least-squares solve).  Turned off once, here, at import.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEFAULT_DEVICE = "cuda"


def set_default_device(device) -> None:
    """Device that numpy inputs move to when a call names none."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = str(torch.device(device))


def resolve_device(device=None) -> torch.device:
    dev = torch.device(device if device is not None else _DEFAULT_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (or set_default_device('cpu')) to run "
            "the plain versions"
        )
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays where it lies; anything else becomes a tensor on
    ``device`` (the default device when None)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
