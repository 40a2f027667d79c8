"""The flagship forward step: a Gaussian random-feature kernel machine,
the counterpart of the JAX package's ``__graft_entry__.entry``.

``GaussianKernel(128, sigma=2.0).create_rft(512, "regular",
SketchContext(seed=17))`` maps X (256, 128) to its random features Z
(256, 512), and the step returns the decision values ``Z @ W`` (256,
10).  X and W are the same numpy draws (``default_rng(0)``) as the JAX
entry's, so the two steps agree to f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.context import SketchContext
from .ml.kernels import GaussianKernel

__all__ = ["entry"]


def entry(device=None):
    """``(forward, (X, W))``: the forward step and its example inputs on
    ``device`` (the default device when None)."""
    d, s, k = 128, 512, 10
    fmap = GaussianKernel(d, sigma=2.0).create_rft(s, "regular", SketchContext(seed=17))

    def forward(X, W):
        Z = fmap.apply(X, "rowwise")  # (n, s) random features
        return Z @ W                  # (n, k) decision values

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((256, d)), dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.standard_normal((s, k)) * 0.01, dtype=torch.float32, device=dev)
    return forward, (X, W)
