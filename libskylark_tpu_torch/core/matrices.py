"""Deterministic random matrices (port of ``libskylark_tpu/core/matrices.py``).

The matrix is a pure function of ``(seed, base)``: every entry comes from
the context's counter stream through ``core.random.sample_window``, so it
is bitwise the JAX package's for integer draws and within an ulp for the
transcendental ones, wherever it is generated.
"""

from __future__ import annotations

from typing import Any

import torch

from .context import SketchContext
from .random import sample_window

__all__ = ["random_matrix", "gaussian_matrix", "uniform_matrix"]


def random_matrix(ctx: SketchContext, shape: tuple[int, int], dist: str = "normal",
                  dtype=torch.float32, device=None, **params: Any) -> torch.Tensor:
    """Draw a (rows, cols) matrix from the context's stream, advancing it."""
    rows, cols = shape
    base = ctx.reserve(rows * cols)
    return sample_window(dist, ctx.seed, base, (rows, cols), dtype=dtype,
                         device=device, **params)


def gaussian_matrix(ctx, shape, dtype=torch.float32, mean=0.0, stddev=1.0, device=None):
    x = random_matrix(ctx, shape, "normal", dtype=dtype, device=device)
    if mean != 0.0 or stddev != 1.0:
        x = x * stddev + mean
    return x


def uniform_matrix(ctx, shape, dtype=torch.float32, low=0.0, high=1.0, device=None):
    return random_matrix(ctx, shape, "uniform", dtype=dtype, device=device,
                         low=low, high=high)
