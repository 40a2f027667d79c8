"""Prediction metrics (port of ``libskylark_tpu/ml/metrics.py``)."""

from __future__ import annotations

import torch

from .._device import as_tensor

__all__ = ["classification_accuracy", "mean_squared_error"]


def classification_accuracy(predictions, labels, *, device=None):
    """Percent of exact label matches (0..100), a 0-d f64 tensor: the
    count of matches times 100 over their number, exact where the JAX
    package takes an f32 mean."""
    p = as_tensor(predictions, device).reshape(-1)
    t = as_tensor(labels, p.device).reshape(-1).to(p.device)
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch: {tuple(p.shape)} vs {tuple(t.shape)}")
    return (p == t).sum(dtype=torch.float64) * 100.0 / p.numel()


def mean_squared_error(predictions, targets, *, device=None):
    p = as_tensor(predictions, device)
    t = as_tensor(targets, p.device).to(p.device)
    return torch.mean((p - t) ** 2)
