"""Label coding for classification (port of
``libskylark_tpu/ml/coding.py``): class labels → a ±1 one-vs-all coding
matrix, and the argmax decode back to the labels."""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["dummy_coding", "decode_labels"]


def host_labels(y) -> np.ndarray:
    """Labels as a numpy array (a tensor is copied from its device)."""
    return y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def label_dtype(X: torch.Tensor) -> torch.dtype:
    """The dtype of a coding matrix for features X: X's floating dtype
    promoted to at least f32."""
    dt = X.dtype if X.is_floating_point() else torch.float32
    return torch.promote_types(dt, torch.float32)


def dummy_coding(y, classes=None, dtype=None, device=None):
    """y (n,) labels → (T, classes): T (n, k) with +1 for the true class
    and −1 elsewhere; ``classes`` sorted (explicit ones are sorted and
    checked).  ``dtype`` defaults to torch's default float."""
    y = host_labels(y)
    if classes is None:
        classes = np.unique(y)
    else:
        classes = np.unique(np.asarray(classes))
        missing = np.setdiff1d(np.unique(y), classes)
        if missing.size:
            raise ValueError(f"labels {missing.tolist()} not in classes")
    idx = np.searchsorted(classes, y)
    T = -np.ones((len(y), len(classes)))
    T[np.arange(len(y)), idx] = 1.0
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return torch.as_tensor(T, dtype=dtype, device=resolve_device(device)), classes


def decode_labels(O, classes):
    """(n, k) outputs → (n,) labels by argmax (the first maximum wins)."""
    O = torch.as_tensor(O)
    idx = torch.argmax(O, dim=-1)
    return torch.as_tensor(np.asarray(classes), device=O.device)[idx]
