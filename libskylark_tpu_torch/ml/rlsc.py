"""Regularized least-squares classification (port of
``libskylark_tpu/ml/rlsc.py``, ≙ ``ml/rlsc.hpp:45-311``).

Each RLSC solver is its KRR counterpart on dummy-coded ±1 labels
(``ml/coding.py``), with argmax decoding at predict time.  Returned
models carry ``.classes`` for decoding.  The coding matrix lies on X's
device in X's dtype promoted to at least f32: f32 for f32 and bf16 X
(the JAX package's default float without x64), f64 for f64 X (its
default with x64).
"""

from __future__ import annotations

from .._device import as_tensor
from .coding import dummy_coding, label_dtype
from .kernels import Kernel
from .krr import (
    approximate_kernel_ridge,
    faster_kernel_ridge,
    kernel_ridge,
    sketched_approximate_kernel_ridge,
)

__all__ = [
    "kernel_rlsc",
    "approximate_kernel_rlsc",
    "sketched_approximate_kernel_rlsc",
    "faster_kernel_rlsc",
]


def _classify(train_fn):
    def wrapper(kernel: Kernel, X, y, lam: float, *args, device=None, **kwargs):
        X = as_tensor(X, device)
        T, classes = dummy_coding(y, dtype=label_dtype(X), device=X.device)
        model = train_fn(kernel, X, T, lam, *args, **kwargs)
        model.classes = classes.tolist()
        return model

    wrapper.__name__ = wrapper.__qualname__ = train_fn.__name__.replace("ridge", "rlsc")
    wrapper.__doc__ = (f"{train_fn.__name__} on ±1 dummy-coded labels y (n,); the "
                       "model's ``.classes`` decodes its argmax.")
    return wrapper


# ≙ KernelRLSC / ApproximateKernelRLSC / SketchedApproximateKernelRLSC /
# FasterKernelRLSC (rlsc.hpp:45-311).
kernel_rlsc = _classify(kernel_ridge)
approximate_kernel_rlsc = _classify(approximate_kernel_ridge)
sketched_approximate_kernel_rlsc = _classify(sketched_approximate_kernel_ridge)
faster_kernel_rlsc = _classify(faster_kernel_ridge)
