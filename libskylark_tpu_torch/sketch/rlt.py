"""Random Laplace feature maps for semigroup kernels, port of
``libskylark_tpu/sketch/rlt.py``.

ExpSemigroupRLT: ``Z = √(1/S) · exp(−(β²/2)·W·X)`` with W standard Lévy
(a ``DenseSketch`` scaled by β²/2): features of the exponential
semigroup kernel k(x, y) = exp(−β Σ_i √(x_i + y_i)) on histograms
(non-negative inputs).  ExpSemigroupQRLT takes W from a leaped Halton
sequence through the Lévy inverse CDF ``1/ndtri(u/2)²``, in the input's
dtype as in the JAX package, and consumes no counters.
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.quasirand import LeapedHaltonSequence
from ..core.random import _const
from .base import Dimension, SketchTransform, register_sketch
from .dense import DenseSketch

__all__ = ["ExpSemigroupRLT", "ExpSemigroupQRLT"]


class _UnderlyingLevy(DenseSketch):
    dist = "levy"


@register_sketch
class ExpSemigroupRLT(SketchTransform):
    """Z = √(1/S) · exp(−(β²/2)·(W·X)), W ~ standard Lévy."""

    sketch_type = "ExpSemigroupRLT"

    def __init__(self, n: int, s: int, context: SketchContext, beta: float = 1.0):
        super().__init__(n, s, context)
        self.beta = float(beta)
        self.outscale = math.sqrt(1.0 / s)
        self._underlying = _UnderlyingLevy(n, s, context,
                                           scale=self.beta * self.beta / 2.0)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        WX = self._underlying.apply(A, Dimension.of(dim), device=device)
        # WX is this apply's own temporary: negate, exp and scale in place.
        WX.neg_().exp_()
        return WX.mul_(_const(self.outscale, WX.dtype, WX.device))

    def _param_dict(self):
        return {"beta": self.beta}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, beta=d["beta"])


def _levy_quantile(u: torch.Tensor) -> torch.Tensor:
    """Standard Lévy inverse CDF: F(x) = erfc(1/√(2x)) ⇒ x = 1/ndtri(u/2)²."""
    z = torch.special.ndtri(u / _const(2.0, u.dtype, u.device))
    return torch.div(_const(1.0, u.dtype, u.device), z * z)


@register_sketch
class ExpSemigroupQRLT(SketchTransform):
    """QMC variant: Z = √(1/S) · exp(−W·X), W = (β²/2)·LévyInvCDF(U), U
    a window of the N-dimensional Halton sequence (≙
    ``ExpSemigroupQRLT_data_t``)."""

    sketch_type = "ExpSemigroupQRLT"

    def __init__(self, n: int, s: int, context: SketchContext, beta: float = 1.0,
                 skip: int = 0):
        super().__init__(n, s, context)
        self.beta = float(beta)
        self.skip = int(skip)
        self.outscale = math.sqrt(1.0 / s)
        self._sequence = LeapedHaltonSequence(n)

    def realize(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """W (S, N) in ``dtype``."""
        U = self._sequence.window(self.skip, self.s, dtype=dtype, device=device)
        return _const(self.beta * self.beta / 2.0, dtype, U.device) * _levy_quantile(U)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *, device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if not A.is_floating_point():
            A = A.to(torch.float32)
        W = self.realize(A.dtype, A.device)
        WX = torch.matmul(W, A) if dim is Dimension.COLUMNWISE else torch.matmul(A, W.T)
        WX.neg_().exp_()
        return WX.mul_(_const(self.outscale, WX.dtype, WX.device))

    def _param_dict(self):
        return {"beta": self.beta, "skip": self.skip}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, beta=d["beta"], skip=d.get("skip", 0))
