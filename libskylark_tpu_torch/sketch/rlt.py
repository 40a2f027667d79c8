"""Random Laplace feature maps for semigroup kernels, port of
``libskylark_tpu/sketch/rlt.py``.

ExpSemigroupRLT: ``Z = √(1/S) · exp(−(β²/2)·W·X)`` with W standard Lévy
(a ``DenseSketch`` scaled by β²/2): features of the exponential
semigroup kernel k(x, y) = exp(−β Σ_i √(x_i + y_i)) on histograms
(non-negative inputs).  The quasi-Monte-Carlo ExpSemigroupQRLT waits
for ``core/quasirand.py`` (ROADMAP Queue A).
"""

from __future__ import annotations

import math

from ..core.context import SketchContext
from ..core.random import _const
from .base import Dimension, SketchTransform, register_sketch
from .dense import DenseSketch

__all__ = ["ExpSemigroupRLT"]


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
