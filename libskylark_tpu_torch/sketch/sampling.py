"""Sampling sketches UST (uniform) and NURST (non-uniform), port of
``libskylark_tpu/sketch/sampling.py``: pure coordinate selection, no
rescaling.

Without replacement, the S smallest of N counter-derived uniform keys
give a uniform S-subset (a stable argsort, as ``jnp.argsort`` is).
NURST draws S counter-derived f32 uniforms and selects by inverse CDF
over the normalized probabilities (an f64 cumulative sum, as the JAX
package computes it with x64 on): the same rows as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import sample
from .base import Dimension, SketchTransform, register_sketch

__all__ = ["UST", "NURST"]


@register_sketch
class UST(SketchTransform):
    """Uniform sampling transform, with or without replacement."""

    sketch_type = "UST"

    def __init__(
        self, n: int, s: int, context: SketchContext, replace: bool = True
    ):
        self.replace = bool(replace)
        super().__init__(n, s, context)
        self._seed = context.seed
        if self.replace:
            self._base = context.reserve(s)
        else:
            if s > n:
                raise ValueError(
                    f"cannot sample {s} of {n} without replacement"
                )
            self._base = context.reserve(n)

    def samples(self, device=None) -> torch.Tensor:
        """The S selected input coordinates (int32, deterministic)."""
        if self.replace:
            return sample(
                "uniform_int", self._seed, self._base, self.s,
                dtype=torch.int32, device=device, low=0, high=self.n - 1,
            )
        keys = sample("uniform", self._seed, self._base, self.n, device=device)
        return torch.argsort(keys, stable=True)[: self.s].to(torch.int32)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        idx = self.samples(A.device).long()
        if dim is Dimension.COLUMNWISE:
            if A.shape[0] != self.n:
                raise ValueError(
                    f"columnwise apply needs A with {self.n} rows, got "
                    f"{tuple(A.shape)}"
                )
            return A.index_select(0, idx)
        if A.shape[-1] != self.n:
            raise ValueError(
                f"rowwise apply needs A with {self.n} columns, got "
                f"{tuple(A.shape)}"
            )
        return A.index_select(A.ndim - 1, idx)

    def _param_dict(self):
        return {"replace": self.replace}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, replace=d.get("replace", True))


@register_sketch
class NURST(SketchTransform):
    """Non-uniform (weighted, with-replacement) row sampling transform
    (≙ python-skylark's NURST)."""

    sketch_type = "NURST"

    def __init__(self, n, s, context: SketchContext, probs):
        super().__init__(n, s, context)
        self.probs = np.asarray(probs, dtype=np.float64)
        if self.probs.shape != (n,):
            raise ValueError(f"probs must have shape ({n},), got {self.probs.shape}")
        if (self.probs < 0).any():
            raise ValueError("probs must be nonnegative")
        total = self.probs.sum()
        if total <= 0:
            raise ValueError("probs must sum to a positive value")
        self.probs = self.probs / total
        self._seed = context.seed
        self._base = context.reserve(s)

    def samples(self, device=None) -> torch.Tensor:
        """The S selected input coordinates (int32, deterministic)."""
        u = sample("uniform", self._seed, self._base, self.s, dtype=torch.float32,
                   device=device)
        cdf = torch.as_tensor(np.cumsum(self.probs), device=u.device)
        idx = torch.searchsorted(cdf, u.to(cdf.dtype))
        return torch.clamp(idx, 0, self.n - 1).to(torch.int32)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        idx = self.samples(A.device).long()
        if dim is Dimension.COLUMNWISE:
            return A.index_select(0, idx)
        return A.index_select(A.ndim - 1, idx)

    def _param_dict(self):
        return {"probs": self.probs.tolist()}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, probs=d["probs"])
