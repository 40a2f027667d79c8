"""Fastfood feature maps (Le-Sarlós-Smola), port of the streaming form
of ``libskylark_tpu/sketch/frft.py``.

The dense Gaussian W of the RFT is replaced, per block of NB =
next_pow2(N) features, by ``Sm·H·G·Π·H·B``: B a Rademacher diagonal, Π a
permutation, G a Gaussian diagonal, H the orthonormal Walsh-Hadamard
transform, Sm the kernel's scaling (√NB/σ for the Gaussian kernel; times
``sqrt(2ν/χ²_{2ν})`` per row for Matérn); then
``Z = √(2/S)·cos(V·x + shift)``.  Counter budget in the reference's
order: S shifts, then B, G and Π (numblks·NB each), then Matérn's χ²
block.  Π is the stable argsort of counter-derived f32 uniform keys, as
``jnp.argsort`` sorts them: 24-bit keys tie often at NB = 4096, and an
unstable sort would give another permutation.

Routes, the same on the card and on the CPU:

- 2-D f32/bf16 input with NB in the RFUT kernels' range (128..2^15):
  each block is two ``kernels_fut.rfut_rowwise`` launches on the rowwise
  (batch, NB) layout, H·(B ⊙ x) and H·(G ⊙ Πy), with the permutation an
  ``index_select`` of columns between them (columnwise input is
  transposed in and out).  On the card that is two reads and writes of
  the batch per block instead of a Kronecker WHT's several.
- otherwise the JAX package's streaming form, with the Kronecker ``wht``
  over the (blocks, NB, batch) stack and the permutation an
  ``index_select`` per block.

The JAX package's realized-W route (``_realize_wins``) is gated to the
TPU and priced for a v5e; it waits for H100 numbers (ROADMAP Queue A).
Its f32 output is f32 here; the JAX package's streaming form returns
f64 for f32 input when x64 is on (its ``outscale`` is a numpy f64).
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import _const, sample
from . import kernels_fut
from .base import Dimension, SketchTransform, register_sketch
from .fut import next_pow2, wht
from .rft import _TWO_PI, check_two_nu, matern_scales

__all__ = ["FastRFT", "FastGaussianRFT", "FastMaternRFT"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class FastRFT(SketchTransform):
    """Base Fastfood engine; subclasses set the Sm scaling."""

    def __init__(self, n: int, s: int, context: SketchContext):
        super().__init__(n, s, context)
        self._seed = context.seed
        self._nb = next_pow2(n)
        self.numblks = 1 + (s - 1) // self._nb
        self.outscale = math.sqrt(2.0 / s)
        self._shift_base = context.reserve(s)
        self._b_base = context.reserve(self.numblks * self._nb)
        self._g_base = context.reserve(self.numblks * self._nb)
        self._p_base = context.reserve(self.numblks * self._nb)

    # -- counter-derived pieces --------------------------------------------

    def _shifts(self, dtype, device):
        return sample("uniform", self._seed, self._shift_base, self.s, dtype=dtype,
                      device=device, low=0.0, high=_TWO_PI)

    def _blocks(self, dist: str, base: int, dtype, device):
        return sample(dist, self._seed, base, self.numblks * self._nb, dtype=dtype,
                      device=device).reshape(self.numblks, self._nb)

    def _perms(self, device):
        keys = self._blocks("uniform", self._p_base, torch.float32, device)
        return torch.argsort(keys, dim=1, stable=True)

    def _sm(self, dtype, device):
        """Kernel scaling, shape (numblks·NB,); 1 in the base."""
        return torch.ones((self.numblks * self._nb,), dtype=dtype, device=device)

    # -- the two routes ------------------------------------------------------

    def _features(self, X: torch.Tensor) -> torch.Tensor:
        """Streaming form: V·X for columnwise X (n, m) → (S, m)."""
        nb, dt, dev = self._nb, X.dtype, X.device
        if nb != self.n:
            X = torch.nn.functional.pad(X, (0, 0, 0, nb - self.n))
        B = self._blocks("rademacher", self._b_base, dt, dev)
        G = self._blocks("normal", self._g_base, dt, dev)
        perms = self._perms(dev)
        T = wht(B[:, :, None] * X[None, :, :], axis=1)
        T = torch.stack([T[b].index_select(0, perms[b]) for b in range(self.numblks)])
        T = wht(G[:, :, None] * T, axis=1)
        V = T.reshape(self.numblks * nb, -1) * self._sm(dt, dev)[:, None]
        return V[: self.s]

    def _features_rowwise(self, X: torch.Tensor) -> torch.Tensor:
        """RFUT-kernel form: V·x for each row of contiguous X (m, n) →
        (m, S).  Block b keeps its first min(NB, S − b·NB) features."""
        nb, dt, dev = self._nb, X.dtype, X.device
        B = self._blocks("rademacher", self._b_base, dt, dev)
        G = self._blocks("normal", self._g_base, dt, dev)
        perms = self._perms(dev)
        sm = self._sm(dt, dev)
        out = []
        for b in range(self.numblks):
            lo = b * nb
            width = min(nb, self.s - lo)
            T = kernels_fut.rfut_rowwise(X, B[b, :self.n], nb).index_select(1, perms[b])
            T = kernels_fut.rfut_rowwise(T, G[b], nb)
            out.append(T[:, :width] * sm[lo:lo + width])
        return out[0] if len(out) == 1 else torch.cat(out, 1)

    def _kernel_route(self, X: torch.Tensor, batch: int) -> bool:
        return (X.ndim == 2 and X.dtype in _KERNEL_DTYPES
                and kernels_fut.supported(batch, self.n, self._nb))

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        dtype = A.dtype if A.is_floating_point() else torch.float32
        A = A.to(dtype)
        squeeze = A.ndim == 1
        rowwise = dim is Dimension.ROWWISE
        if rowwise:
            X = A[None, :] if squeeze else A
            if X.shape[-1] != self.n:
                raise ValueError(f"rowwise apply needs {self.n} cols, got {tuple(A.shape)}")
            if self._kernel_route(X, X.shape[0]):
                V = self._features_rowwise(X.contiguous())
            else:
                V = self._features(X.T).T
        else:
            X = A[:, None] if squeeze else A
            if X.shape[0] != self.n:
                raise ValueError(f"columnwise apply needs {self.n} rows, got {tuple(A.shape)}")
            if self._kernel_route(X, X.shape[1]):
                V = self._features_rowwise(X.T.contiguous()).T
            else:
                V = self._features(X)
        shifts = self._shifts(dtype, V.device)
        # V is this apply's own temporary: shift, cos and scale in place.
        V.add_(shifts[None, :] if rowwise else shifts[:, None]).cos_()
        Z = V.mul_(_const(self.outscale, dtype, V.device))
        if squeeze:
            return Z[0] if rowwise else Z[:, 0]
        return Z


@register_sketch
class FastGaussianRFT(FastRFT):
    """Fastfood features of the Gaussian kernel: Sm = √NB/σ."""

    sketch_type = "FastGaussianRFT"

    def __init__(self, n, s, context, sigma: float = 1.0):
        self.sigma = float(sigma)
        super().__init__(n, s, context)

    def _sm(self, dtype, device):
        return torch.full((self.numblks * self._nb,), math.sqrt(self._nb) / self.sigma,
                          dtype=dtype, device=device)

    def _param_dict(self):
        return {"sigma": self.sigma}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, sigma=d["sigma"])


@register_sketch
class FastMaternRFT(FastRFT):
    """Fastfood features of the Matérn(ν, ℓ) kernel: Sm = √NB/ℓ times the
    per-row multivariate-t correction."""

    sketch_type = "FastMaternRFT"

    def __init__(self, n, s, context, nu: float = 1.0, l: float = 1.0):
        check_two_nu("FastMaternRFT", nu)
        self.nu = float(nu)
        self.l = float(l)
        super().__init__(n, s, context)
        self._chi_base = context.reserve(self.numblks * self._nb)

    def _sm(self, dtype, device):
        corr = matern_scales(self.nu, self._seed, self._chi_base,
                             self.numblks * self._nb, dtype, device)
        return corr * _const(math.sqrt(self._nb) / self.l, dtype, corr.device)

    def _param_dict(self):
        return {"nu": self.nu, "l": self.l}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, nu=d["nu"], l=d["l"])
