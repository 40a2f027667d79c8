"""Walsh-Hadamard transform and the RFUT sketch (port of
``libskylark_tpu/sketch/fut.py``; the DCT backend waits for a later
slice).

``wht`` is the JAX package's XLA path, not a Pallas kernel: the
Kronecker factorization ``H_{2^k} = H_a ⊗ H_b ⊗ ...`` with dense ±1
factors of size ≤ 256 turns the transform into a few full-f32 matmuls
(TF32 is off, ``_device.py``).  It serves NB > 2^15, where the fused
kernel's padded row no longer fits one block's shared memory.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import sample
from ..utils.exceptions import UnsupportedError
from .base import Dimension, SketchTransform

__all__ = ["wht", "next_pow2", "RFUT"]

_MAX_FACTOR_LOG2 = 8  # dense Hadamard factors up to 256x256


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@lru_cache(maxsize=16)
def _hadamard(k: int) -> np.ndarray:
    """Dense 2^k × 2^k Sylvester Hadamard matrix (unnormalized, ±1)."""
    H = np.array([[1.0]])
    for _ in range(k):
        H = np.block([[H, H], [H, -H]])
    return H


def wht(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Orthonormal Walsh-Hadamard transform along ``axis`` (size 2^k),
    natural Sylvester order, as a chain of small dense einsum
    contractions over the factor axes of ``x``."""
    axis = axis % x.ndim
    n = x.shape[axis]
    k = n.bit_length() - 1
    if n != (1 << k):
        raise ValueError(f"wht needs a power-of-2 size, got {n}")
    if n == 1:
        return x
    chunks = []
    rem = k
    while rem > 0:
        c = min(rem, _MAX_FACTOR_LOG2)
        chunks.append(c)
        rem -= c
    factors = [1 << c for c in chunks]
    lead = tuple(x.shape[:axis])
    trail = tuple(x.shape[axis + 1:])
    x = x.reshape(*lead, *factors, *trail)
    nlead, nfac, ntrail = len(lead), len(factors), len(trail)
    letters = "abcdefghijklmnopqrstuvw"
    lead_l = letters[:nlead]
    fac_l = letters[nlead: nlead + nfac]
    trail_l = letters[nlead + nfac: nlead + nfac + ntrail]
    in_sub = lead_l + fac_l + trail_l
    for i, c in enumerate(chunks):
        H = torch.as_tensor(_hadamard(c), dtype=x.dtype, device=x.device)
        out_sub = in_sub.replace(fac_l[i], "z")
        x = torch.einsum(f"{in_sub},z{fac_l[i]}->{out_sub}", x, H)
    x = x.reshape(*lead, n, *trail)
    return x * torch.tensor(1.0 / np.sqrt(n), dtype=x.dtype, device=x.device)


class RFUT(SketchTransform):
    """Randomized fast unitary transform X → F·(D ⊙ X), D a Rademacher
    diagonal; non-power-of-2 N is zero-padded to NB = next_pow2(N).
    A building block of FJLT, not in the string-typed registry."""

    sketch_type = "RFUT"
    diag_dist = "rademacher"

    def __init__(self, n: int, context: SketchContext, fut: str = "wht"):
        if fut != "wht":
            raise UnsupportedError(
                f"FUT {fut!r} is not ported yet; only 'wht' is "
                "(ROADMAP Queue A, remaining sketches: the DCT)"
            )
        self._fut_name = fut
        self._nb = next_pow2(n)
        super().__init__(n, self._nb, context)
        self._seed = context.seed
        self._d_base = context.reserve(n)

    def diagonal(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return sample(self.diag_dist, self._seed, self._d_base, self.n,
                      dtype=dtype, device=device)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if not A.is_floating_point():
            A = A.to(torch.float32)
        squeeze = A.ndim == 1
        if squeeze:
            A = A[:, None] if dim is Dimension.COLUMNWISE else A[None, :]
        axis = 0 if dim is Dimension.COLUMNWISE else A.ndim - 1
        if A.shape[axis] != self.n:
            raise ValueError(
                f"{dim.value} apply needs {self.n} on axis {axis}, got "
                f"{tuple(A.shape)}"
            )
        shape = [1] * A.ndim
        shape[axis] = self.n
        X = A * self.diagonal(A.dtype, A.device).reshape(shape)
        if self._nb != self.n:
            pad_shape = list(X.shape)
            pad_shape[axis] = self._nb - self.n
            X = torch.cat([X, X.new_zeros(pad_shape)], dim=axis)
        out = wht(X, axis=axis)
        if squeeze:
            out = out[:, 0] if dim is Dimension.COLUMNWISE else out[0]
        return out

    def _param_dict(self):
        return {"fut": self._fut_name}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], context, fut=d.get("fut", "wht"))
