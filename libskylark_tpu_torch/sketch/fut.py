"""Fast unitary transforms, Walsh-Hadamard and DCT, and the RFUT sketch
(port of ``libskylark_tpu/sketch/fut.py``).

``wht`` is the JAX package's XLA path, not a Pallas kernel: the
Kronecker factorization ``H_{2^k} = H_a ⊗ H_b ⊗ ...`` with dense ±1
factors of size ≤ 256 turns the transform into a few full-f32 matmuls
(TF32 is off, ``_device.py``).  It serves NB > 2^15, where the fused
kernel's padded row no longer fits one block's shared memory.

``dct`` is the orthonormal DCT-II, which the JAX package computes with
XLA's FFT outside any Pallas kernel.  torch has no DCT, so it is one
length-N complex FFT of the even/odd reordering (Makhoul, IEEE TASSP
28(1), 1980), a twiddle and the ortho scale, for any N along any axis.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import sample
from .base import Dimension, SketchTransform

__all__ = ["wht", "dct", "next_pow2", "RFUT"]

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


def dct(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Orthonormal DCT-II along ``axis`` (``scipy.fft.dct(type=2,
    norm="ortho")``): y_k = s_k·Re(V_k·e^{-iπk/(2N)}) with V the FFT of
    v = (x_0, x_2, x_4, ..., x_5, x_3, x_1).  f64 stays f64; every other
    input (bf16, f16, integers: torch's FFT takes no bf16) is computed and
    returned in f32, the dtype the JAX package returns for it."""
    axis = axis % x.ndim
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    n = x.shape[axis]
    # The even entries in order, then the odd ones reversed.
    order = torch.cat([torch.arange(0, n, 2, device=x.device),
                       torch.arange(1, n, 2, device=x.device).flip(0)])
    V = torch.fft.fft(x.index_select(axis, order), dim=axis)
    # f64 twiddle e^{-iπk/(2N)} times the ortho scale (√(1/N) at k = 0,
    # √(2/N) after), cast once.
    theta = torch.arange(n, dtype=torch.float64, device=x.device) * np.pi / (2.0 * n)
    scale = torch.full((n,), np.sqrt(2.0 / n), dtype=torch.float64, device=x.device)
    scale[0] = np.sqrt(1.0 / n)
    shape = [1] * x.ndim
    shape[axis] = n
    c = (torch.cos(theta) * scale).to(x.dtype).reshape(shape)
    s = (torch.sin(theta) * scale).to(x.dtype).reshape(shape)
    return V.real * c + V.imag * s


_FUTS = {"wht": wht, "dct": dct}


def get_fut(name: str):
    """The transform of a FUT name ("wht" or "dct")."""
    if name not in _FUTS:
        raise ValueError(f"unknown FUT {name!r}; known: {sorted(_FUTS)}")
    return _FUTS[name]


class RFUT(SketchTransform):
    """Randomized fast unitary transform X → F·(D ⊙ X), D a Rademacher
    diagonal.  The WHT zero-pads non-power-of-2 N to NB = next_pow2(N);
    the DCT keeps S = N.  A building block of FJLT, not in the
    string-typed registry."""

    sketch_type = "RFUT"
    diag_dist = "rademacher"

    def __init__(self, n: int, context: SketchContext, fut: str = "wht"):
        self._fut = get_fut(fut)
        self._fut_name = fut
        self._nb = next_pow2(n) if fut == "wht" else n
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
        out = self._fut(X, axis=axis)
        if squeeze:
            out = out[:, 0] if dim is Dimension.COLUMNWISE else out[0]
        return out

    def _param_dict(self):
        return {"fut": self._fut_name}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], context, fut=d.get("fut", "wht"))
