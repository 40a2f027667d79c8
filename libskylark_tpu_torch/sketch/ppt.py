"""PPT — the Pham-Pagh TensorSketch for the polynomial kernel, port of
``libskylark_tpu/sketch/ppt.py``.

Features of k(x, y) = (γ·xᵀy + c)^q from q CountSketches composed in
the frequency domain:

    Z(x) = IFFT( Π_{l<q} FFT( √γ·CWT_l(x) + √c·s_l·e_{h_l} ) )

where the ``√c·s_l·e_{h_l}`` term (one extra hashed coordinate per level)
carries the kernel's additive constant.  Counter budget as the
reference's: q CWTs (2N each), then q hash indices and q hash values.
The transforms run along the feature axis of whichever layout the apply
has (rows of a columnwise (S, m) sketch, columns of a rowwise (m, S)
one), so a rowwise apply transposes nothing.  bf16/f16 inputs are
transformed in f32.

The JAX package's bf16 matmul-DFT route (:meth:`PPT._features_dft`)
does each S-point transform as a pair of (S, S) cos/sin products in
real arithmetic, bf16 operands with f32 results
(``core.precision.mm_f32``), and the inverse as one more pair.  Its gate
``_dft_wins`` is read as on a backend that is not a TPU: off unless
``SKYLARK_PPT_DFT=1`` (``SKYLARK_NO_PPT_DFT=1`` wins), then bf16 input,
2 ≤ S ≤ ``_DFT_MAX_S``, a batch of at least ``_DFT_MIN_BATCH`` and q ≤
``_DFT_MAX_Q``.
"""

from __future__ import annotations

import math
import os

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.precision import mm_f32
from ..core.random import _const, sample
from .base import Dimension, SketchTransform, register_sketch
from .hash import CWT

__all__ = ["PPT"]

# The JAX package's matmul-DFT gate: (S, S) tables up to 2^12 (j·k stays
# int32-exact), batches wide enough to pay for building them, and at most
# 8 levels (each rounds its table to bf16).
_DFT_MAX_S = 1 << 12
_DFT_MIN_BATCH = 4096
_DFT_MAX_Q = 8


@register_sketch
class PPT(SketchTransform):
    """TensorSketch feature map for the polynomial kernel (γ·xᵀy + c)^q."""

    sketch_type = "PPT"

    def __init__(self, n: int, s: int, context: SketchContext, q: int = 3,
                 c: float = 1.0, gamma: float = 1.0):
        super().__init__(n, s, context)
        if q < 1:
            raise ValueError(f"PPT needs q >= 1, got {q}")
        self.q = int(q)
        self.c = float(c)
        self.gamma = float(gamma)
        self._seed = context.seed
        self._cwts = [CWT(n, s, context) for _ in range(self.q)]
        self._hidx_base = context.reserve(self.q)
        self._hval_base = context.reserve(self.q)

    def _hash_consts(self, dtype, device):
        idx = sample("uniform_int", self._seed, self._hidx_base, self.q,
                     dtype=torch.int64, device=device, low=0, high=self.s - 1)
        val = sample("rademacher", self._seed, self._hval_base, self.q,
                     dtype=dtype, device=device)
        return idx, val

    def _dft_wins(self, dtype, batch: int) -> bool:
        """The JAX package's gate of the matmul-DFT route, one predicate
        for both orientations, as it reads on a backend that is not a
        TPU (see the module docstring)."""
        if os.environ.get("SKYLARK_NO_PPT_DFT", "0") == "1":
            return False
        if os.environ.get("SKYLARK_PPT_DFT", "0") != "1":
            return False
        return (dtype == torch.bfloat16 and 2 <= self.s <= _DFT_MAX_S
                and batch >= _DFT_MIN_BATCH and self.q <= _DFT_MAX_Q)

    def _dft_tables(self, device):
        """The (S, S) DFT tables ``(cos θ, sin θ)`` in bf16, θ = 2π·(j·k
        mod S)/S with j·k reduced in int32 before the f32 conversion."""
        j = torch.arange(self.s, dtype=torch.int32, device=device)
        jk = (j[:, None] * j[None, :]) % self.s
        theta = _const(2.0 * math.pi / self.s, torch.float32, device) * jk.to(torch.float32)
        return torch.cos(theta).to(torch.bfloat16), torch.sin(theta).to(torch.bfloat16)

    def _features_dft(self, X: torch.Tensor, dim: Dimension) -> torch.Tensor:
        """bf16 features by explicit DFT products: each level's transform
        is a (cos, sin) pair of bf16 products with f32 results, the level
        products run as (Re, Im) f32 pairs, and the inverse is one more
        pair, ``(1/S)·(C·Pr − Sn·Pi)``; no complex tensor is made.  The
        tables are symmetric, so one pair serves the columnwise (S, m) and
        the rowwise (m, S) layout."""
        dev = X.device
        rowwise = dim is Dimension.ROWWISE
        C, Sn = self._dft_tables(dev)
        sqrt_g = _const(math.sqrt(self.gamma), torch.bfloat16, dev)
        sqrt_c = _const(math.sqrt(self.c), torch.float32, dev)
        idx, val = self._hash_consts(torch.float32, dev)

        def mm(W, M):
            return mm_f32(W, M) if rowwise else mm_f32(M, W)

        Pr = Pi = None
        for l, cwt in enumerate(self._cwts):
            W = (sqrt_g * cwt.apply(X, dim)).float()
            row = (sqrt_c * val[l]).expand(1, W.shape[0 if rowwise else 1])
            W.index_add_(1 if rowwise else 0, idx[l:l + 1], row.T if rowwise else row)
            Wb = W.to(torch.bfloat16)
            Re, Im = mm(Wb, C), -mm(Wb, Sn)
            if Pr is None:
                Pr, Pi = Re, Im
            else:
                Pr, Pi = Pr * Re - Pi * Im, Pr * Im + Pi * Re
        Z = mm(Pr.to(torch.bfloat16), C) - mm(Pi.to(torch.bfloat16), Sn)
        return (Z * _const(1.0 / self.s, torch.float32, dev)).to(torch.bfloat16)

    def _features(self, X: torch.Tensor, dim: Dimension) -> torch.Tensor:
        """Features of 2-D X along ``dim``: (S, m) columnwise, (m, S)
        rowwise."""
        dtype, dev = X.dtype, X.device
        if self._dft_wins(dtype, X.shape[1 if dim is Dimension.COLUMNWISE else 0]):
            return self._features_dft(X, dim)
        ax = 0 if dim is Dimension.COLUMNWISE else 1
        sqrt_g = _const(math.sqrt(self.gamma), dtype, dev)
        sqrt_c = _const(math.sqrt(self.c), dtype, dev)
        idx, val = self._hash_consts(dtype, dev)
        P = None
        for l, cwt in enumerate(self._cwts):
            W = sqrt_g * cwt.apply(X, dim)
            row = (sqrt_c * val[l]).expand(1, W.shape[1 - ax])
            W.index_add_(ax, idx[l:l + 1], row if ax == 0 else row.T)
            if dtype in (torch.bfloat16, torch.float16):
                W = W.float()
            F = torch.fft.fft(W, dim=ax)
            P = F if P is None else P.mul_(F)
        return torch.fft.ifft(P, dim=ax).real.to(dtype)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        dtype = A.dtype if A.is_floating_point() else torch.float32
        A = A.to(dtype)
        if dim is Dimension.COLUMNWISE:
            if A.shape[0] != self.n:
                raise ValueError(f"columnwise apply needs {self.n} rows, got {tuple(A.shape)}")
            if A.ndim == 1:
                return self._features(A[:, None], dim)[:, 0]
            return self._features(A, dim)
        if A.shape[-1] != self.n:
            raise ValueError(f"rowwise apply needs {self.n} cols, got {tuple(A.shape)}")
        if A.ndim == 1:
            return self._features(A[None, :], dim)[0]
        return self._features(A, dim)

    def _param_dict(self):
        return {"q": self.q, "c": self.c, "gamma": self.gamma}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, q=d["q"], c=d["c"], gamma=d["gamma"])
