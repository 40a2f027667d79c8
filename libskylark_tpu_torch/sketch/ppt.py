"""PPT — the Pham-Pagh TensorSketch for the polynomial kernel, port of
the FFT path of ``libskylark_tpu/sketch/ppt.py``.

Features of k(x, y) = (γ·xᵀy + c)^q from q CountSketches composed in
the frequency domain:

    Z(x) = IFFT( Π_{l<q} FFT( √γ·CWT_l(x) + √c·s_l·e_{h_l} ) )

where the ``√c·s_l·e_{h_l}`` term (one extra hashed coordinate per level)
carries the kernel's additive constant.  Counter budget as the
reference's: q CWTs (2N each), then q hash indices and q hash values.
The transforms run along the feature axis of whichever layout the apply
has (rows of a columnwise (S, m) sketch, columns of a rowwise (m, S)
one), so a rowwise apply transposes nothing.  bf16/f16 inputs are
transformed in f32.  The JAX package's bf16 matmul-DFT route
(``_dft_wins``) is gated to the TPU and waits for H100 numbers (ROADMAP
Queue A).
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import _const, sample
from .base import Dimension, SketchTransform, register_sketch
from .hash import CWT

__all__ = ["PPT"]


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

    def _features(self, X: torch.Tensor, dim: Dimension) -> torch.Tensor:
        """Features of 2-D X along ``dim``: (S, m) columnwise, (m, S)
        rowwise."""
        dtype, dev = X.dtype, X.device
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
