"""Fast Johnson-Lindenstrauss transform (port of
``libskylark_tpu/sketch/fjlt.py``): D (Rademacher diagonal) → WHT →
uniform sample of S coordinates with rescale √(NB/S).  Counter layout
as the reference's: N for the RFUT diagonal, then S sample indices.

Routing for dense f32/bf16 input, the same on the card (kernels) and
on the CPU (their plain versions):

- NB ≤ 2^15: the fused kernels, columnwise by transposing in and out.
  The sampled kernel when its gate holds (S ≥ 128, S % 128 == 0), else
  ``rfut_rowwise`` plus a lane gather of the S samples.
- NB > 2^15: the Kronecker ``wht`` (plain torch), then the
  ``gather_scaled_rows`` kernel for a columnwise 2-D apply.

The JAX package's subsampled-Hadamard GEMM route and its ``_GEMM_FPB``
gate were priced for TPU MXU rates; they are not ported (ROADMAP Queue
A: SRHT-GEMM route with an H100-priced gate), so where the JAX package
takes that route the two agree only to f32 rounding.
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from . import kernels_fut, kernels_window
from .base import Dimension, SketchTransform, register_sketch
from .fut import RFUT
from .sampling import UST

__all__ = ["FJLT"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@register_sketch
class FJLT(SketchTransform):
    """S·F·D: sample S coordinates of a randomized Walsh-Hadamard
    transform, rescaled by ``sqrt(NB/S)`` so that E‖sketch‖² = ‖x‖²."""

    sketch_type = "FJLT"

    def __init__(self, n: int, s: int, context: SketchContext, fut: str = "wht"):
        super().__init__(n, s, context)
        self._fut_name = fut
        self._rfut = RFUT(n, context, fut=fut)
        self._nb = self._rfut._nb
        self._ust = UST(self._nb, s, context, replace=True)

    def sample_indices(self, device=None) -> torch.Tensor:
        """S uniform coordinates in [0, NB) (with replacement), int32."""
        return self._ust.samples(device)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        rowwise = dim is Dimension.ROWWISE
        if A.ndim == 2 and A.dtype in _KERNEL_DTYPES:
            sk_axis, batch_axis = (1, 0) if rowwise else (0, 1)
            if A.shape[sk_axis] == self.n and kernels_fut.supported(
                A.shape[batch_axis], self.n, self._nb
            ):
                out = self._apply_fused(
                    (A if rowwise else A.T).contiguous()
                )
                return out if rowwise else out.T
        T = self._rfut.apply(A, dim)
        scale = math.sqrt(self._nb / self.s)
        if not rowwise and T.ndim == 2 and T.dtype in _KERNEL_DTYPES:
            return kernels_window.gather_scaled_rows(
                T.contiguous(), self.sample_indices(T.device), scale
            )
        return torch.tensor(scale, dtype=T.dtype, device=T.device) * \
            self._ust.apply(T, dim)

    def _apply_fused(self, A: torch.Tensor) -> torch.Tensor:
        """Rowwise FJLT of contiguous (m, n) ``A`` through the fused
        kernels: the sampled one writes only (m, S); otherwise the full
        (m, NB) transform is written and its S sampled lanes gathered."""
        D = self._rfut.diagonal(A.dtype, A.device)
        idx = self.sample_indices(A.device)
        if kernels_fut.supported_sampled(A.shape[0], self.n, self._nb, self.s):
            return kernels_fut.rfut_rowwise_sampled(A, D, self._nb, idx)
        T = kernels_fut.rfut_rowwise(A, D, self._nb)
        scale = torch.tensor(math.sqrt(self._nb / self.s), dtype=T.dtype,
                             device=T.device)
        return scale * T.index_select(1, idx.long())

    def _param_dict(self):
        return {"fut": self._fut_name}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, fut=d.get("fut", "wht"))
