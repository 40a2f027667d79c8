"""Fast Johnson-Lindenstrauss transform (port of
``libskylark_tpu/sketch/fjlt.py``): D (Rademacher diagonal) → fast
unitary transform (WHT, or the DCT with ``fut="dct"``) → uniform sample
of S coordinates with rescale √(NB/S).  Counter layout as the
reference's: N for the RFUT diagonal, then S sample indices.

Routing for dense input, the same on the card and on the CPU:

- WHT, 2-D floating input with N on the sketched axis, where
  :meth:`FJLT._gemm_wins` holds (the JAX package's gate, with its
  ``_GEMM_FPB`` rates and ``_GEMM_MAX_ELEMENTS`` cap, read per call;
  ``SKYLARK_NO_SRHT_GEMM=1`` turns it off): the subsampled-Hadamard
  GEMM.  The (N, S) ±1 matrix G of the S sampled Hadamard columns with
  D folded in is exact in bf16; a bf16 input is one product against it,
  an f32 input the three parts of its exact bf16 split, each a bf16
  product with an f32 result (``core.precision.mm_f32``), and an f64
  input one f64 product.  :meth:`FJLT.hoistable_operands` gives G to a
  streaming consumer.
- WHT, f32/bf16, NB ≤ 2^15: the fused kernels, columnwise by
  transposing in and out.  The sampled kernel when its gate holds (S ≥
  128, S % 128 == 0), else ``rfut_rowwise`` plus a lane gather of the
  S samples.
- WHT at NB > 2^15, and the DCT at any N (NB = N): the transform in
  plain torch (the Kronecker ``wht``, or ``dct`` over ``torch.fft``),
  then the ``gather_scaled_rows`` kernel for a columnwise 2-D apply.
  The fused kernels and the GEMM compute a WHT, so the DCT never takes
  them, as in the JAX package.
"""

from __future__ import annotations

import math
import os

import torch

from .._device import as_tensor, resolve_device
from ..core.context import SketchContext
from ..core.precision import bf16_split3, mm_f32
from ..core.random import _const
from . import kernels_fut, kernels_window
from .base import Dimension, SketchTransform, register_sketch
from .fut import RFUT
from .sampling import UST

__all__ = ["FJLT"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The JAX package's gate of the subsampled-Hadamard GEMM, per bf16-
# equivalent pass: the flops per byte of input at which the GEMM
# overtakes the streamed transform and gather (an f32 input takes three
# bf16 passes; f64 and other float types one exact product).
_GEMM_FPB = {torch.bfloat16: 500.0, torch.float32: 500.0 / 3.0, torch.float64: 80.0}
# Cap on the realized (N, S) matrix: past it the streamed route runs
# whatever the flops say.
_GEMM_MAX_ELEMENTS = 64 << 20


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits of each non-negative int32 entry (0 or 1):
    torch has no popcount, so the halves are folded together by xor."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


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
        if (self._fut_name == "wht" and A.layout == torch.strided and A.ndim == 2
                and A.is_floating_point() and A.shape[1 if rowwise else 0] == self.n
                and self._gemm_wins(A.dtype)):
            return self._apply_srht_gemm(A, rowwise)
        if self._fut_name == "wht" and A.ndim == 2 and A.dtype in _KERNEL_DTYPES:
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
        return _const(scale, T.dtype, T.device) * self._ust.apply(T, dim)

    # -- the subsampled-Hadamard GEMM ---------------------------------------

    def _gemm_wins(self, dtype) -> bool:
        """The JAX package's gate of the GEMM route: per row or column the
        streamed WHT and gather move ~(N + 2·NB + S) elements while the
        GEMM does 2·N·S flops per bf16-equivalent pass, so the GEMM is
        taken where that ratio stays under the dtype's rate
        (``_GEMM_FPB``; other float types at f64's) and the (N, S)
        matrix under ``_GEMM_MAX_ELEMENTS``.  ``SKYLARK_NO_SRHT_GEMM=1``
        turns it off (read per call)."""
        if os.environ.get("SKYLARK_NO_SRHT_GEMM", "0") == "1":
            return False
        if self.n * self.s > _GEMM_MAX_ELEMENTS:
            return False
        fpb = _GEMM_FPB.get(dtype, _GEMM_FPB[torch.float64])
        return 2.0 * self.n * self.s <= fpb * dtype.itemsize * (self.n + 2 * self._nb + self.s)

    def _srht_matrix(self, dtype, device=None, rows=None) -> torch.Tensor:
        """(N, S) matrix G with ``G[j, i] = D[j]·(-1)^popcount(j & r_i)``:
        the S sampled columns of H_NB on its first N rows (the padding
        rows multiply zeros), the diagonal folded in; ``rows = (r0, r1)``
        makes only rows r0..r1-1.  Its entries are ±1, exact in bf16; the
        1/√S normalization comes after the product."""
        r0, r1 = rows if rows is not None else (0, self.n)
        idx = self.sample_indices(device)
        j = torch.arange(r0, r1, dtype=torch.int32, device=idx.device)
        signs = (1 - 2 * _parity(j[:, None] & idx[None, :])).to(dtype)
        return self._rfut.diagonal(dtype, idx.device)[r0:r1, None] * signs

    def _srht_sum(self, A: torch.Tensor, rowwise: bool, G16=None, rows=None) -> torch.Tensor:
        """The unscaled product of A with :meth:`_srht_matrix` (its rows
        ``rows`` where given: a row block of a columnwise A) in the
        accumulation dtype: one bf16 product for bf16 input (``G16``,
        G's bf16 form, where the caller hoisted it); for f32 the three
        bf16 parts of the exact split ``A = hi + lo + lo2``, each an exact
        ±1 selection summed in f32; one product with an f32 result for
        f16, and one f64 product for f64."""
        dtype = A.dtype

        def mm(x, g):
            return mm_f32(x, g) if rowwise else mm_f32(g.T, x)

        if dtype == torch.bfloat16:
            return mm(A, self._srht_matrix(dtype, A.device, rows) if G16 is None else G16)
        if dtype == torch.float32:
            if G16 is None:
                G16 = self._srht_matrix(torch.bfloat16, A.device, rows)
            hi, lo, lo2 = bf16_split3(A)
            return mm(hi, G16) + mm(lo, G16) + mm(lo2, G16)
        G = self._srht_matrix(dtype, A.device, rows)
        if dtype == torch.float16:
            return mm(A, G)
        return A @ G if rowwise else G.T @ A

    def _srht_scale(self, out: torch.Tensor, dtype) -> torch.Tensor:
        """The GEMM route's scale 1/√S (the orthonormal 1/√NB times the
        sample rescale √(NB/S)), applied in the accumulation dtype, and
        the cast to the input's ``dtype``."""
        return (out * _const(1.0 / math.sqrt(self.s), out.dtype, out.device)).to(dtype)

    def _apply_srht_gemm(self, A: torch.Tensor, rowwise: bool, G16=None) -> torch.Tensor:
        """``scale · (the sampled WHT coordinates of D ⊙ A)`` as a GEMM:
        the same samples and diagonal as the streamed route, one GEMM
        instead of a transform and a gather."""
        return self._srht_scale(self._srht_sum(A, rowwise, G16), A.dtype)

    def hoistable_operands(self, dtype=torch.float32, device=None):
        """The bf16 (N, S) ±1 matrix of the GEMM route, for bf16 and f32
        input (f32 takes its split against it), made once per device and
        kept; None for other dtypes, the DCT, or where the gate sends the
        apply to the streamed route (no dead matrix is realized)."""
        if dtype not in _KERNEL_DTYPES or self._fut_name != "wht" \
                or not self._gemm_wins(dtype):
            return None
        key = resolve_device(device)
        cache = self.__dict__.setdefault("_hoist_cache", {})
        if key not in cache:
            cache[key] = self._srht_matrix(torch.bfloat16, key)
        return cache[key]

    def apply_with_operands(self, ops, A, dim: Dimension | str = Dimension.COLUMNWISE,
                            *, device=None):
        """:meth:`apply` with the hoisted G: bitwise the apply, which takes
        the GEMM route wherever G is used."""
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if (ops is None or A.layout != torch.strided or A.ndim != 2
                or A.dtype not in _KERNEL_DTYPES or not self._gemm_wins(A.dtype)):
            return self.apply(A, dim)
        rowwise = dim is Dimension.ROWWISE
        if A.shape[1 if rowwise else 0] != self.n:
            raise ValueError(f"{dim.value} apply needs {self.n} on the sketched axis, "
                             f"got {tuple(A.shape)}")
        return self._apply_srht_gemm(A, rowwise, G16=ops)

    # -- the fused kernels ----------------------------------------------------

    def _apply_fused(self, A: torch.Tensor) -> torch.Tensor:
        """Rowwise FJLT of contiguous (m, n) ``A`` through the fused
        kernels: the sampled one writes only (m, S); otherwise the full
        (m, NB) transform is written and its S sampled lanes gathered."""
        D = self._rfut.diagonal(A.dtype, A.device)
        idx = self.sample_indices(A.device)
        if kernels_fut.supported_sampled(A.shape[0], self.n, self._nb, self.s):
            return kernels_fut.rfut_rowwise_sampled(A, D, self._nb, idx)
        T = kernels_fut.rfut_rowwise(A, D, self._nb)
        return _const(math.sqrt(self._nb / self.s), T.dtype, T.device) * \
            T.index_select(1, idx.long())

    def _param_dict(self):
        return {"fut": self._fut_name}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, fut=d.get("fut", "wht"))
