"""Fastfood feature maps (Le-Sarlós-Smola), port of
``libskylark_tpu/sketch/frft.py``.

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

Routes, the same on the card and on the CPU, in the order they are
tried:

- the realized-W route: the whole chain of each block realized as a
  dense (S, N) f32 matrix W (the streaming form applied to eye(N)) and
  applied as a GEMM, then ``√(2/S)·cos(V + shift)``.  A bf16 input is
  one bf16 product with an f32 result (``core.precision.mm_f32``); an
  f32 input the JAX package's four bf16 passes (A's three split parts
  against W's top part, plus A's top part against W's second; the
  ~2^-16-relative W_lo·A_lo tail is dropped).
  :meth:`FastRFT.hoistable_operands` gives (W, shifts) to every
  streaming consumer, with no backend gate, as the JAX package does:
  the rowwise plans (serving's predict, the streaming drivers) and
  streaming KRR's panel passes.  A plain :meth:`FastRFT.apply` takes
  it where ``_realize_wins`` holds,
  which is the JAX package's gate on a backend that is not a TPU: off
  unless ``SKYLARK_FRFT_GEMM=1`` (``SKYLARK_NO_FRFT_GEMM=1`` wins);
- 2-D f32/bf16 input with NB in the RFUT kernels' range (128..2^15):
  each block is two ``kernels_fut.rfut_rowwise`` launches on the rowwise
  (batch, NB) layout, H·(B ⊙ x) and H·(G ⊙ Πy), with the permutation an
  ``index_select`` of columns between them (columnwise input is
  transposed in and out).  On the card that is two reads and writes of
  the batch per block instead of a Kronecker WHT's several;
- otherwise the JAX package's streaming form, with the Kronecker ``wht``
  over the (blocks, NB, batch) stack and the permutation an
  ``index_select`` per block.

Its f32 output is f32 here; the JAX package's streaming form returns
f64 for f32 input when x64 is on (its ``outscale`` is a numpy f64).
"""

from __future__ import annotations

import math
import os

import torch

from .._device import as_tensor, resolve_device
from ..core.context import SketchContext
from ..core.precision import bf16_split3, mm_f32
from ..core.random import _const, sample
from . import kernels_fut
from .base import Dimension, SketchTransform, register_sketch
from .fut import next_pow2, wht
from .rft import _TWO_PI, check_two_nu, matern_scales

__all__ = ["FastRFT", "FastGaussianRFT", "FastMaternRFT"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The JAX package's realized-W gate: W pays off once the batch is several
# NB wide (_REALIZE_MIN_BATCH_BLOCKS), its (numblks·NB, NB) f32 build is
# capped (_REALIZE_MAX_ELEMENTS, also the hoisting cap), and the GEMM's
# S·N flops per row must stay under the dtype's ratio times numblks·NB.
_REALIZE_MIN_BATCH_BLOCKS = 4
_REALIZE_MAX_ELEMENTS = 64 << 20
_REALIZE_MAX_RATIO = {torch.bfloat16: 4096.0, torch.float32: 2560.0}


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

    # -- the realized-W route --------------------------------------------------

    def _realize_wins(self, dtype, batch: int) -> bool:
        """The JAX package's gate of the realized apply, as it reads on a
        backend that is not a TPU: off unless ``SKYLARK_FRFT_GEMM=1``;
        ``SKYLARK_NO_FRFT_GEMM=1`` turns it off.  Then bf16 or f32 only,
        W under ``_REALIZE_MAX_ELEMENTS``, S·N within the dtype's
        ``_REALIZE_MAX_RATIO`` of numblks·NB, and a batch of at least
        ``_REALIZE_MIN_BATCH_BLOCKS`` NB."""
        if os.environ.get("SKYLARK_NO_FRFT_GEMM", "0") == "1":
            return False
        if os.environ.get("SKYLARK_FRFT_GEMM", "0") != "1":
            return False
        if dtype not in _REALIZE_MAX_RATIO:
            return False
        if self.numblks * self._nb * self._nb > _REALIZE_MAX_ELEMENTS:
            return False
        if self.s * self.n > _REALIZE_MAX_RATIO[dtype] * self.numblks * self._nb:
            return False
        return batch >= _REALIZE_MIN_BATCH_BLOCKS * self._nb

    def _realized_w(self, device) -> torch.Tensor:
        """(S, N) f32 matrix of the whole chain: the streaming form of
        eye(N), drawn from the same counter windows."""
        return self._features(torch.eye(self.n, dtype=torch.float32, device=device)).to(
            torch.float32)

    def hoistable_operands(self, dtype=torch.float32, device=None):
        """``(W, shifts)`` in f32 for bf16 and f32 input, made once per
        device and kept; None for other dtypes or a W over
        ``_REALIZE_MAX_ELEMENTS``.  No backend or batch gate, as in the
        JAX package: a hoisting consumer builds W once for its whole
        loop."""
        if dtype not in _KERNEL_DTYPES:
            return None
        if self.numblks * self._nb * self._nb > _REALIZE_MAX_ELEMENTS:
            return None
        key = resolve_device(device)
        cache = self.__dict__.setdefault("_hoist_cache", {})
        if key not in cache:
            cache[key] = (self._realized_w(key), self._shifts(torch.float32, key))
        return cache[key]

    def apply_with_operands(self, ops, A, dim: Dimension | str = Dimension.COLUMNWISE,
                            *, device=None):
        """The realized apply with hoisted ``(W, shifts)``: bitwise the
        forced realized :meth:`apply`.  Without ops, or for input other
        than 2-D bf16/f32, :meth:`apply`."""
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if (ops is None or A.layout != torch.strided or A.ndim != 2
                or A.dtype not in _KERNEL_DTYPES):
            return self.apply(A, dim)
        rowwise = dim is Dimension.ROWWISE
        if A.shape[1 if rowwise else 0] != self.n:
            raise ValueError(f"{dim.value} apply needs {self.n} on the sketched axis, "
                             f"got {tuple(A.shape)}")
        return self._apply_realized(A, rowwise, ops)

    def _apply_realized(self, A: torch.Tensor, rowwise: bool, ops=None) -> torch.Tensor:
        """``√(2/S)·cos(W·x + shift)`` per column (per row rowwise) of 2-D
        bf16/f32 ``A`` through the realized W, in A's dtype."""
        W, sh = ops if ops is not None else (self._realized_w(A.device), None)

        def mm(x, w):
            return mm_f32(x, w.T) if rowwise else mm_f32(w, x)

        if A.dtype == torch.bfloat16:
            V = mm(A, W.to(torch.bfloat16))
        else:
            w_hi, w_lo, _ = bf16_split3(W)
            a_hi, a_lo, a_lo2 = bf16_split3(A)
            V = mm(a_hi, w_hi) + mm(a_lo, w_hi) + mm(a_lo2, w_hi) + mm(a_hi, w_lo)
        if sh is None:
            sh = self._shifts(torch.float32, A.device)
        V.add_(sh[None, :] if rowwise else sh[:, None]).cos_()
        return V.mul_(_const(self.outscale, torch.float32, V.device)).to(A.dtype)

    # -- routing --------------------------------------------------------------

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
            if X.ndim == 2 and self._realize_wins(dtype, X.shape[0]):
                Z = self._apply_realized(X, True)
                return Z[0] if squeeze else Z
            if self._kernel_route(X, X.shape[0]):
                V = self._features_rowwise(X.contiguous())
            else:
                V = self._features(X.T).T
        else:
            X = A[:, None] if squeeze else A
            if X.shape[0] != self.n:
                raise ValueError(f"columnwise apply needs {self.n} rows, got {tuple(A.shape)}")
            if X.ndim == 2 and self._realize_wins(dtype, X.shape[1]):
                Z = self._apply_realized(X, False)
                return Z[:, 0] if squeeze else Z
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
