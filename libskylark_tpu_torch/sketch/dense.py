"""Dense counter-based sketches JLT and CT and the lazy dense engine
(port of ``libskylark_tpu/sketch/dense.py``).

The sketch matrix ``Omega`` (S, N) is never stored: entry (i, j) is a
pure function of ``(seed, base + i·N + j)`` (``core.random.sample_window``),
so any window is bitwise the same slice of the full matrix and a sketch
rebuilds from its JSON.  An apply realizes Omega in the input's dtype and
runs one matmul (full f32 on the card: TF32 is off, ``_device.py``);
above ``MAX_REALIZE_ELEMENTS`` entries it realizes Omega panel by panel
along N and accumulates, so at most one (S, panel) window is live.

Sparse input is a ``torch.sparse_coo_tensor``; its product with the
realized Omega is dense.  A dense sketch of a sparse input above the
limit raises, as in the JAX package.

Streaming slices (``apply_slice``, ``apply_slice_kernel``) realize only
the (S, k) column window ``Omega[:, start:start+k]`` of a row block;
``apply_slice_kernel`` zeroes the window's columns past N.  The last
window realized by a host-int ``start`` is kept, so a streaming pass
that sketches two blocks at the same rows (least squares' A and b)
realizes it once; :meth:`DenseSketch.finalize_slices` drops it.
"""

from __future__ import annotations

from typing import Any

import torch

from .._device import as_tensor, resolve_device
from ..core.context import SketchContext
from ..core.random import _const, sample_window
from ..utils.exceptions import UnsupportedError
from .base import Dimension, SketchTransform, register_sketch

__all__ = ["DenseSketch", "JLT", "CT", "MAX_REALIZE_ELEMENTS"]

# Above this many Omega entries apply() accumulates over column panels of
# Omega instead of realizing it whole (128M entries = 0.5 GB in f32).
# Read at call time, so a test may patch it.
MAX_REALIZE_ELEMENTS = 1 << 27


def _float_dtype(A: torch.Tensor) -> torch.dtype:
    return A.dtype if A.is_floating_point() else torch.float32


def _matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense @ dense, or a product with one sparse COO operand (dense
    result)."""
    if y.layout == torch.sparse_coo:          # Omega (S, N) @ A (N, m)
        if y.ndim == 1:
            return torch.sparse.mm(y.unsqueeze(0), x.T)[0]
        return torch.sparse.mm(y.t(), x.T).T
    if x.layout == torch.sparse_coo:          # A (m, N) @ Omega.T (N, S)
        if x.ndim == 1:
            return torch.sparse.mm(x.unsqueeze(0), y)[0]
        return torch.sparse.mm(x, y)
    return torch.matmul(x, y)


class DenseSketch(SketchTransform):
    """Sketch with iid entries ``scale * dist()`` — the dense engine.
    ``dist`` is a key of ``core.random.DISTRIBUTIONS``; ``scale`` a
    deterministic scalar (1/√S for JLT)."""

    dist: str = "normal"

    def __init__(self, n: int, s: int, context: SketchContext,
                 scale: float = 1.0, dist_params: dict[str, Any] | None = None):
        super().__init__(n, s, context)
        self.scale = float(scale)
        self._dist_params = dict(dist_params or {})
        self._seed = context.seed
        self._base = context.reserve(n * s)
        self._hoist_cache: dict[tuple[torch.dtype, torch.device], torch.Tensor] = {}
        self._last_window = None

    def realize(self, dtype=torch.float32, offset: tuple[int, int] = (0, 0),
                shape: tuple[int, int] | None = None, device=None) -> torch.Tensor:
        """A window of the logical (S, N) sketch matrix, bitwise the same
        slice of the full one.  ``scale`` is rounded to ``dtype`` first,
        as the JAX package rounds it."""
        w = sample_window(self.dist, self._seed, self._base, (self.s, self.n),
                          dtype=dtype, offset=offset, shape=shape, device=device,
                          **self._dist_params)
        return w * _const(self.scale, dtype, w.device)

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        return self._apply_impl(as_tensor(A, device), Dimension.of(dim), omega=None)

    # -- streaming slices ---------------------------------------------------

    supports_slice_kernel = True

    def _slice_window(self, start, k: int, dtype, device) -> torch.Tensor:
        """``Omega[:, start:start+k]`` in ``dtype``, columns past N
        included as the counter stream has them; a host-int window is
        kept for the next call at the same rows."""
        if isinstance(start, torch.Tensor):
            return self.realize(dtype, offset=(0, start), shape=(self.s, k), device=device)
        key = (int(start), k, dtype, torch.device(device))
        if self._last_window is None or self._last_window[0] != key:
            self._last_window = None  # release the old window first
            self._last_window = (key, self.realize(dtype, offset=(0, int(start)),
                                                   shape=(self.s, k), device=device))
        return self._last_window[1]

    def _apply_slice_columnwise(self, A_block, start: int):
        dtype = _float_dtype(A_block)
        w = self._slice_window(start, A_block.shape[0], dtype, A_block.device)
        if A_block.layout == torch.sparse_coo:
            return _matmul(w, A_block)
        return _matmul(w, A_block.to(dtype))

    def apply_slice_kernel(self, A_block, start):
        k = A_block.shape[0]
        dtype = _float_dtype(A_block)
        w = self._slice_window(start, k, dtype, A_block.device)
        dev = A_block.device
        valid = torch.arange(k, device=dev) + start < self.n
        w = torch.where(valid[None, :], w, torch.zeros((), dtype=dtype, device=dev))
        return _matmul(w, A_block.to(dtype))

    def finalize_slices(self, acc, dim: Dimension | str = Dimension.COLUMNWISE):
        self._last_window = None
        return acc

    def hoistable_operands(self, dtype=torch.float32, device=None):
        """The realized (S, N) Omega, for callers that apply the sketch
        many times; None above ``MAX_REALIZE_ELEMENTS`` (the panel path
        has no single Omega).  Memoized per dtype and device: a sketch
        never changes, so its realization never goes stale."""
        if self.n * self.s > MAX_REALIZE_ELEMENTS:
            return None
        dtype = dtype if dtype.is_floating_point else torch.float32
        key = (dtype, resolve_device(device))
        hit = self._hoist_cache.get(key)
        if hit is None:
            hit = self._hoist_cache[key] = self.realize(dtype, device=key[1])
        return hit

    def apply_with_operands(self, ops, A, dim: Dimension | str = Dimension.COLUMNWISE,
                            *, device=None):
        """:meth:`apply` with a pre-realized Omega (bitwise the same)."""
        return self._apply_impl(as_tensor(A, device), Dimension.of(dim), omega=ops)

    def _apply_impl(self, A: torch.Tensor, dim: Dimension, omega):
        dtype = _float_dtype(A)
        if dim is Dimension.COLUMNWISE:
            if A.shape[0] != self.n:
                raise ValueError(
                    f"columnwise apply needs A with {self.n} rows, got {tuple(A.shape)}")
        elif A.shape[-1] != self.n:
            raise ValueError(
                f"rowwise apply needs A with {self.n} columns, got {tuple(A.shape)}")
        sparse = A.layout == torch.sparse_coo
        if omega is None:
            if self.n * self.s > MAX_REALIZE_ELEMENTS:
                if sparse:
                    raise UnsupportedError(
                        f"dense sketch of a sparse input needs the full "
                        f"({self.s}, {self.n}) Omega materialized "
                        f"(> MAX_REALIZE_ELEMENTS); use an input-sparsity "
                        f"sketch (CWT/SJLT) at this scale")
                return self._apply_blocked(A.to(dtype), dim, dtype)
            omega = self.realize(dtype, device=A.device)
        elif omega.dtype != dtype or omega.device != A.device:
            # Re-realize rather than convert: a value-converted Omega would
            # break the bitwise-equal-to-apply contract.
            omega = self.realize(dtype, device=A.device)
        A = A.to(dtype)
        if dim is Dimension.COLUMNWISE:
            return _matmul(omega, A)
        return _matmul(A, omega.T)

    def _apply_blocked(self, A: torch.Tensor, dim: Dimension, dtype):
        """Accumulate over column panels of Omega: peak extra memory is one
        (S, panel) window (the JAX package's panel loop, as a Python
        loop)."""
        panel = max(1, MAX_REALIZE_ELEMENTS // self.s)
        cw = dim is Dimension.COLUMNWISE
        out_shape = (self.s,) + tuple(A.shape[1:]) if cw else tuple(A.shape[:-1]) + (self.s,)
        acc = torch.zeros(out_shape, dtype=dtype, device=A.device)
        for p0 in range(0, self.n, panel):
            pc = min(panel, self.n - p0)
            w = self.realize(dtype, offset=(0, p0), shape=(self.s, pc), device=A.device)
            if cw:
                acc = acc + torch.matmul(w, A[p0:p0 + pc])
            else:
                acc = acc + torch.matmul(A[..., p0:p0 + pc], w.T)
        return acc


@register_sketch
class JLT(DenseSketch):
    """Johnson-Lindenstrauss: iid N(0, 1/S) entries (an l2 subspace
    embedding)."""

    sketch_type = "JLT"
    dist = "normal"

    def __init__(self, n: int, s: int, context: SketchContext):
        super().__init__(n, s, context, scale=(1.0 / s) ** 0.5)


@register_sketch
class CT(DenseSketch):
    """Cauchy transform: iid Cauchy entries scaled C/S (an l1
    embedding)."""

    sketch_type = "CT"
    dist = "cauchy"

    def __init__(self, n: int, s: int, context: SketchContext, C: float = 1.0):
        self.C = float(C)
        super().__init__(n, s, context, scale=self.C / s)

    def _param_dict(self):
        return {"C": self.C}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, C=d.get("C", 1.0))
