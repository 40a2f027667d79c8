"""Quasirandom dense sketch QJLT: Halton-driven JLT rows (port of
``libskylark_tpu/sketch/quasi.py``).

Entry (j, c) of the logical (S, N) sketch matrix is
``ndtri(radical_inverse(prime(c), (skip + j)·leap)) / √S``, a pure
function of (row, column): a leaped Halton sequence through the normal
inverse CDF instead of iid counter draws.  QMC rows cover the sphere
more evenly than iid rows.  The transform consumes no counters;
``(leap, skip)`` ride its JSON, and the default skip is ``seed mod
2^20`` so that a fresh seed gives fresh rows.

QJLT rides the dense engine (:class:`~.dense.DenseSketch`) with its own
:meth:`QJLT.realize`: one matmul below ``dense.MAX_REALIZE_ELEMENTS``
entries of Omega, column panels of Omega above it (bitwise slices of the
whole), the columnwise slice protocol and the memoized
``hoistable_operands``.  The radical inverses and ``ndtri`` run in f64
(``core.quasirand``) and the result is cast once to the input's dtype.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..core.context import SketchContext
from ..core.quasirand import LeapedHaltonSequence, halton_block, primes
from .base import SketchTransform, register_sketch
from .dense import DenseSketch

__all__ = ["QJLT"]


@register_sketch
class QJLT(DenseSketch):
    """Quasirandom Johnson-Lindenstrauss: Halton rows through ndtri,
    scale ``sqrt(1/S)`` — the QMC sibling of :class:`~.dense.JLT`."""

    sketch_type = "QJLT"
    # Streams through apply_slice: a window is realized from a host-int start.
    supports_slice_kernel = False
    apply_slice_kernel = SketchTransform.apply_slice_kernel

    def __init__(self, n: int, s: int, context: SketchContext, leap: int | None = None,
                 skip: int | None = None):
        SketchTransform.__init__(self, n, s, context)
        self._sequence = LeapedHaltonSequence(n, -1 if leap is None else int(leap))
        self.leap = self._sequence.leap
        # The sequence is deterministic, so the seed moves the rows (a
        # guard's fresh-seed resketch must differ); serialized explicitly.
        self.skip = int(context.seed) % (1 << 20) if skip is None else int(skip)
        self.scale = (1.0 / s) ** 0.5
        self._hoist_cache = {}
        self._last_window = None

    def realize(self, dtype=torch.float32, offset: tuple[int, int] = (0, 0),
                shape: tuple[int, int] | None = None, device=None) -> torch.Tensor:
        """A window of the logical (S, N) sketch matrix, bitwise the same
        slice of the full one: radical inverses by digit tiers and ndtri
        in f64, times the scale in f64, cast once to ``dtype``."""
        dev = resolve_device(device)
        r0, c0 = (int(o) for o in offset)
        h, w = shape if shape is not None else (self.s - r0, self.n - c0)
        if h <= 0 or w <= 0:
            return torch.zeros((max(h, 0), max(w, 0)), dtype=dtype, device=dev)
        rows = self.skip + r0 + torch.arange(h, dtype=torch.int64, device=dev)
        max_res = (self.skip + r0 + h - 1) * self.leap + 1
        u = halton_block(primes(self.n)[c0:c0 + w], rows * self.leap, max_res)
        omega = torch.special.ndtri(u).mul_(torch.tensor(self.scale, dtype=torch.float64,
                                                         device=dev))
        return omega.to(dtype)

    def _param_dict(self):
        return {"leap": self.leap, "skip": self.skip}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, leap=d.get("leap"), skip=d.get("skip", 0))
