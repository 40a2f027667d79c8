"""Sketch transform protocol, type registry and JSON serialization
(port of ``libskylark_tpu/sketch/base.py``).

- A transform maps R^N -> R^S; its logical sketch matrix ``Omega`` is
  ``(S, N)``.
- ``apply(A, "columnwise")``: A is ``(N, m)``, the result ``Omega @ A``
  is ``(S, m)``.
- ``apply(A, "rowwise")``: A is ``(m, N)``, the result ``A @ Omega.T``
  is ``(m, S)``.

A sketch is reconstructible from ``(sketch_type, N, S,
creation_context, params)`` — ~100 bytes of JSON, the same bytes the
JAX package writes — because all randomness is counter-derived.  A JSON
written by either package loads in the other and realizes the same
buckets, diagonal and samples.
"""

from __future__ import annotations

import abc
import enum
import json
import warnings
from typing import Any, ClassVar

import torch

from ..core.context import SketchContext

__all__ = [
    "Dimension",
    "SketchTransform",
    "register_sketch",
    "sketch_registry",
    "create_sketch",
    "deserialize_sketch",
    "from_dict",
    "from_json",
    "SERIAL_VERSION",
]

# Version 2: the f32 uniform stream leads with hi's bits
# (docs/counter_contract.md "Stream revisions").
SERIAL_VERSION = 2


class Dimension(enum.Enum):
    """Which dimension of A is sketched (≙ columnwise_tag / rowwise_tag)."""

    COLUMNWISE = "columnwise"
    ROWWISE = "rowwise"

    @classmethod
    def of(cls, d: "Dimension | str") -> "Dimension":
        if isinstance(d, Dimension):
            return d
        return cls(str(d).lower())


COLUMNWISE = Dimension.COLUMNWISE
ROWWISE = Dimension.ROWWISE

_REGISTRY: dict[str, type["SketchTransform"]] = {}


def register_sketch(cls: type["SketchTransform"]) -> type["SketchTransform"]:
    """Class decorator: register under ``cls.sketch_type``."""
    _REGISTRY[cls.sketch_type] = cls
    return cls


def sketch_registry() -> dict[str, type["SketchTransform"]]:
    return dict(_REGISTRY)


class SketchTransform(abc.ABC):
    """A random linear map R^N -> R^S, reconstructible from JSON.

    Subclasses snapshot the context (``self._creation_context``) before
    reserving their counter blocks, return extra JSON fields from
    ``_param_dict`` and rebuild from them in ``_from_param_dict``.
    """

    sketch_type: ClassVar[str] = "Abstract"

    def __init__(self, n: int, s: int, context: SketchContext):
        if n <= 0 or s <= 0:
            raise ValueError(f"sketch dims must be positive, got N={n}, S={s}")
        self.n = int(n)
        self.s = int(s)
        self._creation_context = SketchContext(
            seed=context.seed, counter=context.counter
        )

    @abc.abstractmethod
    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        """Sketch ``A`` along ``dim``; returns a new tensor.  A tensor is
        computed where it lies; an array-like moves to ``device``."""

    def __call__(self, A, dim: Dimension | str = Dimension.COLUMNWISE):
        return self.apply(A, dim)

    # -- partial-sketch protocol (streaming / out-of-core) -------------------
    #
    # Every transform is a linear map (or linear-then-pointwise feature
    # map) with counter-addressed randomness, so ``S·A`` decomposes into
    # per-block contributions that never need the whole A or Omega:
    #
    # - COLUMNWISE (A is (N, m)): rows [start, start+k) contribute
    #   ``Omega[:, start:start+k] @ A_block``; contributions merge by sum,
    #   then :meth:`finalize_slices` (identity for linear sketches, the
    #   cos epilogue for RFT).
    # - ROWWISE (A is (m, N)): a block of rows is sketched whole;
    #   contributions merge by concatenation in stream order.

    #: Whether :meth:`apply_slice_kernel` is implemented.
    supports_slice_kernel: ClassVar[bool] = False

    def apply_slice(self, A_block, start: int, dim: Dimension | str = Dimension.COLUMNWISE):
        """Exact contribution of the block of A starting at row ``start``
        (a host int) of the sketched axis.

        COLUMNWISE: ``A_block`` is rows [start, start+k) of the (N, m)
        input; returns the (S, m) partial ``Omega[:, start:start+k] @
        A_block``.  Summed over a disjoint cover of [0, N) and passed
        through :meth:`finalize_slices`, it gives ``apply(A)`` up to the
        order of summation.  ROWWISE: the finished (k, S) sketch of the
        block (``start`` only records the stream position).
        """
        dim = Dimension.of(dim)
        if dim is Dimension.ROWWISE:
            return self.apply(A_block, dim)
        start = int(start)
        k = A_block.shape[0]
        if start < 0 or start + k > self.n:
            raise ValueError(
                f"slice [{start}, {start + k}) outside the sketch domain [0, {self.n})")
        squeeze = A_block.ndim == 1
        if squeeze:
            A_block = A_block[:, None]
        out = self._apply_slice_columnwise(A_block, start)
        return out[:, 0] if squeeze else out

    def _apply_slice_columnwise(self, A_block, start: int):
        """Subclass hook for the COLUMNWISE partial product; ``A_block``
        is 2-D and bounds-checked."""
        from ..utils.exceptions import UnsupportedError

        raise UnsupportedError(
            f"{self.sketch_type} has no columnwise partial-sketch rule; "
            "stream ROWWISE, or use a dense (JLT/CT), hash "
            "(CWT/SJLT/MMT/WZT), or RFT transform"
        )

    def apply_slice_kernel(self, A_block, start):
        """COLUMNWISE partial without a bounds check: ``start`` is a host
        int or a 0-d int64 tensor on the device (read without a host
        sync), and the window may run past the sketch domain.  Operand
        entries past the domain are zeroed, so a zero-padded ``A_block``
        contributes exactly the in-domain partial."""
        from ..utils.exceptions import UnsupportedError

        raise UnsupportedError(
            f"{self.sketch_type} has no slice kernel; stream it through "
            "apply_slice"
        )

    def apply_slice_kernel_acc(self, acc, A_block, start):
        """One streaming chunk step: ``acc + apply_slice_kernel(A_block,
        start)`` cast to ``acc.dtype``.  Engines with a fused kernel (the
        hash sketches) fold the add into the kernel's emit and must stay
        bitwise equal to this composite."""
        part = self.apply_slice_kernel(A_block, start)
        return acc + part.to(acc.dtype)

    def finalize_slices(self, acc, dim: Dimension | str = Dimension.COLUMNWISE):
        """Turn the merged COLUMNWISE slice-sum into the final sketch
        (identity for linear transforms; feature maps apply their
        pointwise epilogue here).  ROWWISE results pass through."""
        return acc

    # -- loop-invariant operand hoisting ------------------------------------

    def hoistable_operands(self, dtype=torch.float32, device=None):
        """Counter-derived tensors that the apply realizes and that do not
        depend on the input (the sketch operand, ...), or None; a
        streaming consumer realizes them once and passes them to
        :meth:`apply_with_operands`.  Default: nothing to hoist."""
        return None

    def apply_with_operands(self, ops, A, dim: Dimension | str = Dimension.COLUMNWISE,
                            *, device=None):
        """:meth:`apply` with pre-realized :meth:`hoistable_operands`
        (bitwise the same); the default ignores ``ops``."""
        return self.apply(A, dim, device=device)

    def __mul__(self, A):
        return self.apply(A, Dimension.COLUMNWISE)

    def __truediv__(self, A):
        return self.apply(A, Dimension.ROWWISE)

    # -- serialization ------------------------------------------------------

    def _param_dict(self) -> dict[str, Any]:
        return {}

    def to_dict(self) -> dict[str, Any]:
        d = {
            "skylark_object_type": "sketch",
            "skylark_version": SERIAL_VERSION,
            "sketch_type": self.sketch_type,
            "N": self.n,
            "S": self.s,
            "creation_context": self._creation_context.to_dict(),
        }
        d.update(self._param_dict())
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def getindim(self) -> int:
        return self.n

    def getsketchdim(self) -> int:
        return self.s

    @classmethod
    def _from_param_dict(
        cls, d: dict[str, Any], context: SketchContext
    ) -> "SketchTransform":
        return cls(d["N"], d["S"], context)  # type: ignore[call-arg]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SketchTransform":
        ctx = SketchContext.from_dict(d["creation_context"])
        return cls._from_param_dict(d, ctx)

    @classmethod
    def from_json(cls, s: str) -> "SketchTransform":
        return cls.from_dict(json.loads(s))

    def __repr__(self):
        return f"{type(self).__name__}(N={self.n}, S={self.s})"


def from_dict(d: dict[str, Any]) -> SketchTransform:
    """Reconstruct any registered sketch from its dict."""
    t = d["sketch_type"]
    if t not in _REGISTRY:
        raise ValueError(
            f"unknown sketch_type {t!r}; known: {sorted(_REGISTRY)}"
        )
    if d.get("skylark_version", 1) < SERIAL_VERSION:
        warnings.warn(
            f"sketch serialized under stream revision "
            f"{d.get('skylark_version', 1)} (current {SERIAL_VERSION}): "
            "f32-uniform-derived values reproduce differently "
            "(docs/counter_contract.md, Stream revisions)",
            stacklevel=2,
        )
    return _REGISTRY[t].from_dict(d)


def from_json(s: str) -> SketchTransform:
    """Rebuild a sketch from the JSON either package writes."""
    return from_dict(json.loads(s))


def deserialize_sketch(sketch_dict: dict[str, Any]) -> SketchTransform:
    """≙ python-skylark ``deserialize_sketch``: rebuild a transform from
    its dict (``to_dict()`` here, ``serialize()`` in the JAX package);
    the same as :func:`from_dict`."""
    return from_dict(sketch_dict)


def create_sketch(
    sketch_type: str, n: int, s: int, context: SketchContext, **params: Any
) -> SketchTransform:
    """String-typed factory (≙ ``capi/csketch.cpp`` ``create_sketch``)."""
    if sketch_type not in _REGISTRY:
        raise ValueError(
            f"unknown sketch_type {sketch_type!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[sketch_type](n, s, context=context, **params)
