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

from ..core.context import SketchContext

__all__ = [
    "Dimension",
    "SketchTransform",
    "register_sketch",
    "sketch_registry",
    "create_sketch",
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


def create_sketch(
    sketch_type: str, n: int, s: int, context: SketchContext, **params: Any
) -> SketchTransform:
    """String-typed factory (≙ ``capi/csketch.cpp`` ``create_sketch``)."""
    if sketch_type not in _REGISTRY:
        raise ValueError(
            f"unknown sketch_type {sketch_type!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[sketch_type](n, s, context=context, **params)
