"""Deterministic RNG context: the global (seed, counter) sample stream
(port of ``libskylark_tpu/core/context.py``).

Every consumer of randomness *reserves* a contiguous range of the
counter stream and records its base; values are generated lazily from
the counters, so a transform is reconstructible from ~100 bytes of JSON.
The dict/JSON form is identical to the JAX package's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

__all__ = ["SketchContext"]

_SERIAL_VERSION = 2  # tracks sketch.base.SERIAL_VERSION (stream revision)


@dataclass
class SketchContext:
    """Mutable counter-reserving context (mirrors ``context_t``)."""

    seed: int = 0
    counter: int = 0

    def reserve(self, size: int) -> int:
        if size < 0:
            raise ValueError(f"cannot reserve a negative block ({size})")
        base = self.counter
        self.counter += int(size)
        return base

    def to_dict(self) -> dict[str, Any]:
        return {
            "skylark_object_type": "context",
            "skylark_version": _SERIAL_VERSION,
            "seed": int(self.seed),
            "counter": int(self.counter),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SketchContext":
        return cls(seed=int(d["seed"]), counter=int(d["counter"]))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "SketchContext":
        return cls.from_dict(json.loads(s))
