"""Base parameter/logging conventions (port of
``libskylark_tpu/core/params.py``): every algorithm takes a params
dataclass with the reference's uniform observability fields,
JSON-round-trippable."""

from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import dataclass, field
from typing import IO, Any

__all__ = ["Params"]


@dataclass
class Params:
    am_i_printing: bool = False
    log_level: int = 0
    prefix: str = ""
    debug_level: int = 0
    log_stream: IO = field(default=None, repr=False, compare=False)

    def log(self, level: int, msg: str) -> None:
        if self.am_i_printing and self.log_level >= level:
            stream = self.log_stream if self.log_stream is not None else sys.stdout
            print(f"{self.prefix}{msg}", file=stream)

    def to_dict(self) -> dict[str, Any]:
        # Not dataclasses.asdict: that deep-copies log_stream, which is
        # unpicklable for real streams.
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "log_stream"
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))
