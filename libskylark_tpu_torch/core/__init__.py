"""Core layer of the port: counter stream, context, params, precision."""

from .context import SketchContext
from .params import Params
from .precision import bf16_split3, f32_accumulable
from .random import raw_bits, sample, sample_window, window_bits

__all__ = [
    "SketchContext",
    "Params",
    "bf16_split3",
    "f32_accumulable",
    "raw_bits",
    "window_bits",
    "sample",
    "sample_window",
]
