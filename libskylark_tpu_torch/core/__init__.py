"""Core layer of the port: counter stream, context, params, precision."""

from .context import SketchContext
from .matrices import gaussian_matrix, random_matrix, uniform_matrix
from .params import Params
from .precision import bf16_split3, f32_accumulable
from .random import chi2_lanes, raw_bits, sample, sample_window, window_bits

__all__ = [
    "SketchContext",
    "Params",
    "bf16_split3",
    "f32_accumulable",
    "raw_bits",
    "window_bits",
    "sample",
    "sample_window",
    "chi2_lanes",
    "random_matrix",
    "gaussian_matrix",
    "uniform_matrix",
]
