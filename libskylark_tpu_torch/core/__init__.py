"""Core layer of the port: counter stream, QMC sequences, context,
params, precision."""

from .context import SketchContext
from .matrices import gaussian_matrix, random_matrix, uniform_matrix
from .params import Params
from .precision import bf16_split3, f32_accumulable, fp8_available, fp8_dtype
from .quasirand import LeapedHaltonSequence, primes, radical_inverse
from .random import chi2_lanes, raw_bits, sample, sample_window, window_bits

__all__ = [
    "SketchContext",
    "Params",
    "LeapedHaltonSequence",
    "primes",
    "radical_inverse",
    "bf16_split3",
    "f32_accumulable",
    "fp8_dtype",
    "fp8_available",
    "raw_bits",
    "window_bits",
    "sample",
    "sample_window",
    "chi2_lanes",
    "random_matrix",
    "gaussian_matrix",
    "uniform_matrix",
]
