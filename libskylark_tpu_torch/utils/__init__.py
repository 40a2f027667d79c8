"""Utilities of the port."""

from .exceptions import (
    InvalidParameters,
    NumericalHealthError,
    SkylarkError,
    UnsupportedError,
    deferred,
)
from .sparse import coo_from_bcoo_arrays, is_sparse, linear_ops
from .timer import PhaseTimer, aggregate_report, timer_report

__all__ = ["SkylarkError", "InvalidParameters", "UnsupportedError",
           "NumericalHealthError", "deferred", "coo_from_bcoo_arrays", "is_sparse",
           "linear_ops", "PhaseTimer", "timer_report", "aggregate_report"]
