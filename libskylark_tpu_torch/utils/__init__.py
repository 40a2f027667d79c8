"""Utilities of the port."""

from . import profiling
from .checkpoint import CheckpointStore, load_solver_state, save_solver_state
from .exceptions import (
    AllocationError,
    CheckpointError,
    ConvergenceError,
    IOError_,
    InvalidParameters,
    NumericalHealthError,
    RefinementError,
    SketchError,
    SkylarkError,
    StaleEpochError,
    UnsupportedError,
    deferred,
)
from .sparse import coo_from_bcoo_arrays, is_sparse, linear_ops
from .timer import PhaseTimer, aggregate_report, timer_report

__all__ = ["profiling", "SkylarkError", "AllocationError", "InvalidParameters", "SketchError",
           "UnsupportedError", "IOError_",
           "ConvergenceError", "CheckpointError", "StaleEpochError",
           "NumericalHealthError", "RefinementError", "deferred", "save_solver_state", "load_solver_state",
           "CheckpointStore", "coo_from_bcoo_arrays", "is_sparse",
           "linear_ops", "PhaseTimer", "timer_report", "aggregate_report"]
