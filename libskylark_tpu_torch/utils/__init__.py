"""Utilities of the port."""

from . import profiling
from .checkpoint import CheckpointStore, load_solver_state, save_solver_state
from .exceptions import (
    AdmissionError,
    AllocationError,
    CheckpointError,
    CollectiveTimeoutError,
    ConvergenceError,
    DeadlineExceededError,
    IOError_,
    InvalidParameters,
    JournalError,
    NumericalHealthError,
    QuotaExceededError,
    RefinementError,
    RegistryEpochError,
    ReplicaLostError,
    SketchError,
    SkylarkError,
    StaleEpochError,
    UnsupportedError,
    WorldMismatchError,
)
from .sparse import coo_from_bcoo_arrays, is_sparse, linear_ops
from .timer import PhaseTimer, aggregate_report, timer_report

__all__ = ["profiling", "SkylarkError", "AllocationError", "InvalidParameters", "SketchError",
           "UnsupportedError", "IOError_",
           "ConvergenceError", "CheckpointError", "StaleEpochError",
           "NumericalHealthError", "RefinementError", "WorldMismatchError", "CollectiveTimeoutError",
           "AdmissionError",
           "DeadlineExceededError", "ReplicaLostError", "RegistryEpochError",
           "QuotaExceededError", "JournalError", "save_solver_state", "load_solver_state",
           "CheckpointStore", "coo_from_bcoo_arrays", "is_sparse",
           "linear_ops", "PhaseTimer", "timer_report", "aggregate_report"]
