"""Preemption-safe solver runtime of the port (port of
``libskylark_tpu/resilient``).

- ``chunked``: the ``ChunkedSolver`` contract (``init_state`` /
  ``step_chunk`` / ``extract_result``) that the Krylov solvers, the
  randomized SVD and the streaming engine expose;
- ``runner``: ``ResilientRunner``, host rounds of device iterations with
  rotated CRC-guarded checkpoints, resume, IO retries and the divergence
  guard;
- ``faults``: deterministic fault injection (preemption, corruption,
  transient IO, the guard's numerical faults) and ``with_retries``.

The elastic layer's ``HostFaultPlan``, the serve journal's
``faults.JournalFaultPlan`` and the serve fleet's ``FleetFaultPlan`` are
ported.
"""

from .chunked import ChunkedSolver
from .faults import (
    FaultPlan,
    FleetFaultPlan,
    HostFaultPlan,
    SimulatedPreemption,
    corrupt_checkpoint,
    corrupt_manifest,
    tear_ledger_tail,
    with_retries,
)
from .runner import ResilientParams, ResilientRunner

__all__ = [
    "ChunkedSolver",
    "ResilientParams",
    "ResilientRunner",
    "FaultPlan",
    "FleetFaultPlan",
    "HostFaultPlan",
    "SimulatedPreemption",
    "corrupt_checkpoint",
    "corrupt_manifest",
    "tear_ledger_tail",
    "with_retries",
]
