"""Chunked solver runtime of the port (port of the ``chunked`` part of
``libskylark_tpu/resilient``).

``ChunkedSolver`` is the contract the Krylov solvers and the randomized
SVD expose (``init_state`` / ``step_chunk`` / ``extract_result``).  The
checkpointing ``ResilientRunner`` waits for ROADMAP Queue A item 8
(robustness) and raises ``UnsupportedError``.
"""

from ..utils.exceptions import deferred
from .chunked import ChunkedSolver

_ITEM8 = "ROADMAP Queue A item 8: robustness (resilient runner, checkpoints)"
ResilientRunner = deferred("ResilientRunner", _ITEM8)

__all__ = ["ChunkedSolver", "ResilientRunner"]
