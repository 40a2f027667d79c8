"""The exceptions this slice of the port raises, with the JAX package's
stable error codes (``libskylark_tpu/utils/exceptions.py``)."""

from __future__ import annotations

__all__ = ["SkylarkError", "AllocationError", "InvalidParameters", "SketchError",
           "UnsupportedError", "IOError_", "ConvergenceError", "CheckpointError",
           "NumericalHealthError", "StaleEpochError", "RefinementError", "deferred"]


class SkylarkError(Exception):
    """Base (≙ ``skylark_exception``, code 100)."""

    code = 100


class AllocationError(SkylarkError):
    code = 101


class InvalidParameters(SkylarkError, ValueError):
    code = 102


class SketchError(SkylarkError):
    code = 103


class UnsupportedError(SkylarkError, NotImplementedError):
    code = 104


class IOError_(SkylarkError, IOError):
    code = 105


class ConvergenceError(SkylarkError):
    """An iterative solve diverged (NaN/Inf iterates) or was halted by a
    guard.  ``result`` carries the best iterate observed before the halt,
    so callers can degrade gracefully instead of receiving garbage."""

    code = 106

    def __init__(self, msg, result=None, iteration=None):
        super().__init__(msg)
        self.result = result
        self.iteration = iteration


class CheckpointError(IOError_):
    """A checkpoint failed integrity validation (bad CRC, wrong object
    type, missing leaves, unreadable container).  Subclasses ``IOError_``
    so IO error handling keeps working."""

    code = 107


class NumericalHealthError(SkylarkError):
    """A numerical-health check fired and no recovery was left: the guard
    ladder (``guard.run_ladder``) ran out of rungs with no dense fallback,
    a finiteness sentinel (``guard.check_finite``) tripped, or a check
    fired under ``SKYLARK_GUARD=0`` where the guard would have fallen
    back.  ``stage`` names the pipeline stage whose probe tripped and
    ``report`` carries the ladder's ``RecoveryReport`` when there was
    one."""

    code = 108

    def __init__(self, msg, stage=None, report=None):
        super().__init__(msg)
        self.stage = stage
        self.report = report


class StaleEpochError(SkylarkError):
    """A checkpoint slot (or a peer) carries another elastic epoch than
    this process runs at: its state belongs to a superseded partition.
    Deliberately not a ``CheckpointError``, so the store's corrupt-slot
    fallback cannot swallow it and load an equally stale older slot.
    ``expected``/``got`` carry the two epochs."""

    code = 111

    def __init__(self, msg, expected=None, got=None):
        super().__init__(msg)
        self.expected = expected
        self.got = got


class RefinementError(SkylarkError):
    """Mixed-precision iterative refinement stagnated or diverged: the
    f64 residual gate was not reached before the stagnation/divergence
    detector fired.  Under the guard ladder this is a RESKETCH verdict
    (the ladder falls to a fresh sketch, a grown one, and the exact
    dense solve), so it reaches a caller only under ``SKYLARK_GUARD=0``.
    ``iters`` is the sweep budget, ``residual`` the certificate's cond
    estimate, and ``stage`` the pipeline stage (``"refine_ls"``)."""

    code = 115

    def __init__(self, msg, iters=None, residual=None, stage=None):
        super().__init__(msg)
        self.iters = iters
        self.residual = residual
        self.stage = stage


def deferred(name: str, item: str):
    """A stand-in for the JAX package's ``name`` that a later slice of the
    port brings: calling it raises :class:`UnsupportedError` naming the
    ROADMAP ``item``."""

    def unsupported(*args, **kwargs):
        raise UnsupportedError(f"{name} is not ported yet ({item})")

    unsupported.__name__ = unsupported.__qualname__ = name
    unsupported.__doc__ = f"Not ported yet ({item}); raises UnsupportedError."
    return unsupported
