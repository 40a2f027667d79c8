"""The exceptions this slice of the port raises, with the JAX package's
stable error codes (``libskylark_tpu/utils/exceptions.py``)."""

from __future__ import annotations

__all__ = ["SkylarkError", "InvalidParameters", "UnsupportedError",
           "NumericalHealthError"]


class SkylarkError(Exception):
    """Base (≙ ``skylark_exception``, code 100)."""

    code = 100


class InvalidParameters(SkylarkError, ValueError):
    code = 102


class UnsupportedError(SkylarkError, NotImplementedError):
    code = 104


class NumericalHealthError(SkylarkError):
    """A numerical-health check fired where the only safe continuation
    would have been a fallback (the port has no guard ladder yet, so it
    behaves as the JAX package does under ``SKYLARK_GUARD=0``).
    ``stage`` names the pipeline stage whose probe tripped."""

    code = 108

    def __init__(self, msg, stage=None, report=None):
        super().__init__(msg)
        self.stage = stage
        self.report = report
