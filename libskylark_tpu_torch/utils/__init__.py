"""Utilities of the port."""

from .exceptions import NumericalHealthError, SkylarkError, UnsupportedError

__all__ = ["SkylarkError", "UnsupportedError", "NumericalHealthError"]
