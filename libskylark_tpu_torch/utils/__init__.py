"""Utilities of the port."""

from .exceptions import (
    InvalidParameters,
    NumericalHealthError,
    SkylarkError,
    UnsupportedError,
)
from .sparse import coo_from_bcoo_arrays

__all__ = ["SkylarkError", "InvalidParameters", "UnsupportedError",
           "NumericalHealthError", "coo_from_bcoo_arrays"]
