"""Linear algebra layer of the port: exact and sketch-and-solve least
squares."""

from .least_squares import (
    LeastSquaresParams,
    approximate_least_squares,
    exact_least_squares,
)

__all__ = [
    "LeastSquaresParams",
    "approximate_least_squares",
    "exact_least_squares",
]
