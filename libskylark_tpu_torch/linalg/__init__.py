"""Randomized NLA of the port (port of ``libskylark_tpu/linalg``):
exact, sketch-and-solve, Blendenpik and LSRN least squares, the
randomized SVD and condition estimation, in core and streamed, and the
Chebyshev collocation utilities (``spectral``)."""

from ..solvers.accelerated import (
    FasterLeastSquaresParams,
    faster_least_squares,
    lsrn_least_squares,
)
from ..solvers.cond_est import CondEstParams, CondEstResult, cond_est
from .least_squares import (
    LeastSquaresParams,
    approximate_least_squares,
    exact_least_squares,
    streaming_least_squares,
)
from .spectral import chebyshev_diff_matrix, chebyshev_points
from .svd import (
    SVDParams,
    approximate_svd,
    approximate_svd_chunked,
    approximate_symmetric_svd,
    gram_orth,
    power_iteration,
    streaming_approximate_svd,
    synthetic_lowrank_blocks,
)

__all__ = [
    "SVDParams",
    "approximate_svd",
    "approximate_svd_chunked",
    "approximate_symmetric_svd",
    "gram_orth",
    "power_iteration",
    "streaming_approximate_svd",
    "synthetic_lowrank_blocks",
    "LeastSquaresParams",
    "approximate_least_squares",
    "exact_least_squares",
    "streaming_least_squares",
    "FasterLeastSquaresParams",
    "faster_least_squares",
    "lsrn_least_squares",
    "cond_est",
    "CondEstParams",
    "CondEstResult",
    "chebyshev_points",
    "chebyshev_diff_matrix",
]
