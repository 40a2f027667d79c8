"""Iterative solvers of the port (port of ``libskylark_tpu/solvers``):

- ``krylov``: LSQR / CG / FlexibleCG / Chebyshev as chunked solvers
  (≙ ``algorithms/Krylov/``);
- ``precond``: identity, matrix and triangular-inverse preconditioners;
- ``accelerated``: Blendenpik / LSRN sketch-to-precondition least squares;
- ``refine``: sketch-preconditioned mixed-precision iterative refinement;
- ``cond_est``: condition-number estimation with certificates
  (≙ ``nla/CondEst.hpp``);
- ``regression``: the regression-problem dispatch;
- ``prox``: loss/regularizer prox library (≙ ``algorithms/regression/
  loss.hpp``, ``regularizers.hpp``);
- ``gauss_seidel``: synchronous randomized block Gauss-Seidel
  (≙ ``algorithms/asynch/AsyRGS.hpp``);
- ``asynch``: flexible CG preconditioned by it (≙ ``AsyFCG.hpp``).
"""

from .accelerated import FasterLeastSquaresParams, faster_least_squares, lsrn_least_squares
from .asynch import asy_fcg
from .cond_est import CondEstParams, CondEstResult, cond_est
from .gauss_seidel import randomized_block_gauss_seidel
from .krylov import (
    KrylovParams,
    cg,
    cg_chunked,
    chebyshev,
    chebyshev_chunked,
    flexible_cg,
    flexible_cg_chunked,
    lsqr,
    lsqr_chunked,
)
from .precond import IdPrecond, MatPrecond, TriInversePrecond
from .prox import LOSSES, REGULARIZERS, get_loss, get_regularizer
from .refine import RefineParams, refine_least_squares
from .regression import RegressionProblem, solve_regression

__all__ = [
    "KrylovParams",
    "lsqr",
    "cg",
    "flexible_cg",
    "chebyshev",
    "lsqr_chunked",
    "cg_chunked",
    "flexible_cg_chunked",
    "chebyshev_chunked",
    "IdPrecond",
    "MatPrecond",
    "TriInversePrecond",
    "FasterLeastSquaresParams",
    "faster_least_squares",
    "lsrn_least_squares",
    "cond_est",
    "CondEstParams",
    "CondEstResult",
    "RegressionProblem",
    "solve_regression",
    "RefineParams",
    "refine_least_squares",
    "asy_fcg",
    "randomized_block_gauss_seidel",
    "LOSSES",
    "REGULARIZERS",
    "get_loss",
    "get_regularizer",
]
