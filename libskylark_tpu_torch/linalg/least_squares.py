"""Least squares: exact l2 solvers and sketch-and-solve (port of
``libskylark_tpu/linalg/least_squares.py``).

``approximate_least_squares`` sketches A and B columnwise once (FJLT by
default for dense input, sketch size 4·width) and solves the small
problem exactly.  This slice has no guard ladder, policy store or plan
cache, so it returns what the JAX function returns under
``SKYLARK_GUARD=0`` and ``SKYLARK_POLICY=0`` — which, with an empty
policy store and a healthy sketch, is also its default result.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.params import Params
from ..sketch.base import Dimension, create_sketch
from ..utils.exceptions import NumericalHealthError, UnsupportedError

__all__ = [
    "LeastSquaresParams",
    "exact_least_squares",
    "approximate_least_squares",
]

# Routes of the JAX package that wait for later slices, with the ROADMAP
# item that ports them.
_DEFERRED_ROUTES = {
    "refine": "ROADMAP Queue A: guard, policy and plans around "
              "approximate_least_squares (mixed-precision refine)",
    "blendenpik": "ROADMAP Queue A: randomized NLA (Blendenpik/LSRN)",
    "lsrn": "ROADMAP Queue A: randomized NLA (Blendenpik/LSRN)",
    "exact": "ROADMAP Queue A: guard, policy and plans around "
             "approximate_least_squares (policy-chosen exact route)",
}


@dataclass
class LeastSquaresParams(Params):
    """Sketch choice and size (≙ ``nla/least_squares.hpp`` params)."""

    sketch_type: str | None = None  # None → FJLT (dense input)
    sketch_size: int | None = None  # default 4 * width


def _svd_lstsq(A, B):
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    cutoff = torch.finfo(A.dtype).eps * max(A.shape) * s[0]
    sinv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return Vh.T @ (sinv[:, None] * (U.T @ B))


def exact_least_squares(A, B, alg: str = "qr", *, device=None):
    """Solve ``min_X ||A X - B||_F`` for tall A; returns X (n, k), or
    (n,) for a vector B.  ``alg`` ∈ {"qr", "sne", "ne", "svd"}.  ``ne``
    raises :class:`NumericalHealthError` when the Gram matrix has no
    finite Cholesky factor (the JAX package's ``SKYLARK_GUARD=0``
    behaviour)."""
    A = as_tensor(A, device)
    B = as_tensor(B, A.device if device is None else device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if alg == "qr":
        Q, R = torch.linalg.qr(A, mode="reduced")
        X = torch.linalg.solve_triangular(R, Q.T @ B, upper=True)
    elif alg == "sne":
        R = torch.linalg.qr(A, mode="r")[1]
        Y = torch.linalg.solve_triangular(R.T, A.T @ B, upper=False)
        X = torch.linalg.solve_triangular(R, Y, upper=True)
    elif alg == "ne":
        L, info = torch.linalg.cholesky_ex(A.T @ A)
        if int(info) != 0 or not bool(torch.isfinite(L).all()):
            raise NumericalHealthError(
                "Cholesky of the Gram matrix failed (singular or indefinite) "
                "in exact_least_squares(alg='ne')",
                stage="exact_ls_ne",
            )
        X = torch.cholesky_solve(A.T @ B, L)
    elif alg == "svd":
        X = _svd_lstsq(A, B)
    else:
        raise ValueError(f"unknown exact LS alg {alg!r}")
    return X[:, 0] if squeeze else X


def approximate_least_squares(
    A,
    B,
    context: SketchContext,
    params: LeastSquaresParams | None = None,
    alg: str = "qr",
    *,
    route: str | None = None,
    device=None,
):
    """Sketch-and-solve LS: sketch the rows of (A, B) with one sketch
    S (size s × m), then solve ``min ||SA X - SB||`` exactly.

    ``route`` may be None or ``"sketch"``; the JAX package's other routes
    raise :class:`UnsupportedError` (a ``NotImplementedError``) naming
    the ROADMAP item that ports them."""
    if route not in (None, "sketch"):
        if route in _DEFERRED_ROUTES:
            raise UnsupportedError(
                f"least-squares route {route!r} is not ported yet "
                f"({_DEFERRED_ROUTES[route]})"
            )
        raise ValueError(f"unknown least-squares route {route!r}")
    params = params or LeastSquaresParams()
    A = as_tensor(A, device)
    B = as_tensor(B, A.device if device is None else device)
    if A.layout != torch.strided:
        raise UnsupportedError(
            "sparse least-squares inputs are not supported: the JAX "
            "package's approximate_least_squares cannot solve a BCOO system "
            "either (its hash sketch returns a sparse SA that "
            "exact_least_squares does not take; ROADMAP Queue C)"
        )
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    m, n = A.shape
    s = params.sketch_size if params.sketch_size is not None else min(4 * n, m)
    stype = params.sketch_type or "FJLT"
    S = create_sketch(stype, m, int(s), context)
    SA = S.apply(A, Dimension.COLUMNWISE)
    SB = S.apply(B, Dimension.COLUMNWISE)
    X = exact_least_squares(SA, SB, alg=alg)
    return X[:, 0] if squeeze else X
