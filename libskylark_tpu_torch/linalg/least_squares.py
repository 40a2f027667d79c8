"""Least squares: exact l2 solvers, sketch-and-solve, and the
Blendenpik and LSRN routes (port of
``libskylark_tpu/linalg/least_squares.py``).

``approximate_least_squares`` sketches A and B columnwise once (FJLT by
default for dense input, sketch size 4·width) and solves the small
problem exactly.  Guarded (``SKYLARK_GUARD``, on by default) each sketch
is certified (``guard.certify_sketch``) and a bad draw climbs the
recovery ladder (fresh-seed resketch → grown sketch → the exact ``svd``
solve); attempt 0 uses the caller's context, so a healthy run is bitwise
the unguarded one.  ``route="blendenpik"`` and ``"lsrn"`` hand the
problem to ``solvers.accelerated``.

This slice has no policy store or plan cache (ROADMAP Queue A item 3),
so a call returns what the JAX package returns under
``SKYLARK_POLICY=0``: with an empty store that is also its default.
``info`` has no ``"policy"`` entry, and the ``"refine"`` and ``"exact"``
routes and ``fault_plan=`` raise ``UnsupportedError``.
``streaming_least_squares`` is the out-of-core face: the same
sketch-and-solve over ``(A_block, b_block)`` batches
(``streaming.sketch_least_squares``), JLT by default (FJLT has no
columnwise slice rule), CWT for sparse streams.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import guard
from .._device import as_tensor
from ..core.context import SketchContext
from ..core.params import Params
from ..sketch.base import Dimension, create_sketch
from ..utils.exceptions import NumericalHealthError, UnsupportedError

__all__ = [
    "LeastSquaresParams",
    "exact_least_squares",
    "approximate_least_squares",
    "streaming_least_squares",
]

_ITEM3 = "ROADMAP Queue A item 3: policy, plans and refine around approximate_least_squares"
# Routes of the JAX package that wait for a later slice, with the ROADMAP
# item that ports them.
_DEFERRED_ROUTES = {
    "refine": f"{_ITEM3} (mixed-precision refine)",
    "exact": f"{_ITEM3} (policy-chosen exact route)",
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
    (n,) for a vector B.  ``alg`` ∈ {"qr", "sne", "ne", "svd"}.  When the
    Gram matrix of ``ne`` has no finite Cholesky factor, the guard
    reroutes to the ``svd`` pseudoinverse; under ``SKYLARK_GUARD=0`` it
    raises :class:`NumericalHealthError` instead."""
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
        if int(info) == 0 and bool(torch.isfinite(L).all()):
            X = torch.cholesky_solve(A.T @ B, L)
        elif guard.enabled():
            X = _svd_lstsq(A, B)
        else:
            raise NumericalHealthError(
                "Cholesky of the Gram matrix failed (singular or indefinite) "
                "in exact_least_squares(alg='ne')",
                stage="exact_ls_ne",
            )
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
    fault_plan=None,
    return_info: bool = False,
    device=None,
):
    """Least squares by sketching: ``route`` None or ``"sketch"``
    (sketch-and-solve with one sketch S of size s × m, then ``min ||SA X
    - SB||`` exactly), ``"blendenpik"`` or ``"lsrn"`` (sketch to
    precondition LSQR, :mod:`~libskylark_tpu_torch.solvers.accelerated`).

    With ``return_info=True`` returns ``(x, info)``; ``info["recovery"]``
    is the guard's :class:`~libskylark_tpu_torch.guard.RecoveryReport`
    dict (``guarded=False`` under ``SKYLARK_GUARD=0``), and the
    Blendenpik and LSRN routes add their solver's keys.  The JAX
    package's ``"refine"`` and ``"exact"`` routes and ``fault_plan``
    raise :class:`UnsupportedError` (a ``NotImplementedError``) naming
    the ROADMAP item that ports them."""
    if route not in (None, "sketch", "blendenpik", "lsrn"):
        if route in _DEFERRED_ROUTES:
            raise UnsupportedError(
                f"least-squares route {route!r} is not ported yet "
                f"({_DEFERRED_ROUTES[route]})"
            )
        raise ValueError(f"unknown least-squares route {route!r}")
    if fault_plan is not None:
        raise UnsupportedError(f"fault_plan= is not ported yet ({_ITEM3})")
    params = params or LeastSquaresParams()
    A = as_tensor(A, device)
    B = as_tensor(B, A.device if device is None else device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if route in ("blendenpik", "lsrn"):
        from ..solvers.accelerated import (
            FasterLeastSquaresParams,
            faster_least_squares,
            lsrn_least_squares,
        )

        solver = faster_least_squares if route == "blendenpik" else lsrn_least_squares
        X, info = solver(A, B, context, FasterLeastSquaresParams(sketch_type=params.sketch_type))
        out = X[:, 0] if squeeze else X
        return (out, info) if return_info else out
    if A.layout != torch.strided:
        raise UnsupportedError(
            "sparse least-squares inputs are not supported: the JAX "
            "package's approximate_least_squares cannot solve a BCOO system "
            "either (its hash sketch returns a sparse SA that "
            "exact_least_squares does not take; ROADMAP Queue C)"
        )
    m, n = A.shape
    s = int(params.sketch_size if params.sketch_size is not None else min(4 * n, m))
    stype = params.sketch_type or "FJLT"

    if not guard.enabled():
        S = create_sketch(stype, m, s, context)
        X = exact_least_squares(S.apply(A, Dimension.COLUMNWISE),
                                S.apply(B, Dimension.COLUMNWISE), alg=alg)
        report = guard.RecoveryReport.disabled("sketch_and_solve_ls")
    else:
        def attempt(ctx, s_i, i):
            S = create_sketch(stype, m, s_i, ctx)
            SA = S.apply(A, Dimension.COLUMNWISE)
            SB = S.apply(B, Dimension.COLUMNWISE)
            cert = guard.certify_sketch(SA, stage="sketch_and_solve_ls")
            if not cert.ok:
                return None, cert
            X = exact_least_squares(SA, SB, alg=alg)
            if not guard.tree_all_finite(X):
                return None, replace(cert, verdict=guard.RESKETCH,
                                     detail="non-finite small-problem solution")
            return X, cert

        X, report = guard.run_ladder(
            "sketch_and_solve_ls", context, s, m, attempt,
            lambda: exact_least_squares(A, B, alg="svd"))
    out = X[:, 0] if squeeze else X
    return (out, {"recovery": report.to_dict()}) if return_info else out


def streaming_least_squares(source, nrows: int, ncols: int, context: SketchContext,
                            params: LeastSquaresParams | None = None, alg: str = "qr", *,
                            targets: int = 1, sparse: bool = False, stream_params=None,
                            fault_plan=None, partition=None):
    """Out-of-core sketch-and-solve least squares over ``(A_block,
    b_block)`` batches: ``S·A`` and ``S·b`` accumulate per batch, so A is
    never resident.  ``params`` picks the sketch as the JAX package's
    default decision does: ``sketch_type`` (default JLT, CWT for a
    ``sparse`` stream) and ``sketch_size`` (default ``min(4·ncols,
    nrows)``).  ``nrows``/``ncols`` are A's global shape (the rows address
    the sketch's counter stream).  ``stream_params`` is a
    :class:`~libskylark_tpu_torch.streaming.StreamParams` (prefetch,
    placer, checkpoint/resume); ``fault_plan`` injects the guard's
    faults by batch index.  Returns ``(x, info)`` with ``info`` keys
    ``rows``, ``batches``, ``seconds`` and ``recovery``; ``info["policy"]``
    waits for the policy layer (ROADMAP Queue A item 3).  ``partition=``
    raises ``UnsupportedError`` (ROADMAP Queue A item 9)."""
    from .. import streaming

    params = params or LeastSquaresParams()
    stype = params.sketch_type or ("CWT" if sparse else "JLT")
    s = int(params.sketch_size if params.sketch_size is not None
            else min(4 * ncols, nrows))
    S = create_sketch(stype, nrows, s, context)
    return streaming.sketch_least_squares(
        source, S, ncols=ncols, targets=targets, alg=alg, params=stream_params,
        fault_plan=fault_plan, partition=partition)
