"""Least squares: exact l2 solvers, sketch-and-solve, and the
refine, Blendenpik, LSRN and exact routes (port of
``libskylark_tpu/linalg/least_squares.py``).

``approximate_least_squares`` sketches A and B columnwise once (FJLT by
default for dense input, sketch size 4·width) and solves the small
problem exactly.  Guarded (``SKYLARK_GUARD``, on by default) each sketch
is certified (``guard.certify_sketch``) and a bad draw climbs the
recovery ladder (fresh-seed resketch → grown sketch → the exact ``svd``
solve); attempt 0 uses the caller's context, so a healthy run is bitwise
the unguarded one.  ``route="refine"`` hands the problem to
``solvers.refine`` (mixed-precision refinement), ``"blendenpik"`` and
``"lsrn"`` to ``solvers.accelerated``, and ``"exact"`` solves by the SVD.

Every call consults the routing decision (``policy.consult``) and
returns it as ``info["policy"]``.  The port has no profile store yet,
so the decision is the JAX package's default one, with the caller's
pinned route and sketch fields (ROADMAP Queue A item 3b brings the
store, and with it the bf16- and fp8-first sketch branches that only a
profile can choose).  ``streaming_least_squares`` is the out-of-core
face: the same sketch-and-solve over ``(A_block, b_block)`` batches
(``streaming.sketch_least_squares``), JLT by default (FJLT has no
columnwise slice rule), CWT for sparse streams.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import guard, policy
from .._device import as_tensor
from ..core.context import SketchContext
from ..core.params import Params
from ..sketch.base import Dimension, create_sketch
from ..utils.exceptions import NumericalHealthError, UnsupportedError
from ..utils.sparse import is_sparse

__all__ = [
    "LeastSquaresParams",
    "exact_least_squares",
    "approximate_least_squares",
    "streaming_least_squares",
]

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
    """Least squares by sketching.  ``route`` is one of
    ``policy.LS_ROUTES``: None or ``"sketch"`` (sketch-and-solve with one
    sketch S of size s × m, then ``min ||SA X - SB||`` exactly),
    ``"refine"`` (:func:`~libskylark_tpu_torch.solvers.refine_least_squares`
    with the decision's sketch type and size), ``"blendenpik"`` or
    ``"lsrn"`` (sketch to precondition LSQR,
    :mod:`~libskylark_tpu_torch.solvers.accelerated`), ``"exact"`` (the
    ``svd`` solve of A itself, a sparse COO A densified).

    ``fault_plan`` (a :class:`~libskylark_tpu_torch.resilient.FaultPlan`)
    corrupts the sketched ``S·A`` of ladder attempt i on the sketch and
    refine routes (``nan_at``/``bad_sketch_at``).  With
    ``return_info=True`` returns ``(x, info)``: ``info["recovery"]`` is
    the guard's :class:`~libskylark_tpu_torch.guard.RecoveryReport` dict
    (``guarded=False`` under ``SKYLARK_GUARD=0``), ``info["policy"]`` the
    routing decision, and the refine, Blendenpik and LSRN routes add
    their solver's keys.  Sparse A is taken by the exact route only; the
    others raise :class:`UnsupportedError`, as the JAX package fails on
    them (ROADMAP Queue C)."""
    if route is not None and route not in policy.LS_ROUTES:
        raise ValueError(f"unknown least-squares route {route!r}; one of {policy.LS_ROUTES}")
    params = params or LeastSquaresParams()
    A = as_tensor(A, device)
    B = as_tensor(B, A.device if device is None else device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    m, n = A.shape
    sparse = is_sparse(A)
    decision = policy.consult(
        "ls", m=m, n=n, targets=B.shape[1], dtype=A.dtype, sparse=sparse, device=A.device,
        route=route, sketch_type=params.sketch_type, sketch_size=params.sketch_size)

    def finish(X, info):
        info["policy"] = decision.to_dict()
        out = X[:, 0] if squeeze else X
        return (out, info) if return_info else out

    if decision.route == "exact":
        X = exact_least_squares(A.to_dense() if sparse else A, B, alg="svd")
        if guard.enabled():
            report = guard.RecoveryReport(stage="sketch_and_solve_ls")
            guard.check_finite(X, "exact_ls", report=report)
        else:
            report = guard.RecoveryReport.disabled("sketch_and_solve_ls")
        return finish(X, {"recovery": report.to_dict()})
    if decision.route == "refine":
        from ..solvers.refine import RefineParams, refine_least_squares

        X, rinfo = refine_least_squares(
            A, B, context, RefineParams(sketch_type=decision.sketch_type,
                                        sketch_size=decision.sketch_size),
            fault_plan=fault_plan)
        return finish(X, dict(rinfo))
    if decision.route in ("blendenpik", "lsrn"):
        from ..solvers.accelerated import (
            FasterLeastSquaresParams,
            faster_least_squares,
            lsrn_least_squares,
        )

        solver = faster_least_squares if decision.route == "blendenpik" else lsrn_least_squares
        X, rinfo = solver(A, B, context, FasterLeastSquaresParams(sketch_type=params.sketch_type))
        return finish(X, dict(rinfo))
    if sparse:
        raise UnsupportedError(
            "sparse least-squares inputs are not supported: the JAX "
            "package's approximate_least_squares cannot solve a BCOO system "
            "either (its hash sketch returns a sparse SA that "
            "exact_least_squares does not take; ROADMAP Queue C)"
        )
    s, stype = decision.sketch_size, decision.sketch_type

    if not guard.enabled():
        S = create_sketch(stype, m, s, context)
        SA = S.apply(A, Dimension.COLUMNWISE)
        SB = S.apply(B, Dimension.COLUMNWISE)
        if fault_plan is not None:
            SA = fault_plan.corrupt_sketch(0, SA)
        X = exact_least_squares(SA, SB, alg=alg)
        return finish(X, {"recovery": guard.RecoveryReport.disabled(
            "sketch_and_solve_ls").to_dict()})

    def attempt(ctx, s_i, i):
        S = create_sketch(stype, m, s_i, ctx)
        SA = S.apply(A, Dimension.COLUMNWISE)
        SB = S.apply(B, Dimension.COLUMNWISE)
        if fault_plan is not None:
            SA = fault_plan.corrupt_sketch(i, SA)
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
    return finish(X, {"recovery": report.to_dict()})


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
    ``rows``, ``batches``, ``seconds``, ``recovery`` and ``policy`` (the
    routing decision, kind ``"ls_stream"``).  ``partition=``
    raises ``UnsupportedError`` (ROADMAP Queue A item 9)."""
    from .. import streaming
    from ..streaming.drivers import _no_partition
    from ..streaming.engine import StreamParams, stream_device

    _no_partition(partition)  # before the stream's device is resolved
    params = params or LeastSquaresParams()
    decision = policy.consult(
        "ls_stream", m=nrows, n=ncols, targets=targets, dtype="float32", sparse=sparse,
        device=stream_device(stream_params or StreamParams()), sketch_type=params.sketch_type,
        sketch_size=params.sketch_size)
    S = create_sketch(decision.sketch_type, nrows, decision.sketch_size, context)
    return streaming.sketch_least_squares(
        source, S, ncols=ncols, targets=targets, alg=alg, params=stream_params,
        fault_plan=fault_plan, partition=partition, policy_decision=decision.to_dict())
