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

Every call consults the policy layer (``policy.consult``) and returns
its decision as ``info["policy"]``.  With no profile store, or on a key
the store has not matured, that is the default decision with the
caller's pinned fields; a matured key may reroute to ``exact``,
``blendenpik``/``lsrn`` or ``refine``, shrink the sketch, or sketch a
bf16 copy of A, or one rounded to e4m3 (``core.round_to_e4m3``) and
lifted to bf16, escalating to A itself when attempt 0 does not certify
OK.  Each routed solve then records what it saw (``policy.observe``)
and closes with ``telemetry.run_summary``, which writes the observation
to the store (``policy.flush``) and, with telemetry on, ledgers the
run's info beside the registry's snapshot.
A row-sharded A (:class:`~libskylark_tpu_torch.parallel.mesh.Sharded`)
takes every route slot by slot (``parallel.routes``): the sketch merged
by one psum, the exact solves through the TSQR of the slots' R factors,
refinement's and LSQR's products per slot; B is laid out on slot 0's
device.
``streaming_least_squares`` is the out-of-core face: the same
sketch-and-solve over ``(A_block, b_block)`` batches
(``streaming.sketch_least_squares``), JLT by default (FJLT has no
columnwise slice rule), CWT for sparse streams.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import torch

from .. import guard, plans, policy, telemetry
from .._device import is_sharded
from ..core.context import SketchContext
from ..core.params import Params
from ..core.precision import fp8_dtype, round_to_e4m3
from ..parallel import routes
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


def _exact_sharded(A, B, alg: str):
    """:func:`exact_least_squares` of a row-sharded A: ``qr`` and ``svd``
    through the TSQR of the slots' R factors, ``sne`` with its R, ``ne``
    on the psum'd Gram; every Aᵀ·B a psum in slot order."""
    Bs = routes.split_rows(B, A)
    if alg == "qr":
        Q, R = routes.tsqr(A)
        return torch.linalg.solve_triangular(R, routes.rmatmul(Q, Bs), upper=True)
    if alg == "sne":
        R = routes.tsqr(A)[1]
        Y = torch.linalg.solve_triangular(R.T, routes.rmatmul(A, Bs), upper=False)
        return torch.linalg.solve_triangular(R, Y, upper=True)
    if alg == "ne":
        L, info = torch.linalg.cholesky_ex(routes.tsum(lambda a: a.T @ a, A))
        if int(info) == 0 and bool(torch.isfinite(L).all()):
            return torch.cholesky_solve(routes.rmatmul(A, Bs), L)
        if not guard.enabled():
            raise NumericalHealthError(
                "Cholesky of the Gram matrix failed (singular or indefinite) "
                "in exact_least_squares(alg='ne')",
                stage="exact_ls_ne",
            )
    elif alg != "svd":
        raise ValueError(f"unknown exact LS alg {alg!r}")
    U, s, Vh = routes.dense_svd(A)
    cutoff = torch.finfo(A.dtype).eps * max(A.shape) * s[0]
    sinv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return Vh.T @ (sinv[:, None] * routes.rmatmul(U, Bs))


def exact_least_squares(A, B, alg: str = "qr", *, device=None):
    """Solve ``min_X ||A X - B||_F`` for tall A; returns X (n, k), or
    (n,) for a vector B.  ``alg`` ∈ {"qr", "sne", "ne", "svd"}.  When the
    Gram matrix of ``ne`` has no finite Cholesky factor, the guard
    reroutes to the ``svd`` pseudoinverse; under ``SKYLARK_GUARD=0`` it
    raises :class:`NumericalHealthError` instead.  A row-sharded A runs
    slot by slot (:func:`_exact_sharded`); X is on slot 0's device."""
    A, B = routes.operands(A, B, device)
    squeeze = B.ndim == 1
    if is_sharded(A):
        X = _exact_sharded(A, B[:, None] if squeeze else B, alg)
        return X[:, 0] if squeeze else X
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


def _ls_solve_span(fn):
    """``fn`` run inside the span ``ls.solve``."""

    @functools.wraps(fn)
    def solve(*args, **kwargs):
        with telemetry.span("ls.solve"):
            return fn(*args, **kwargs)

    return solve


@_ls_solve_span
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
    ``policy.LS_ROUTES``: None (the policy decides; with nothing learned,
    ``"sketch"``), ``"sketch"`` (sketch-and-solve with one sketch S of
    size s × m, then ``min ||SA X - SB||`` exactly), ``"refine"``
    (:func:`~libskylark_tpu_torch.solvers.refine_least_squares` with the
    decision's sketch type and size), ``"blendenpik"`` or ``"lsrn"``
    (sketch to precondition LSQR,
    :mod:`~libskylark_tpu_torch.solvers.accelerated`), ``"exact"`` (the
    ``svd`` solve of A itself, a sparse COO A densified).  A pinned
    route, ``sketch_type`` or ``sketch_size`` always wins over the
    store.

    ``fault_plan`` (a :class:`~libskylark_tpu_torch.resilient.FaultPlan`)
    corrupts the sketched ``S·A`` of ladder attempt i on the sketch and
    refine routes (``nan_at``/``bad_sketch_at``).  With
    ``return_info=True`` returns ``(x, info)``: ``info["recovery"]`` is
    the guard's :class:`~libskylark_tpu_torch.guard.RecoveryReport` dict
    (``guarded=False`` under ``SKYLARK_GUARD=0``), ``info["policy"]`` the
    routing decision (``escalated`` when a bf16- or fp8-first sketch
    did not certify and the solve was redone from A), and the refine,
    Blendenpik and LSRN routes add their solver's keys.  Sparse A is
    taken by the exact route only; the others raise
    :class:`UnsupportedError`, as the JAX package fails on them
    (ROADMAP Queue C).  The call is the span ``ls.solve``, the root of
    its layers' spans."""
    if route is not None and route not in policy.LS_ROUTES:
        raise ValueError(f"unknown least-squares route {route!r}; one of {policy.LS_ROUTES}")
    params = params or LeastSquaresParams()
    A, B = routes.operands(A, B, device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    m, n = A.shape
    sparse = is_sparse(A)
    guard_on = guard.enabled()
    with telemetry.span("policy.consult"):
        decision = policy.consult(
            "ls", m=m, n=n, targets=B.shape[1], dtype=A.dtype, sparse=sparse,
            device=routes.device0(A),
            route=route, sketch_type=params.sketch_type, sketch_size=params.sketch_size,
            guard_on=guard_on)
    default_size = min(4 * n, m)

    def finish(X, info, record=True, **obs):
        """Attach the decision, record the run in the store, close the run
        (the unrecorded, unguarded solve only when it returns its info,
        as the JAX package does), return."""
        info["policy"] = decision.to_dict()
        if record:
            policy.observe(decision, info, default_size=default_size, **obs)
        if record or return_info:
            telemetry.run_summary("sketch_and_solve_ls", info)
        out = X[:, 0] if squeeze else X
        return (out, info) if return_info else out

    if decision.route == "exact":
        X = exact_least_squares(A.to_dense() if sparse else A, B, alg="svd")
        if guard_on:
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
        return finish(X, dict(rinfo), refine=rinfo.get("refine"))
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

    if not guard_on:
        S = create_sketch(stype, m, s, context)
        # Plan-cached applies: repeated solves at one shape (parameter
        # sweeps, restarts) replay one captured graph.
        SA = plans.apply(S, A, Dimension.COLUMNWISE)
        SB = plans.apply(S, B, Dimension.COLUMNWISE)
        if fault_plan is not None:
            SA = fault_plan.corrupt_sketch(0, SA)
        with telemetry.span("dense.solve"):
            X = exact_least_squares(SA, SB, alg=alg)
        return finish(X, {"recovery": guard.RecoveryReport.disabled(
            "sketch_and_solve_ls").to_dict()}, record=False)

    def run_guarded(A_in, lift):
        """One trip up the guard's ladder sketching ``A_in``; ``lift``
        casts a narrow ``S·A_in`` to B's dtype before the certificate and
        the small solve.  The dense fallback solves the caller's A."""

        def attempt(ctx, s_i, i):
            S = create_sketch(stype, m, s_i, ctx)
            SA = plans.apply(S, A_in, Dimension.COLUMNWISE)
            SB = plans.apply(S, B, Dimension.COLUMNWISE)
            if lift:
                SA = SA.to(B.dtype)
            if fault_plan is not None:
                SA = fault_plan.corrupt_sketch(i, SA)
            cert = guard.certify_sketch(SA, stage="sketch_and_solve_ls")
            if not cert.ok:
                return None, cert
            with telemetry.span("dense.solve"):
                X = exact_least_squares(SA, SB, alg=alg)
            if not guard.tree_all_finite(X):
                return None, replace(cert, verdict=guard.RESKETCH,
                                     detail="non-finite small-problem solution")
            return X, cert

        return guard.run_ladder("sketch_and_solve_ls", context, s, m, attempt,
                                lambda: exact_least_squares(A, B, alg="svd"))

    def ok0(report):
        return bool(report.attempts) and report.attempts[0].verdict == guard.OK

    notes = {}
    if decision.compute_dtype in ("float8_e4m3fn", "bfloat16"):
        # The narrow rung: sketch A rounded to e4m3 and lifted to bf16
        # (the fp8 rung's precision on the bf16 kernels), or A in bf16.
        # Attempt 0 not certified OK escalates the whole solve to A and
        # records the rung's failure, which retires it for this key.
        fp8 = decision.compute_dtype == "float8_e4m3fn"
        report = None
        if not fp8:
            X, report = run_guarded(routes.map_shards(A, lambda t: t.to(torch.bfloat16)), True)
        elif fp8_dtype() is not None:
            X, report = run_guarded(
                routes.map_shards(A, lambda t: round_to_e4m3(t).to(torch.bfloat16)), True)
        if report is None or not ok0(report):
            decision.escalated = True
            notes["fp8" if fp8 else "bf16"] = "fail"
            X, report = run_guarded(A, False)
    else:
        X, report = run_guarded(A, False)
    return finish(X, {"recovery": report.to_dict()}, **notes)


def streaming_least_squares(source, nrows: int, ncols: int, context: SketchContext,
                            params: LeastSquaresParams | None = None, alg: str = "qr", *,
                            targets: int = 1, sparse: bool = False, stream_params=None,
                            fault_plan=None, partition=None):
    """Out-of-core sketch-and-solve least squares over ``(A_block,
    b_block)`` batches: ``S·A`` and ``S·b`` accumulate per batch, so A is
    never resident.  ``params`` pins the sketch: ``sketch_type``
    (default JLT, CWT for a ``sparse`` stream) and ``sketch_size``
    (default ``min(4·ncols, nrows)``, which a matured profile may
    shrink).  ``nrows``/``ncols`` are A's global shape (the rows address
    the sketch's counter stream).  ``stream_params`` is a
    :class:`~libskylark_tpu_torch.streaming.StreamParams` (prefetch,
    placer, checkpoint/resume); ``fault_plan`` injects the guard's
    faults by batch index.  Returns ``(x, info)`` with ``info`` keys
    ``rows``, ``batches``, ``seconds``, ``recovery`` and ``policy`` (the
    routing decision, kind ``"ls_stream"``); the run's rows per second
    go into the store's ``throughput``.  ``partition`` (a
    :class:`~libskylark_tpu_torch.streaming.RowPartition`) selects the
    multi-process elastic path: every rank of the ``torch.distributed``
    world calls this with the same arguments, each folds its own row
    range, and the merged ``(x, info)`` is the same on every rank."""
    from .. import streaming
    from ..streaming.engine import StreamParams, stream_device

    params = params or LeastSquaresParams()
    decision = policy.consult(
        "ls_stream", m=nrows, n=ncols, targets=targets, dtype="float32", sparse=sparse,
        device=stream_device(stream_params or StreamParams()), sketch_type=params.sketch_type,
        sketch_size=params.sketch_size, guard_on=guard.enabled())
    S = create_sketch(decision.sketch_type, nrows, decision.sketch_size, context)
    x, info = streaming.sketch_least_squares(
        source, S, ncols=ncols, targets=targets, alg=alg, params=stream_params,
        fault_plan=fault_plan, partition=partition, policy_decision=decision.to_dict())
    seconds = info.get("seconds") or 0.0
    policy.observe(decision, info, default_size=min(4 * ncols, nrows),
                   rows_per_s=(info.get("rows", 0) / seconds) if seconds else None,
                   batches=info.get("batches"))
    # The driver's run_summary (the run's terminal ledger event, carrying
    # info["policy"]) fired before this observation existed; flush it
    # now, as the JAX package does, so it reaches the store exactly once.
    policy.flush("streaming_lsq", info)
    return x, info
