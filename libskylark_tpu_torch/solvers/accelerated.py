"""Sketch-to-precondition least squares: Blendenpik and LSRN (port of
``libskylark_tpu/solvers/accelerated.py``, ≙ ``algorithms/regression/
accelerated_linearl2_regression_solver_Elemental.hpp`` and
``FasterLeastSquares``, ``nla/least_squares.hpp:237-314``).

- Blendenpik: S·A (a columnwise sketch to s × n) → QR → R⁻¹ as the right
  preconditioner of LSQR; a bad 1-norm condition estimate of R doubles
  the sketch and retries, then falls back to the exact SVD solve.
- LSRN: SVD of S·A → N = V·Σ⁻¹ as the right preconditioner of LSQR.

Sparse A is refused: the JAX package fails on it too (its QR and SVD of
the BCOO sketch S·A; ROADMAP Queue C).  A row-sharded A
(:class:`~libskylark_tpu_torch.parallel.mesh.Sharded`) is sketched slot
by slot and merged by one psum, and LSQR's products run per slot
(``parallel.routes``).  Each solve closes its run with
``telemetry.run_summary``; its sketch, QR and condition estimate are the
spans ``sketch.apply``, ``dense.qr`` and ``guard.certify``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import guard, telemetry
from ..core.context import SketchContext
from ..core.params import Params
from ..parallel import routes
from ..sketch.base import Dimension, create_sketch
from ..utils.exceptions import UnsupportedError
from ..utils.sparse import is_sparse
from .krylov import KrylovParams, lsqr
from .precond import MatPrecond, TriInversePrecond

__all__ = [
    "FasterLeastSquaresParams",
    "faster_least_squares",
    "lsrn_least_squares",
]


@dataclass
class FasterLeastSquaresParams(Params):
    """Knobs ≙ the reference's blendenpik/lsrn params structs."""

    # None → FJLT for Blendenpik, JLT for LSRN (dense A).
    sketch_type: str | None = None
    gamma: float = 4.0  # sketch rows = gamma * n
    max_attempts: int = 3  # re-sketch retries (≙ :241-252)
    cond_threshold: float | None = None  # default 1/(10·eps^(1/2))
    krylov: KrylovParams | None = None


def _inputs(A, B, device, solver: str):
    # A row-sharded A: the sketch is merged by psum and LSQR's products
    # run per slot (parallel.routes); B is laid out on slot 0's device.
    A, B = routes.operands(A, B, device)
    if is_sparse(A):
        raise UnsupportedError(
            f"{solver} of a sparse A is not supported: the JAX package fails on it "
            "too (its factorization of the sparse sketch S·A; ROADMAP Queue C)")
    return A, B


def _sketch_once(A, s, sketch_type, context):
    with telemetry.span("sketch.apply"):
        return create_sketch(sketch_type, A.shape[0], s, context).apply(A, Dimension.COLUMNWISE)


def _tri_condest(R: torch.Tensor) -> float:
    """1-norm condition estimate of upper-triangular R, ≙ the reference's
    ``utcondest`` (``accelerated_...Elemental.hpp:25-66``): ‖R‖₁·‖R⁻¹‖₁,
    R⁻¹ by a triangular solve against the identity."""
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    one_norm = lambda M: torch.max(torch.sum(torch.abs(M), dim=0))
    return float(one_norm(R) * one_norm(Rinv))


def faster_least_squares(A, B, context: SketchContext,
                         params: FasterLeastSquaresParams | None = None, *, device=None):
    """Blendenpik: near machine-precision LS at sketch-and-solve speed.

    Returns ``(X, info)``: ``info["iterations"]``, ``"flag"`` and
    ``"resid"`` from LSQR, ``"attempts"`` (sketches drawn),
    ``"condest"`` (of the last R) and ``"recovery"``, the guard ledger of
    the retry loop (``guarded=False`` under ``SKYLARK_GUARD=0``, where the
    Blendenpik retry loop, the paper's own mechanism, still runs).
    """
    params = params or FasterLeastSquaresParams()
    A, B = _inputs(A, B, device, "faster_least_squares")
    m, n = A.shape
    if m < n:
        raise ValueError(f"faster_least_squares needs tall A, got {tuple(A.shape)}")
    threshold = params.cond_threshold or 0.1 / math.sqrt(torch.finfo(A.dtype).eps)
    guarded = guard.enabled()
    report = (guard.RecoveryReport(stage="blendenpik") if guarded
              else guard.RecoveryReport.disabled("blendenpik"))
    stype = params.sketch_type or "FJLT"
    gamma = params.gamma
    for attempt in range(1, params.max_attempts + 1):
        s = min(int(gamma * n), m)
        SA = _sketch_once(A, s, stype, context)
        with telemetry.span("dense.qr"):
            R = torch.linalg.qr(SA, mode="r")[1]
        # The preconditioner's 1-norm condition estimate, the quantity the
        # reference's retry loop reads (accelerated_...Elemental.hpp:68-77).
        with telemetry.span("guard.certify"):
            cond = _tri_condest(R)
            good = math.isfinite(cond) and cond < threshold
        report.record("initial" if attempt == 1 else "grow",
                      verdict=guard.OK if good else guard.RESKETCH, cond=cond, sketch_size=s,
                      detail="" if good else f"utcondest {cond:.3e} >= {threshold:.3e}")
        if good:
            report.recovered = attempt > 1
            break
        gamma *= 2  # re-sketch larger (accelerated_...hpp:241-252)
    if not good:
        # Every preconditioner was bad: the exact SVD solve, as the
        # reference does after its retry budget (accelerated_...hpp:247-280).
        from ..linalg.least_squares import exact_least_squares

        X = exact_least_squares(A, B, alg="svd")
        report.record("fallback", verdict=guard.FALLBACK, detail="exact svd solve")
        report.recovered = True
        info = {"attempts": attempt, "condest": cond, "fallback": "svd", "iterations": 0,
                "recovery": report.to_dict()}
        telemetry.run_summary("blendenpik", info)
        return X, info
    X, info = lsqr(A, B, precond=TriInversePrecond(R, lower=False), params=params.krylov)
    if guarded:
        guard.check_finite(X, "blendenpik_lsqr", report=report)
    info["attempts"] = attempt
    info["condest"] = cond
    info["recovery"] = report.to_dict()
    telemetry.run_summary("blendenpik", info)
    return X, info


def lsrn_least_squares(A, B, context: SketchContext,
                       params: FasterLeastSquaresParams | None = None, *, device=None):
    """LSRN: SVD-based preconditioning, robust for rank-deficient A
    (≙ the ``lsrn_tag`` branch, ``accelerated_...Elemental.hpp:96-160``).

    Returns ``(X, info)``; guarded, a non-finite sketch climbs one
    fresh-seed resketch before the solve, the solution passes a
    finiteness sentinel and ``info["recovery"]`` records the attempts.
    """
    params = params or FasterLeastSquaresParams()
    A, B = _inputs(A, B, device, "lsrn_least_squares")
    m, n = A.shape
    s = min(int(params.gamma * n), m)
    # LSRN wants a Gaussian-like sketch for its SVD preconditioner.
    stype = params.sketch_type or "JLT"
    guarded = guard.enabled()
    report = (guard.RecoveryReport(stage="lsrn") if guarded
              else guard.RecoveryReport.disabled("lsrn"))
    SA = _sketch_once(A, s, stype, context)
    if guarded and not guard.tree_all_finite(SA):
        # The SVD preconditioner absorbs ill conditioning by design: the
        # one sketch pathology worth guarding is non-finiteness.
        report.record("initial", verdict=guard.RESKETCH, sketch_size=s,
                      detail="non-finite sketch output")
        SA = _sketch_once(A, s, stype, guard.derived_context(context, 1))
        report.record("resketch", verdict=guard.OK, sketch_size=s)
        guard.check_finite(SA, "lsrn_sketch", report=report)
        report.recovered = True
    elif guarded:
        report.record("initial", verdict=guard.OK, sketch_size=s)
    _, sv, Vt = torch.linalg.svd(SA, full_matrices=False)
    cutoff = sv[0] * torch.finfo(sv.dtype).eps * max(SA.shape)
    sinv = torch.where(sv > cutoff, 1.0 / sv, torch.zeros_like(sv))
    N = Vt.T * sinv[None, :]  # V·Σ⁻¹
    X, info = lsqr(A, B, precond=MatPrecond(N), params=params.krylov)
    if guarded:
        guard.check_finite(X, "lsrn_lsqr", report=report)
    info["recovery"] = report.to_dict()
    telemetry.run_summary("lsrn", info)
    return X, info
