"""Sketch-preconditioned mixed-precision iterative refinement for least
squares (port of ``libskylark_tpu/solvers/refine.py``).

The factorization runs at a low working precision: the QR of the
sketched ``S·A``, with S applied to a bf16 copy of A and the QR in f32
where ``core.precision.f32_accumulable`` allows the input dtype, and
to an f32 copy otherwise (f64 input).  Refinement sweeps then recover
f64 accuracy:

    r_k = b - A x_k                      (f64: the only f64 matvecs)
    z_k = R⁻¹ R⁻ᵀ (Aᵀ r_k)              (two triangular solves in f32)
    x_{k+1} = x_k + θ_k p_k              (a conjugate-direction step)

that is, preconditioned CG on the normal equations with the sketched
factor as preconditioner, one direction per column of B.

Certification rides the guard ladder: attempt 0 certifies the computed
factor ``R`` (``guard.certify_sketch(R)``: R carries S·A's singular
values at an n × n probe cost, and a QR breakdown shows there).  The
gate is ``‖Aᵀr‖ ≤ rtol·σ_max·‖r‖`` (σ_max from the certificate) on a
freshly recomputed f64 residual, and a stagnation/divergence detector
turns the attempt into a RESKETCH verdict, so the ladder falls to a
fresh sketch, a grown one, and the exact dense ``svd`` solve.  Under
``SKYLARK_GUARD=0`` the detector raises
:class:`~libskylark_tpu_torch.utils.exceptions.RefinementError` (115).

The residual dtype is f64 always, as the JAX package computes it under
x64.  The JAX package's fixed-trip traced loop has no counterpart: the
port does not trace.  A row-sharded A
(:class:`~libskylark_tpu_torch.parallel.mesh.Sharded`) is sketched slot
by slot and its two matvecs a sweep run per slot, the residual laid out
on slot 0's device (``parallel.routes``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from .. import guard, plans
from ..core.context import SketchContext
from ..core.params import Params
from ..core.precision import f32_accumulable
from ..parallel import routes
from ..sketch.base import Dimension, create_sketch
from ..utils.exceptions import RefinementError, UnsupportedError
from ..utils.sparse import is_sparse
from .precond import TriInversePrecond

__all__ = ["RefineParams", "refine_least_squares"]

_STAGE = "refine_ls"

# Stagnation detector: this many consecutive sweeps without a
# stagnation_factor improvement over the best gate value trips it (the
# conjugate steps make single-sweep progress lumpy).
_STALL_LIMIT = 5
_DIVERGE_FACTOR = 100.0

_RDTYPE = torch.float64


@dataclass
class RefineParams(Params):
    """Knobs of the refine route (defaults as the sketch route's sizing)."""

    sketch_type: str | None = None  # None → FJLT
    sketch_size: int | None = None  # default 4 * n, floored at 2 * n
    max_iters: int = 100
    rtol: float | None = None  # gate: ||A'r|| <= rtol * sigma_max * ||r||
    stagnation_factor: float = 0.9


def _working_cast(A, dtype):
    """``(A_for_sketch, qr_dtype, rung)``: a bf16 sketch operand with an
    f32 QR where ``f32_accumulable`` takes the input dtype, f32 for both
    otherwise (f64 input is lowered only here, and only to f32)."""
    if f32_accumulable(dtype):
        return routes.map_shards(A, lambda t: t.to(torch.bfloat16)), torch.float32, "bf16+f32"
    return routes.map_shards(A, lambda t: t.to(torch.float32)), torch.float32, "f32"


def _solve_pair(precond, G, wdtype, rdtype):
    """One correction through the low-precision factor: the two
    triangular solves of ``(RᵀR) Z = G`` at working precision."""
    return precond.apply(precond.apply_adjoint(G.to(wdtype))).to(rdtype)


def _colsum(U, V):
    return torch.sum(U * V, dim=0)


def _matvec(A, V):
    """``A·V``; a row-sharded A's per slot, laid out in the mesh's row
    order on slot 0's device (``parallel.routes.linear_ops``)."""
    return routes.linear_ops(A)[0](V)


def _rmatvec(A, V):
    """``Aᵀ·V``.  cuBLAS takes the transposed row-major A as an operand
    flag of its GEMV/GEMM, with no copy, so the natural form runs at
    bandwidth on the card (the JAX package's ``(Vᵀ A)ᵀ`` rewrite works
    around a strided gather of XLA:CPU, which torch does not have).  A
    row-sharded A's is a psum of the slots' ``A_kᵀ·V_k``."""
    return routes.linear_ops(A)[1](V)


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _sweep(A, precond, wdtype, X, Rres, P, gz):
    """One conjugate-direction sweep: the two O(mn) matvecs, the
    incremental X and residual updates and the speculative next
    direction.  Returns the new state and the host's one read per sweep,
    ``[‖G‖, ‖r‖, ‖X‖]`` (the caller drops the speculative direction when
    it restarts or halts)."""
    W = _matvec(A, P)
    theta = _safe_div(gz, _colsum(W, W))
    X = X + theta[None, :] * P
    Rres = Rres - theta[None, :] * W
    G = _rmatvec(A, Rres)
    Z = _solve_pair(precond, G, wdtype, X.dtype)
    gz_new = _colsum(G, Z)
    beta = _safe_div(gz_new, gz)
    norms = torch.stack([torch.linalg.vector_norm(G), torch.linalg.vector_norm(Rres),
                         torch.linalg.vector_norm(X)]).tolist()
    return X, Rres, G, Z + beta[None, :] * P, gz_new, norms


def _refine_loop(A, B, R, *, sigma_max, rtol, max_iters, stagnation_factor):
    """Host-driven refinement sweeps; returns ``(X, stats)`` where
    ``stats["halt"]`` is ``converged``, ``stagnated`` or ``diverged``.

    Residuals are updated incrementally in f64 and the gate passes only
    on a freshly recomputed ``B − A X``; a recompute that disagrees
    restarts the directions from the true residual."""
    n = R.shape[1]
    rdtype = B.dtype
    precond = TriInversePrecond(R)
    wdtype = R.dtype
    X = torch.zeros((n, B.shape[1]), dtype=rdtype, device=B.device)
    bnorm = float(torch.linalg.vector_norm(B))
    eps = float(torch.finfo(rdtype).eps)
    Rres = B
    G = _rmatvec(A, Rres)
    Z = _solve_pair(precond, G, wdtype, rdtype)
    P = Z
    gz = _colsum(G, Z)
    best = float("inf")
    stall = 0
    gnorm = float(torch.linalg.vector_norm(G))
    gate = float("nan")
    halt = "stagnated"
    iters = 0
    for it in range(1, max_iters + 1):
        X, Rres, G, P_next, gz_next, (gnorm, rnorm, xnorm) = _sweep(
            A, precond, wdtype, X, Rres, P, gz)
        gate = rtol * sigma_max * rnorm + eps * sigma_max * bnorm
        iters = it
        if not (math.isfinite(gnorm) and math.isfinite(rnorm)):
            halt = "diverged"
            break
        passed = gnorm <= gate or rnorm <= rtol * (sigma_max * xnorm + bnorm)
        if passed or it == max_iters or (
            stall + 1 >= _STALL_LIMIT and gnorm > stagnation_factor * best
        ):
            # Certify on a freshly recomputed f64 residual: incremental
            # updates drift, and only the true residual gates.
            Rres = B - _matvec(A, X)
            G = _rmatvec(A, Rres)
            gnorm = float(torch.linalg.vector_norm(G))
            rnorm = float(torch.linalg.vector_norm(Rres))
            gate = rtol * sigma_max * rnorm + eps * sigma_max * bnorm
            relax = 1.0 if passed else 32.0
            if gnorm <= relax * gate or rnorm <= rtol * (sigma_max * xnorm + bnorm):
                halt = "converged"
                break
            if it == max_iters or not passed:
                halt = "stagnated"
                break
            # Drift only: restart the directions from the true residual
            # (dropping the speculative direction the sweep built).
            Z = _solve_pair(precond, G, wdtype, rdtype)
            P = Z
            gz = _colsum(G, Z)
            stall = 0
            best = min(best, gnorm)
            continue
        if gnorm > _DIVERGE_FACTOR * max(best, eps * sigma_max * bnorm):
            halt = "diverged"
            break
        stall = 0 if gnorm <= stagnation_factor * best else stall + 1
        best = min(best, gnorm)
        P, gz = P_next, gz_next
    stats = {
        "iters": iters,
        "halt": halt,
        "converged": halt == "converged",
        "gate": gate,
        "gradient_norm": gnorm,
    }
    return X, stats


def refine_least_squares(A, B, context: SketchContext, params: RefineParams | None = None, *,
                         fault_plan=None, device=None):
    """Solve ``min_X ||A X - B||_F`` by sketch-preconditioned
    mixed-precision iterative refinement; returns ``(X, info)`` with X
    in f64.

    ``info`` carries ``recovery`` (the guard ladder's report) and
    ``refine`` (``iters``, ``halt``, ``converged``, ``gate``,
    ``gradient_norm``, ``rung``, ``sketch_size``).  Guarded, a stagnated
    or diverged refinement falls down the ladder (resketch, grow, the
    exact dense solve); under ``SKYLARK_GUARD=0`` it raises
    :class:`RefinementError`.  ``fault_plan`` corrupts ladder attempt
    i's ``S·A`` before its QR (``FaultPlan.corrupt_sketch``).  A sparse
    A raises :class:`UnsupportedError`: the JAX package fails there too
    (its QR of the sparse ``S·A``; ROADMAP Queue C)."""
    params = params or RefineParams()
    A, B = routes.operands(A, B, device)
    if is_sparse(A):
        raise UnsupportedError(
            "sparse inputs are not supported by refine_least_squares: the JAX "
            "package fails there too (jnp.linalg.qr of the sparse S·A that its "
            "CWT sketch returns; ROADMAP Queue C)")
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    m, n = A.shape
    in_dtype = A.dtype
    rtol = params.rtol if params.rtol is not None else float(torch.finfo(_RDTYPE).eps) ** 0.75
    stype = params.sketch_type or "FJLT"
    s0 = params.sketch_size or min(4 * n, m)
    s0 = min(max(s0, min(2 * n, m)), m)
    A64 = routes.map_shards(A, lambda t: t.to(_RDTYPE))
    B64 = B.to(_RDTYPE)

    def done(X, report, stats):
        return (X[:, 0] if squeeze else X), {"recovery": report.to_dict(), "refine": stats}

    if s0 >= m:
        # Sketching cannot shrink the problem: the answer is the exact
        # f64 solve, and is reported as such.
        from ..linalg.least_squares import exact_least_squares

        return done(exact_least_squares(A64, B64, alg="qr"),
                    guard.RecoveryReport.disabled(_STAGE),
                    {"iters": 0, "rung": "exact-f64", "converged": True, "sketch_size": int(s0)})

    def attempt(ctx, s_i, i):
        S = create_sketch(stype, m, s_i, ctx)
        A_w, qr_dtype, rung = _working_cast(A, in_dtype)
        SA = plans.apply(S, A_w, Dimension.COLUMNWISE).to(qr_dtype)
        del A_w
        if fault_plan is not None:
            SA = fault_plan.corrupt_sketch(i, SA)
        R = torch.linalg.qr(SA, mode="r")[1]
        # Certify the factor, not the sketch: R carries exactly S·A's
        # singular values at an n × n probe cost, and a QR breakdown (a
        # non-finite R from a finite but degenerate sketch) shows in R.
        cert = guard.certify_sketch(R, stage=_STAGE)
        if not cert.ok:
            return None, cert
        X, stats = _refine_loop(A64, B64, R, sigma_max=float(cert.sigma_max), rtol=rtol,
                                max_iters=params.max_iters,
                                stagnation_factor=params.stagnation_factor)
        stats.update(rung=rung, sketch_size=int(s_i))
        if stats["halt"] != "converged":
            return None, replace(
                cert, verdict=guard.RESKETCH,
                detail=(f"refinement {stats['halt']} after {stats['iters']} sweeps "
                        f"(gate {stats['gate']:.3e}, ||A'r|| {stats['gradient_norm']:.3e})"))
        return (X, stats), cert

    if not guard.enabled():
        result, cert = attempt(SketchContext(seed=context.seed, counter=context.counter), s0, 0)
        if result is None:
            raise RefinementError(
                f"mixed-precision refinement failed with guarding disabled: {cert.detail}",
                iters=params.max_iters, residual=cert.cond, stage=_STAGE)
        X, stats = result
        return done(X, guard.RecoveryReport.disabled(_STAGE), stats)

    def fallback():
        from ..linalg.least_squares import exact_least_squares

        return exact_least_squares(A64, B64, alg="svd"), {
            "iters": 0, "rung": "exact-f64", "converged": False, "halt": "fallback",
            "sketch_size": int(s0)}

    (X, stats), report = guard.run_ladder(_STAGE, context, s0, m, attempt, fallback)
    return done(X, report, stats)
