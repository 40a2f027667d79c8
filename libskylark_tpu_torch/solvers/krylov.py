"""Krylov solvers: LSQR, CG, FlexibleCG and Chebyshev (port of
``libskylark_tpu/solvers/krylov.py``, ≙ ``algorithms/Krylov/``).

Every solver is a ``*_chunked`` factory returning a
:class:`~libskylark_tpu_torch.resilient.ChunkedSolver`; the one-shot
entry points drive its chunks until it is done.  The JAX package runs
each chunk as one ``lax.while_loop`` whose condition holds the
convergence predicate; here a chunk is a fixed run of k masked steps: a
step computes the iteration and keeps it only where the device-side
flag ``active = (it < iter_lim) & ~all(done)`` holds (``torch.where``),
so the state and the iteration count are the JAX package's wherever the
chunk boundaries fall.  On a dense CUDA matrix the masked step is
captured once as a CUDA graph and replayed; one-shot ``lsqr`` keeps its
graph across calls of one key (``resilient.chunked.GRAPHS``: the same A,
shapes, constants and preconditioner class) and copies each call's
preconditioner into it.  ``lsqr`` is the span ``lsqr.run``; its capture
(on a miss only) and each chunk are ``lsqr.capture`` and
``lsqr.chunk``.  The one-shot entry points
read one flag (``is_done``) after every :data:`SYNC_EVERY` steps: with
1, a converged solve computes no step that it then discards.

All solvers are multi-RHS: B may be (m,) or (m, k), and the scalars of
the recurrences are per-column vectors.  ``A`` is a dense or sparse COO
tensor or a ``(matvec, rmatvec)`` pair.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .._device import as_tensor
from ..core.params import Params
from ..parallel import routes
from .. import telemetry
from ..resilient.chunked import ChunkedSolver, GraphKey, chunk_span, graphable, stepper
from .precond import IdPrecond, MatPrecond, TriInversePrecond

__all__ = [
    "KrylovParams",
    "SYNC_EVERY",
    "lsqr",
    "cg",
    "flexible_cg",
    "chebyshev",
    "lsqr_chunked",
    "cg_chunked",
    "flexible_cg_chunked",
    "chebyshev_chunked",
]

#: Steps per chunk of the one-shot entry points, one host read each.  On
#: an H100 the read costs no time measurable against a step of LSQR at
#: 2^20 x 512, while chunks of 10 computed up to 9 discarded steps
#: (PERF.md).
SYNC_EVERY = 1


@dataclass
class KrylovParams(Params):
    """≙ ``krylov_iter_params_t`` (tolerance, iter_lim)."""

    tolerance: float = 1e-14
    iter_lim: int = 100


def _colnorm(X):
    return torch.sqrt(torch.sum(X * X, dim=0))


def _safe(x):
    """``x`` with its zeros replaced by 1 (a zero-guarded divisor)."""
    return torch.where(x > 0, x, torch.ones_like(x))


def _inputs(A, B, device):
    """A as a tensor (or the given pair, or a row-sharded A), (matvec,
    rmatvec), B as (m, k), whether B was a vector.  A sharded A's B is
    laid out in the mesh's row order on slot 0's device."""
    A, B = routes.operands(A, B, device)
    squeeze = B.ndim == 1
    return A, routes.linear_ops(A), (B[:, None] if squeeze else B), squeeze


def _converged(s):
    return s["done"].all()


def _graphable(A, precond) -> bool:
    """A dense CUDA matrix and a preconditioner that says it is
    ``graphable`` (this package's, KRR's feature-map one): a step that
    can be captured as a CUDA graph."""
    return graphable(A) and (precond is None or getattr(precond, "graphable", False))


def _rebinding(N):
    """``(operands, rebind)`` of this package's preconditioners: the
    tensors ``N``'s apply reads, and ``rebind(ops)``, the same
    preconditioner over given ones.  None for any other class."""
    if type(N) is IdPrecond:
        return {}, lambda ops: N
    if type(N) is MatPrecond:
        return {"M": N.M}, lambda ops: MatPrecond(ops["M"])
    if type(N) is TriInversePrecond:
        lower = N.lower
        return {"R": N.R}, lambda ops: TriInversePrecond(ops["R"], lower)
    return None


def _chunked(kind, init_state, body, extract_result, iter_lim, done_of=_converged,
             graphed=False, cache: GraphKey | None = None):
    """A :class:`ChunkedSolver` whose step is ``body`` kept only while
    ``it < iter_lim`` and ``done_of(state)`` is false (device-side).
    With a ``cache`` (whose ``bind`` gives a body) the one-shot loop's
    graph is kept across calls; chunks a caller drives capture their
    own."""

    def masked(body):
        def step(s):
            active = s["it"] < iter_lim
            if done_of is not None:
                active = active & ~done_of(s)
            new = body(s)
            return {k: torch.where(active, new[k], v) for k, v in s.items()}

        return step

    step = masked(body)
    advance = stepper(step, graphed, kind,
                      cache and replace(cache, bind=lambda ops: masked(cache.bind(ops))))
    chunk = stepper(step, graphed, kind) if cache else advance

    def step_chunk(s, num_iters: int):
        out = chunk(s, num_iters)
        # A graph's static state is overwritten by its next replay.
        return {k: v.clone() for k, v in out.items()} if graphed and out is not s else out

    def is_done(s):  # one host read
        stop = s["it"] >= iter_lim
        return bool(stop | done_of(s) if done_of is not None else stop)

    return ChunkedSolver(
        init_state=init_state,
        step_chunk=step_chunk,
        extract_result=extract_result,
        is_done=is_done,
        iteration=lambda s: int(s["it"]),
        kind=kind,
        advance=advance,
    )


def _one_shot(sol: ChunkedSolver, iter_lim: int):
    """Chunks of at most :data:`SYNC_EVERY` steps until ``is_done``: one
    host read per chunk, each chunk with its read the span
    ``<kind>.chunk`` where the kind has one.  Every step before the stop is an active one, so
    the host counts ``it`` itself and the last chunk ends at
    ``iter_lim``."""
    s, it = sol.init_state(), 0
    while True:
        with chunk_span(sol.kind):
            if sol.is_done(s):
                break
            k = min(SYNC_EVERY, iter_lim - it)
            s = sol.advance(s, k)
        it += k
    return sol.extract_result(s)


def _flag(s):
    return torch.where(s["done"].all(), 0, 1)


def lsqr_chunked(A, B, precond=None, params: KrylovParams | None = None, x0=None, *,
                 device=None) -> ChunkedSolver:
    """Chunkable LSQR (see :func:`lsqr` for the math and the result)."""
    params = params or KrylovParams()
    N = precond or IdPrecond()
    A, (matvec0, rmatvec0), B, squeeze = _inputs(A, B, device)

    def products(N):
        return (lambda v: matvec0(N.apply(v))), (lambda u: N.apply_adjoint(rmatvec0(u)))

    matvec, rmatvec = products(N)
    dtype, dev = B.dtype, B.device
    eps = torch.finfo(dtype).eps
    atol = btol = max(params.tolerance, eps)
    if x0 is not None:
        x0 = as_tensor(x0, dev)
        if x0.ndim == 1:
            x0 = x0[:, None]

    def init_state():
        U = B if x0 is None else B - matvec0(x0)
        beta = _colnorm(U)
        U = U / _safe(beta)
        V = rmatvec(U)
        alpha = _colnorm(V)
        V = V / _safe(alpha)
        n, k = V.shape[0], B.shape[1]
        return dict(
            it=torch.zeros((), dtype=torch.int64, device=dev),
            Y=torch.zeros((n, k), dtype=dtype, device=dev),
            U=U, V=V, W=V,
            alpha=alpha, beta=beta, rhobar=alpha, phibar=beta,
            anorm=torch.zeros((), dtype=dtype, device=dev),
            done=beta <= btol * _colnorm(B),
            stag=torch.zeros((k,), dtype=torch.int64, device=dev),
            arnorm_best=torch.full((k,), float("inf"), dtype=dtype, device=dev),
            bnorm=_colnorm(B),
        )

    def body_over(N):
        matvec, rmatvec = products(N)
        return lambda s: body(s, matvec, rmatvec)

    def body(s, matvec, rmatvec):
        U, V, W, Y = s["U"], s["V"], s["W"], s["Y"]
        alpha, beta = s["alpha"], s["beta"]
        # Golub-Kahan bidiagonalization step (LSQR.hpp:100-130).
        U = matvec(V) - alpha[None, :] * U
        beta = _colnorm(U)
        U = U / _safe(beta)
        V = rmatvec(U) - beta[None, :] * V
        alpha_new = _colnorm(V)
        V = V / _safe(alpha_new)
        # Givens rotation (LSQR.hpp:135-160); every division is guarded so
        # that an all-zero RHS column stays exactly 0.
        rho = torch.hypot(s["rhobar"], beta)
        rho_s = _safe(rho)
        c = s["rhobar"] / rho_s
        sn = beta / rho_s
        theta = sn * alpha_new
        rhobar = -c * alpha_new
        phi = c * s["phibar"]
        phibar_new = sn * s["phibar"]
        step = torch.where(s["done"], torch.zeros_like(phi), phi / rho_s)
        Y = Y + step[None, :] * W
        W = V - (theta / rho_s)[None, :] * W
        anorm = torch.hypot(s["anorm"], torch.max(torch.hypot(alpha, beta)))
        # Paige-Saunders S1/S2 per column (LSQR.hpp:193-230).
        rnorm = phibar_new
        arnorm = alpha_new * torch.abs(c * phibar_new)
        ynorm = _colnorm(Y)
        s1 = rnorm <= btol * s["bnorm"] + atol * anorm * ynorm
        s2 = arnorm <= atol * anorm * torch.clamp(rnorm, min=eps)
        # Stagnation: the residual AND the normal-equation residual both
        # stop improving for several consecutive iterations.
        no_progress = (phibar_new >= s["phibar"] * (1 - 10 * eps)) & (
            arnorm >= s["arnorm_best"] * (1 - 1e3 * eps))
        stag = torch.where(no_progress, s["stag"] + 1, torch.zeros_like(s["stag"]))
        done = s["done"] | s1 | s2 | (stag >= 5)
        return dict(
            it=s["it"] + 1, Y=Y, U=U, V=V, W=W,
            alpha=alpha_new, beta=beta, rhobar=rhobar, phibar=phibar_new,
            anorm=anorm, done=done, stag=stag,
            arnorm_best=torch.minimum(s["arnorm_best"], arnorm),
            bnorm=s["bnorm"],
        )

    def extract_result(s):
        # Clones of the state's tensors: a kept graph's static state is
        # the next call's.
        X = N.apply(s["Y"])
        if X is s["Y"]:
            X = X.clone()
        if x0 is not None:
            X = X + x0
        info = {"iterations": s["it"].clone(), "flag": _flag(s), "resid": s["phibar"].clone()}
        return (X[:, 0] if squeeze else X), info

    graphed = _graphable(A, precond)
    bound = _rebinding(N) if graphed else None
    cache = None
    if bound is not None:
        operands, rebind = bound
        cache = GraphKey(("lsqr", params.iter_lim, atol, btol, eps, type(N),
                          getattr(N, "lower", None)),
                         (A,), operands, lambda ops: body_over(rebind(ops)))
    return _chunked("lsqr", init_state, body_over(N), extract_result, params.iter_lim,
                    graphed=graphed, cache=cache)


def lsqr(A, B, precond=None, params: KrylovParams | None = None, x0=None, *,
         device=None):
    """Preconditioned LSQR for ``min_X ||A X - B||`` (per column).

    ``precond`` is a *right* preconditioner N (≙ ``outplace_precond_t``):
    LSQR runs on A·N and returns ``X = N·Y`` (Blendenpik and LSRN use
    this).  Returns ``(X, info)`` with ``info = {"iterations", "flag",
    "resid"}`` (0-d or per-column tensors); flag 0 = converged, 1 = the
    iteration limit.
    """
    params = params or KrylovParams()
    with telemetry.span("lsqr.run"):
        return _one_shot(lsqr_chunked(A, B, precond, params, x0, device=device),
                         params.iter_lim)


def cg_chunked(A, B, precond=None, params: KrylovParams | None = None, x0=None, *,
               device=None) -> ChunkedSolver:
    """Chunkable preconditioned CG (see :func:`cg`)."""
    params = params or KrylovParams()
    M = precond or IdPrecond()
    A, (matvec, _), B, squeeze = _inputs(A, B, device)
    dtype, dev = B.dtype, B.device
    tol = params.tolerance
    bnorm = _colnorm(B)
    floor = torch.clamp(bnorm, min=1e-30)

    def init_state():
        if x0 is None:
            X, R = torch.zeros_like(B), B
        else:
            X = as_tensor(x0, dev).reshape(B.shape)
            R = B - matvec(X)
        Z = M.apply(R)
        return dict(
            it=torch.zeros((), dtype=torch.int64, device=dev),
            X=X, R=R, P=Z,
            rz=torch.sum(R * Z, dim=0),
            done=_colnorm(R) <= tol * floor,
        )

    def body(s):
        Q = matvec(s["P"])
        denom = torch.sum(s["P"] * Q, dim=0)
        alpha = torch.where(s["done"], torch.zeros_like(denom),
                            s["rz"] / torch.where(denom != 0, denom, torch.ones_like(denom)))
        X = s["X"] + alpha[None, :] * s["P"]
        R = s["R"] - alpha[None, :] * Q
        Z = M.apply(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = rz_new / torch.where(s["rz"] != 0, s["rz"], torch.ones_like(s["rz"]))
        P = Z + beta[None, :] * s["P"]
        done = s["done"] | (_colnorm(R) <= tol * floor)
        return dict(it=s["it"] + 1, X=X, R=R, P=P, rz=rz_new, done=done)

    def extract_result(s):
        info = {"iterations": s["it"], "flag": _flag(s), "resid": _colnorm(s["R"])}
        return (s["X"][:, 0] if squeeze else s["X"]), info

    return _chunked("cg", init_state, body, extract_result, params.iter_lim,
                    graphed=_graphable(A, precond))


def cg(A, B, precond=None, params: KrylovParams | None = None, x0=None, *, device=None):
    """Preconditioned conjugate gradient for SPD ``A X = B`` (multi-RHS),
    ≙ ``algorithms/Krylov/CG.hpp``; ``precond`` is M ≈ A⁻¹."""
    params = params or KrylovParams()
    return _one_shot(cg_chunked(A, B, precond, params, x0, device=device), params.iter_lim)


def flexible_cg_chunked(A, B, precond=None, params: KrylovParams | None = None,
                        memory: int = 5, *, device=None) -> ChunkedSolver:
    """Chunkable FlexibleCG (see :func:`flexible_cg`).  The ring buffers
    of past directions ride the state."""
    params = params or KrylovParams()
    A, (matvec, _), B, squeeze = _inputs(A, B, device)
    dtype, dev = B.dtype, B.device
    tol = params.tolerance
    m, k = B.shape
    if precond is None:
        apply_M = lambda R, it: R
    elif callable(precond) and not hasattr(precond, "apply"):
        apply_M = precond
    else:
        apply_M = lambda R, it: precond.apply(R)
    bnorm = _colnorm(B)
    floor = torch.clamp(bnorm, min=1e-30)

    def init_state():
        return dict(
            it=torch.zeros((), dtype=torch.int64, device=dev),
            X=torch.zeros_like(B),
            R=B,
            # Ring buffers of past directions P and A·P, per RHS column.
            Pbuf=torch.zeros((memory, m, k), dtype=dtype, device=dev),
            Qbuf=torch.zeros((memory, m, k), dtype=dtype, device=dev),
            pq=torch.ones((memory, k), dtype=dtype, device=dev),
            done=bnorm <= tol,
        )

    def body(s):
        Z = apply_M(s["R"], s["it"])
        # Orthogonalize Z against the stored directions (A-inner product).
        coeffs = torch.einsum("smk,mk->sk", s["Qbuf"], Z) / s["pq"]
        P = Z - torch.einsum("smk,sk->mk", s["Pbuf"], coeffs)
        Q = matvec(P)
        denom = torch.sum(P * Q, dim=0)
        denom = torch.where(torch.abs(denom) > 0, denom, torch.ones_like(denom))
        alpha = torch.where(s["done"], torch.zeros_like(denom),
                            torch.sum(P * s["R"], dim=0) / denom)
        X = s["X"] + alpha[None, :] * P
        R = s["R"] - alpha[None, :] * Q
        slot = (s["it"] % memory).reshape(1)
        done = s["done"] | (_colnorm(R) <= tol * floor)
        return dict(
            it=s["it"] + 1, X=X, R=R,
            Pbuf=s["Pbuf"].index_copy(0, slot, P[None]),
            Qbuf=s["Qbuf"].index_copy(0, slot, Q[None]),
            pq=s["pq"].index_copy(0, slot, denom[None]),
            done=done,
        )

    def extract_result(s):
        info = {"iterations": s["it"], "flag": _flag(s), "resid": _colnorm(s["R"])}
        return (s["X"][:, 0] if squeeze else s["X"]), info

    return _chunked("flexible_cg", init_state, body, extract_result, params.iter_lim,
                    graphed=_graphable(A, precond))


def flexible_cg(A, B, precond=None, params: KrylovParams | None = None,
                memory: int = 5, *, device=None):
    """Flexible CG (≙ ``algorithms/Krylov/FlexibleCG.hpp``): a varying
    preconditioner, the search direction re-orthogonalized against the
    last ``memory`` directions.  ``precond`` may be a function
    ``(R, it) -> Z`` or a fixed preconditioner object."""
    params = params or KrylovParams()
    return _one_shot(flexible_cg_chunked(A, B, precond, params, memory, device=device),
                     params.iter_lim)


def chebyshev_chunked(A, B, sigma_lo: float, sigma_hi: float,
                      params: KrylovParams | None = None, *, device=None) -> ChunkedSolver:
    """Chunkable Chebyshev semi-iteration (see :func:`chebyshev`).  The
    recurrence depends only on the absolute iteration index, which rides
    the state."""
    params = params or KrylovParams()
    A, (matvec, _), B, squeeze = _inputs(A, B, device)
    dtype, dev = B.dtype, B.device
    d = torch.tensor((sigma_hi + sigma_lo) / 2, dtype=dtype, device=dev)
    c = torch.tensor((sigma_hi - sigma_lo) / 2, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def init_state():
        X0 = torch.zeros_like(B)
        return dict(it=torch.zeros((), dtype=torch.int64, device=dev), X=X0, Xprev=X0,
                    alpha=zero)

    def body(s):
        i, X, Xprev = s["it"], s["X"], s["Xprev"]
        R = B - matvec(X)
        alpha = torch.where(i == 0, 1.0 / d,
                            torch.where(i == 1, d / (d * d - c * c / 2),
                                        1.0 / (d - s["alpha"] * c * c / 4)))
        beta = torch.where(i == 0, zero, alpha * d - 1.0)
        Xnew = X + alpha * R + beta * (X - Xprev)
        return dict(it=i + 1, X=Xnew, Xprev=X, alpha=alpha)

    def extract_result(s):
        info = {"iterations": s["it"], "flag": torch.zeros((), dtype=torch.int64, device=dev)}
        return (s["X"][:, 0] if squeeze else s["X"]), info

    return _chunked("chebyshev", init_state, body, extract_result, params.iter_lim,
                    done_of=None, graphed=_graphable(A, None))


def chebyshev(A, B, sigma_lo: float, sigma_hi: float, params: KrylovParams | None = None,
              *, device=None):
    """Chebyshev semi-iteration for SPD ``A X = B`` given eigenvalue
    bounds ``[sigma_lo, sigma_hi]`` (≙ ``algorithms/Krylov/Chebyshev.hpp``):
    no inner products, only the matvec."""
    params = params or KrylovParams()
    return _one_shot(chebyshev_chunked(A, B, sigma_lo, sigma_hi, params, device=device),
                     params.iter_lim)
