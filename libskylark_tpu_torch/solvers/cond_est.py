"""Condition-number estimation with certificates (port of
``libskylark_tpu/solvers/cond_est.py``, ≙ ``nla/CondEst.hpp``).

The Avron-Druinsky-Toledo estimator: σ_max by power iteration with a
certificate pair ``(u_max, v_max)``; σ_min by an LSQR sweep on
``A x = A xhat`` for a random ``xhat``, certified from the forward error
``d = xhat - x`` whenever ``‖A d‖/‖d‖`` improves, and an uncertified
estimate from the smallest singular value of the sweep's bidiagonal R.
Flags: ``-1`` cond ≈ 1, ``-2`` C1 convergence, ``-3`` forward error
below τ, ``-4`` numerically singular, ``-6`` no convergence.  After a
criterion first fires the sweep runs on to ``1.25·itn + 1`` iterations.

The start and probe vectors come from ``gaussian_matrix`` on the
context, so they are the JAX package's.  The sweep runs as the Krylov
solvers do: chunks of at most :data:`~.krylov.SYNC_EVERY` masked steps
(a step is kept only while ``itn < T`` and the cond ≈ 1 exit has not
fired), no longer than the ``T`` read at the chunk's start, one host
read per chunk.  On a dense CUDA A the sweep's step (~65 small
launches) is captured once as a CUDA graph and replayed
(:func:`~libskylark_tpu_torch.resilient.chunked.stepper`); the power
step (~8 launches) runs eagerly.  The capture and each chunk with its
read are the spans ``cond_est.capture`` and ``cond_est.chunk``.  Only
products with A are taken, so A may be a sparse COO tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from ..core.context import SketchContext
from ..core.matrices import gaussian_matrix
from ..core.params import Params
from ..parallel import routes
from ..resilient.chunked import chunk_span, graphable, stepper
from . import krylov

__all__ = ["CondEstParams", "CondEstResult", "cond_est"]


@dataclass
class CondEstParams(Params):
    """≙ ``condest_params_t`` (``CondEst.hpp:22-45``); ``None`` thresholds
    derive from the input dtype's eps at call time."""

    iter_lim: int = 300
    powerits: int = 100
    c1: float | None = None  # 8·eps      (C1 convergence scale)
    c2: float = 1e-3  #                    (τ quantile)
    c3: float | None = None  # 64/eps     (declare singular)
    c4: float | None = None  # sqrt(eps)  (ill-conditioning gate)
    c1t: float | None = None  # 4·eps     (tightened C1)


class CondEstResult(NamedTuple):
    """``(cond, sigma_max, sigma_min)`` first, then the certificates."""

    cond: torch.Tensor
    sigma_max: torch.Tensor
    sigma_min: torch.Tensor
    sigma_min_c: torch.Tensor  # certified estimate (≥ sigma_min)
    u_max: torch.Tensor  # (m,) left certificate: A v_max ≈ σ_max u_max
    v_max: torch.Tensor  # (n,) right certificate
    u_min: torch.Tensor  # (m,) left certificate: A v_min ≈ σ_min_c u_min
    v_min: torch.Tensor  # (n,) right certificate
    flag: torch.Tensor  # int32 reference return code (-1..-4, -6)


def _norm(x):
    return torch.linalg.vector_norm(x)


def _where_pos(n, x, fallback):
    """``x / n`` where ``n > 0``, else ``fallback`` (zero-guarded)."""
    return torch.where(n > 0, x / torch.where(n > 0, n, torch.ones_like(n)), fallback)


def _power_sigma_max(matvec, rmatvec, v0, powerits: int):
    """Dominant singular triplet by power iteration on AᵀA; a zero start
    falls back to a uniform vector and a null-space iterate stays put,
    so a zero A gives σ = 0 with finite certificates."""
    n = v0.shape[0]
    nrm0 = _norm(v0)
    v = _where_pos(nrm0, v0, torch.full_like(v0, 1.0 / math.sqrt(n)))
    for _ in range(powerits):
        w = rmatvec(matvec(v))
        v = _where_pos(_norm(w), w, v)
    u = matvec(v)
    sigma = _norm(u)
    return sigma, _where_pos(sigma, u, u), v


def cond_est(A, context: SketchContext, params: CondEstParams | None = None, *,
             power_its: int | None = None, lanczos_steps: int | None = None,
             device=None) -> CondEstResult:
    """Estimate cond(A) with certificates for tall (or square) A, dense or
    sparse COO.  Returns a :class:`CondEstResult` of tensors."""
    params = params or CondEstParams()
    if power_its is not None or lanczos_steps is not None:
        params = replace(
            params,
            powerits=params.powerits if power_its is None else power_its,
            iter_lim=params.iter_lim if lanczos_steps is None else lanczos_steps,
        )
    A, _ = routes.operands(A, device=device)
    n = A.shape[1]
    dtype, dev = A.dtype, routes.device0(A)
    eps = torch.finfo(dtype).eps
    c1 = params.c1 if params.c1 is not None else 8 * eps
    c3 = params.c3 if params.c3 is not None else 64.0 / eps
    c4 = params.c4 if params.c4 is not None else math.sqrt(eps)
    c1t = params.c1t if params.c1t is not None else 4 * eps
    T_max = int(params.iter_lim)
    # v0 then xhat0, as two (n, 1) draws in a row: one (2n, 1) draw is the
    # same counters in the same order, and one launch sequence.
    v0, xhat0 = gaussian_matrix(context, (2 * n, 1), dtype=dtype, device=dev)[:, 0].split(n)
    matvec, rmatvec = routes.linear_ops(A)
    c = lambda x: torch.tensor(x, dtype=dtype, device=dev)

    sigma_max, u_max, v_max = _power_sigma_max(matvec, rmatvec, v0, int(params.powerits))

    # xhat and tau (CondEst.hpp:108-117).
    nrm_xhat = _norm(xhat0)
    tau = torch.sqrt(c(2.0)) * torch.special.erfinv(c(params.c2)) / nrm_xhat
    xhat = xhat0 / nrm_xhat

    # b and the LSQR start (CondEst.hpp:119-152), zero-guarded.
    b = matvec(xhat)
    nrm_b = _norm(b)
    u = _where_pos(nrm_b, b, b)
    v_init = rmatvec(u)
    alpha0 = _norm(v_init)
    v = _where_pos(alpha0, v_init, v_init)

    s = dict(
        itn=torch.zeros((), dtype=torch.int64, device=dev),
        T=torch.full((), T_max, dtype=torch.int64, device=dev),
        flag=torch.full((), -6, dtype=torch.int32, device=dev),
        c1=c(c1),
        u=u, v=v, x=torch.zeros_like(xhat0), w=v,
        alpha=alpha0, phibar=nrm_b, rhobar=alpha0, theta=c(0.0),
        Rdiag=torch.zeros((T_max,), dtype=dtype, device=dev),
        Rsub=torch.zeros((T_max,), dtype=dtype, device=dev),
        sigma_min=sigma_max, u_min=u_max, v_min=v_max,
        done_one=torch.zeros((), dtype=torch.bool, device=dev),
    )
    slots = torch.arange(T_max, device=dev)
    c1t_ = c(c1t)

    def body(s):
        itn = s["itn"]
        # 1-2. Golub-Kahan updates with exact-breakdown guards.
        u_new = matvec(s["v"]) - s["alpha"] * s["u"]
        beta = _norm(u_new)
        u_new = u_new / torch.where(beta > 0, beta, torch.ones_like(beta))
        v_new = rmatvec(u_new) - beta * s["v"]
        alpha = _norm(v_new)
        v_new = v_new / torch.where(alpha > 0, alpha, torch.ones_like(alpha))
        # 3. Givens rotation; store R's entries (CondEst.hpp:176-188).
        rho = torch.sqrt(s["rhobar"] ** 2 + beta ** 2)
        Rdiag = torch.where(slots == itn, rho, s["Rdiag"])
        Rsub = torch.where((slots == itn - 1) & (itn > 0), s["theta"], s["Rsub"])
        cs = s["rhobar"] / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]
        # 4. x and w (CondEst.hpp:190-198).
        x = s["x"] + (phi / rho) * s["w"]
        w = v_new - (theta / rho) * s["w"]
        # 5. Forward error; the cond ≈ 1 exit (CondEst.hpp:200-214).
        d = xhat - x
        nrm_d = _norm(d)
        done_one = nrm_d == 0.0
        # 6. Certified sigma_min (CondEst.hpp:216-224).
        Ad = matvec(d)
        nrm_ad = _norm(Ad)
        improves = (nrm_ad <= s["sigma_min"] * nrm_d) & (nrm_d > 0)
        safe_d = torch.where(nrm_d > 0, nrm_d, torch.ones_like(nrm_d))
        sigma_min = torch.where(improves, nrm_ad / safe_d, s["sigma_min"])
        u_min = torch.where(improves, Ad / torch.where(nrm_ad > 0, nrm_ad,
                                                       torch.ones_like(nrm_ad)), s["u_min"])
        v_min = torch.where(improves, d / safe_d, s["v_min"])
        # 7. Tighten C1 when highly ill-conditioned (CondEst.hpp:227-234).
        c1_cur = torch.where(sigma_min / sigma_max <= c4, c1t_, s["c1"])
        # 8. Stopping; the first trigger sets T = 1.25·itn + 1.
        nrm_x = _norm(x)
        open_ = s["T"] == T_max
        T_ext = torch.clamp((1.25 * itn.to(dtype) + 1).to(torch.int64), max=T_max)
        hit_c1 = open_ & (nrm_ad <= c1_cur * (sigma_max * nrm_x + nrm_b))
        hit_c2 = open_ & (nrm_d <= tau)
        hit_c3 = open_ & (sigma_max / sigma_min >= c3)
        flag = torch.where(hit_c1, -2, torch.where(hit_c2, -3, torch.where(
            hit_c3, -4, s["flag"]))).to(torch.int32)
        T = torch.where(hit_c1 | hit_c2 | hit_c3, T_ext, s["T"])
        return dict(itn=itn + 1, T=T, flag=flag, c1=c1_cur, u=u_new, v=v_new, x=x, w=w,
                    alpha=alpha, phibar=phibar, rhobar=rhobar, theta=theta, Rdiag=Rdiag,
                    Rsub=Rsub, sigma_min=sigma_min, u_min=u_min, v_min=v_min,
                    done_one=done_one)

    def step(s):
        active = (s["itn"] < s["T"]) & ~s["done_one"]
        new = body(s)
        return {k: torch.where(active, new[k], val) for k, val in s.items()}

    advance = stepper(step, graphable(A), "cond_est")
    while True:  # one host read per chunk
        with chunk_span("cond_est"):
            itn, T, one = torch.stack([s["itn"], s["T"], s["done_one"].long()]).tolist()
            if itn >= T or one:
                break
            s = advance(s, min(krylov.SYNC_EVERY, T - itn))

    # Uncertified sigma_min: the smallest singular value of the bidiagonal
    # R over the iterations run; unused slots hold sigma_max on the
    # diagonal, which cannot go below the true minimum.
    count = s["itn"]
    diag = torch.where(slots < count, s["Rdiag"], sigma_max)
    sub = torch.where(slots + 1 < count, s["Rsub"], torch.zeros_like(s["Rsub"]))
    Bmat = torch.diag(diag) + torch.diag(sub[:-1], 1)
    # A breakdown (rho = 0, as on a zero A) leaves NaNs in R: the estimate
    # is then NaN, as in the JAX package, where torch's SVD would raise.
    finite = torch.isfinite(Bmat).all()
    sv_min = torch.linalg.svdvals(torch.where(finite, Bmat, torch.zeros_like(Bmat)))[-1]
    sigma_min_R = torch.where(count > 0, torch.where(finite, sv_min, float("nan")), sigma_max)
    sigma_min_c = s["sigma_min"]
    sigma_min = torch.minimum(sigma_min_c, sigma_min_R)

    # The cond ≈ 1 exit overrides (CondEst.hpp:204-214).
    one = s["done_one"]
    return CondEstResult(
        cond=torch.where(one, c(1.0), sigma_max / sigma_min),
        sigma_max=sigma_max,
        sigma_min=torch.where(one, sigma_max, sigma_min),
        sigma_min_c=torch.where(one, sigma_max, sigma_min_c),
        u_max=u_max,
        v_max=v_max,
        u_min=torch.where(one, u_max, s["u_min"]),
        v_min=torch.where(one, v_max, s["v_min"]),
        flag=torch.where(one, -1, s["flag"]).to(torch.int32),
    )
