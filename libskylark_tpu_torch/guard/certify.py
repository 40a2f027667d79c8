"""Sketch certification: OK | RESKETCH | FALLBACK (port of
``libskylark_tpu/guard/certify.py``).

:func:`certify_sketch` runs the ported ``cond_est`` on a small sketch
output S·A: non-finite, numerically singular (flag ``-4``) or cond above
``SKYLARK_GUARD_COND_MAX`` is RESKETCH, else OK.  :func:`certify_svd`
checks a randomized SVD's factors for finiteness and its leading
triplet by one matvec, ``‖A v₀ − σ₀ u₀‖ ≤ rtol·σ₀``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.context import SketchContext
from ..utils.sparse import is_sparse, linear_ops
from . import config

__all__ = [
    "OK",
    "RESKETCH",
    "FALLBACK",
    "Certificate",
    "certify_sketch",
    "certify_svd",
    "pinv_psd_solve",
]

OK = "OK"
RESKETCH = "RESKETCH"
FALLBACK = "FALLBACK"

# The probe's own seed: cond_est draws its start and probe vectors from a
# context, and the caller's would advance the caller's counter stream.
_PROBE_SEED = 0x5EED


@dataclass
class Certificate:
    """Outcome of one certification: the verdict plus the evidence."""

    verdict: str
    stage: str
    cond: float | None = None
    sigma_max: float | None = None
    sigma_min: float | None = None
    flag: int | None = None
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.verdict == OK


def certify_sketch(SA: torch.Tensor, *, stage: str = "sketch", cond_max: float | None = None,
                   condest_params=None) -> Certificate:
    """Certify a small sketch output ``S·A`` (s, n): finiteness first,
    then ``cond_est`` (a wide output through its transpose)."""
    from ..solvers.cond_est import CondEstParams, cond_est

    if not bool(torch.isfinite(SA).all()):
        return Certificate(RESKETCH, stage, detail="non-finite sketch output")
    # cond_est wants f32 or wider (bf16/f16 erfinv and SVD are not worth
    # exercising for a probe).
    M = SA.float() if SA.dtype in (torch.bfloat16, torch.float16) else SA
    if M.shape[0] < M.shape[1]:
        M = M.T
    ceiling = cond_max if cond_max is not None else config.cond_max(M.dtype)
    # A short sweep is plenty for an (s, n) probe.
    p = condest_params or CondEstParams(iter_lim=60, powerits=25)
    r = cond_est(M, SketchContext(seed=_PROBE_SEED), p)
    cond, flag = float(r.cond), int(r.flag)
    base = dict(stage=stage, cond=cond, sigma_max=float(r.sigma_max),
                sigma_min=float(r.sigma_min), flag=flag)
    if flag == -4:
        return Certificate(RESKETCH, detail="numerically singular (cond_est C3)", **base)
    # NaN fails this comparison: only a finite cond below the ceiling is OK.
    if not (cond < ceiling):
        return Certificate(RESKETCH, detail=f"cond estimate {cond:.3e} >= {ceiling:.3e}",
                           **base)
    return Certificate(OK, **base)


def certify_svd(A, U, s, V, *, stage: str = "randomized_svd",
                rtol: float | None = None) -> Certificate:
    """Posterior check of a randomized SVD: finite factors and
    ``‖A v₀ − σ₀ u₀‖ ≤ rtol·σ₀`` (default rtol 0.5: a healthy run's
    leading triplet is accurate, a collapsed one misses by far more)."""
    if not bool(torch.isfinite(s).all() & torch.isfinite(U).all() & torch.isfinite(V).all()):
        return Certificate(RESKETCH, stage, detail="non-finite SVD factors")
    s0 = float(s[0])
    if s0 == 0.0:
        # A ≈ 0, or a collapsed sketch: ‖A‖_F tells the two apart.
        vals = A.coalesce().values() if is_sparse(A) else A
        if float(torch.linalg.vector_norm(vals)) == 0.0:
            return Certificate(OK, stage, sigma_max=0.0)
        return Certificate(RESKETCH, stage, sigma_max=s0,
                           detail="sigma_0 = 0 on a nonzero matrix")
    rtol = 0.5 if rtol is None else rtol
    matvec, _ = linear_ops(A)
    res = float(torch.linalg.vector_norm(matvec(V[:, 0]) - s0 * U[:, 0]))
    if not (res <= rtol * s0):
        return Certificate(RESKETCH, stage, sigma_max=s0,
                           detail=f"posterior residual {res:.3e} > {rtol}*sigma_0")
    return Certificate(OK, stage, sigma_max=s0)


def pinv_psd_solve(G: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Eigh-based pseudoinverse solve of a symmetric PSD ``G X = C`` (the
    dense rung under a Cholesky that came back non-finite)."""
    lam, Q = torch.linalg.eigh(G)
    eps = torch.finfo(lam.dtype).eps
    cutoff = torch.clamp(lam[-1], min=0) * eps * G.shape[0]
    inv = torch.where(lam > cutoff, 1.0 / torch.maximum(lam, cutoff), torch.zeros_like(lam))
    return Q @ (inv[:, None] * (Q.T @ C))
