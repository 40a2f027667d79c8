"""Regression problems and their dispatch (port of
``libskylark_tpu/solvers/regression.py``, ≙ ``algorithms/regression/``):

- penalty "l2": ``exact`` (QR/SNE/NE/SVD), ``sketched``
  (sketch-and-solve), ``refine`` (mixed-precision refinement, with its
  info), ``accelerated`` (Blendenpik), ``lsrn``, and ``auto`` (the
  route left to the policy layer: a matured profile store may send it
  to ``exact``, Blendenpik/LSRN or ``refine``; with nothing learned it
  is ``sketched``);
- penalty "l1": a Cauchy (MMT) sketch, then IRLS on the small problem;
- ``ridge`` regularization by the augmented system ``[A; √λ I]``.

A row-sharded A (:class:`~libskylark_tpu_torch.parallel.mesh.Sharded`)
takes every solver: its sketches, products and factorizations run slot
by slot (``parallel.routes``).  Under ridge regularization the augmented
``[A; √λ I]`` is laid out over the mesh's equal row blocks without a
gather (:func:`_augment_ridge_sharded`), so its m + n rows must divide
over the slots, as any sharded route's rows must.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .._device import is_sharded
from ..core.context import SketchContext
from ..linalg.least_squares import (
    LeastSquaresParams,
    approximate_least_squares,
    exact_least_squares,
)
from ..parallel import routes
from ..sketch.base import Dimension
from ..sketch.hash import MMT
from .accelerated import faster_least_squares, lsrn_least_squares

__all__ = ["RegressionProblem", "solve_regression"]


@dataclass
class RegressionProblem:
    """≙ ``regression_problem_t``: (m, n, A) + penalty/regularization."""

    A: Any
    penalty: str = "l2"  # "l2" | "l1"
    regularization: str = "none"  # "none" | "ridge"
    lam: float = 0.0

    @property
    def shape(self):
        return self.A.shape


def _augment_ridge(A, B, lam):
    n = A.shape[1]
    sq = torch.sqrt(torch.tensor(lam, dtype=A.dtype, device=A.device))
    A_aug = torch.cat([A, sq * torch.eye(n, dtype=A.dtype, device=A.device)], dim=0)
    B_aug = torch.cat([B, torch.zeros((n,) + tuple(B.shape[1:]), dtype=B.dtype,
                                      device=B.device)], dim=0)
    return A_aug, B_aug


def _augment_ridge_sharded(A, B, lam):
    """``[A; √λ I]`` of a row-sharded A laid out over its mesh's equal row
    blocks of the m + n rows, and ``[B; 0]`` on slot 0's device: each
    target block is assembled from the pieces of A's shards that overlap
    it (each copied once to its slot's device) and the rows of √λ I it
    holds, made there.  No slot gathers A."""
    from ..parallel.mesh import Sharded, _blocks

    (m, n), mesh = A.shape, A.mesh
    src = routes.row_blocks(A)
    shards = []
    for k, (sl,) in enumerate(_blocks(mesh, A.spec[:1], (m + n,))):
        dev = mesh.device(k)
        out = torch.zeros((sl.stop - sl.start, n), dtype=A.dtype, device=dev)
        for a, (r0, r1) in zip(A.shards, src):
            lo, hi = max(r0, sl.start), min(r1, sl.stop)
            if lo < hi:
                out[lo - sl.start:hi - sl.start] = a[lo - r0:hi - r0].to(dev)
        lo = max(m, sl.start)
        if lo < sl.stop:
            i = torch.arange(lo - m, sl.stop - m, device=dev)
            out[i + (m - sl.start), i] = torch.sqrt(torch.tensor(lam, dtype=A.dtype, device=dev))
        shards.append(out)
    B_aug = torch.cat([B, torch.zeros((n,) + tuple(B.shape[1:]), dtype=B.dtype,
                                      device=B.device)], dim=0)
    return Sharded(mesh, A.spec[:1], (m + n, n), shards), B_aug


def _irls_l1(A, B, iters=30, eps=1e-6):
    """IRLS for min ‖Ax − b‖₁ on a small (sketched) problem, per column."""
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]

    def one(b):
        x = exact_least_squares(A, b)
        for _ in range(iters):
            w = 1.0 / torch.sqrt(torch.abs(A @ x - b) + eps)
            x = exact_least_squares(w[:, None] * A, w * b)
        return x

    X = torch.stack([one(B[:, j]) for j in range(B.shape[1])], dim=1)
    return X[:, 0] if squeeze else X


def solve_regression(problem: RegressionProblem, B, solver: str = "exact",
                     context: SketchContext | None = None, alg: str = "qr",
                     params: Any = None, *, device=None):
    """Dispatch ≙ the ``regression_solver_t`` specializations.

    ``solver`` ∈ {"exact", "sketched", "refine", "accelerated", "lsrn",
    "auto"}; returns X, or ``(X, info)`` for the iterative solvers,
    refine included.  ``"sketched"`` and ``"refine"`` pin their route, so
    a matured profile cannot reroute them; ``"auto"`` follows it.
    """
    A, B = routes.operands(problem.A, B, device)
    if problem.regularization == "ridge" and problem.lam > 0:
        augment = _augment_ridge_sharded if is_sharded(A) else _augment_ridge
        A, B = augment(A, B, problem.lam)
    if problem.penalty == "l1":
        if context is None:
            raise ValueError("l1 regression needs a SketchContext")
        m, n = A.shape
        s = min(max(4 * n, 64), m)
        # A Cauchy-value sketch preserves l1 geometry (MMT, Meng-Mahoney).
        S = MMT(m, s, context)
        return _irls_l1(S.apply(A, Dimension.COLUMNWISE), S.apply(B, Dimension.COLUMNWISE))
    if solver == "exact":
        return exact_least_squares(A, B, alg=alg)
    if solver not in ("auto", "sketched", "refine", "accelerated", "lsrn"):
        raise ValueError(f"unknown solver {solver!r}")
    if context is None:
        raise ValueError(f"{solver} solver needs a SketchContext")
    if solver in ("auto", "sketched", "refine"):
        # "sketched" and "refine" pin their route; "auto" leaves it to the
        # policy decision.
        route = {"auto": None, "sketched": "sketch"}.get(solver, solver)
        return approximate_least_squares(A, B, context, params or LeastSquaresParams(),
                                         alg=alg, route=route, return_info=solver == "refine")
    if solver == "accelerated":
        return faster_least_squares(A, B, context, params)
    return lsrn_least_squares(A, B, context, params)
