"""Preconditioners (port of ``libskylark_tpu/solvers/precond.py``,
≙ ``algorithms/Krylov/precond.hpp``): identity, a fixed matrix (LSRN's
V·Σ⁻¹) and a triangular solve (Blendenpik's R⁻¹)."""

from __future__ import annotations

import torch

__all__ = ["IdPrecond", "MatPrecond", "TriInversePrecond"]


class IdPrecond:
    """Identity (≙ ``id_precond_t``).  ``graphable``: its apply is pure
    tensor work, so a Krylov step over it may be captured as a CUDA
    graph (as for the two below)."""

    graphable = True

    def apply(self, x):
        return x

    def apply_adjoint(self, x):
        return x


class MatPrecond:
    """Multiply by a fixed matrix M (≙ ``mat_precond_t``)."""

    graphable = True

    def __init__(self, M: torch.Tensor):
        self.M = M

    def apply(self, x):
        return self.M @ x

    def apply_adjoint(self, x):
        return self.M.T.conj() @ x


class TriInversePrecond:
    """Solve against a triangular factor R (≙ ``tri_inverse_precond_t``),
    applied as R⁻¹ / R⁻ᵀ."""

    graphable = True

    def __init__(self, R: torch.Tensor, lower: bool = False):
        self.R = R
        self.lower = bool(lower)

    def apply(self, x):
        return _solve(self.R, x, upper=not self.lower)

    def apply_adjoint(self, x):
        return _solve(self.R.T.conj(), x, upper=self.lower)


def _solve(R, x, upper: bool):
    if x.ndim == 1:
        return torch.linalg.solve_triangular(R, x[:, None], upper=upper)[:, 0]
    return torch.linalg.solve_triangular(R, x, upper=upper)
