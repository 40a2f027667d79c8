"""Pairwise distance matrices with the ``C = β·C + α·dist(X, Y)``
accumulate (port of ``libskylark_tpu/ml/distances.py``).

Rows are points: ``D[i, j] = dist(X[i], Y[j])``, (n, m) for X (n, d) and
Y (m, d).  Squared euclidean is one matmul plus norm corrections; L1 and
semigroup are row-blocked broadcasts.  Dense or sparse COO inputs (a
sparse one is densified).
"""

from __future__ import annotations

from .._device import as_tensor
from .kernels import _l1dist, _operands, _semigroup_dist, _sqdist

__all__ = [
    "euclidean_distance_matrix",
    "l1_distance_matrix",
    "expsemigroup_distance_matrix",
]


def _accumulate(D, alpha, beta, C):
    if beta != 0.0 and C is None:
        raise ValueError("beta != 0 requires an existing C to accumulate into")
    if C is None:
        return alpha * D
    return beta * as_tensor(C, D.device).to(D.device) + alpha * D


def euclidean_distance_matrix(X, Y=None, alpha=1.0, beta=0.0, C=None, *, device=None):
    """Squared euclidean distances, ``C = beta*C + alpha*D``."""
    return _accumulate(_sqdist(*_operands(X, Y, device)), alpha, beta, C)


def l1_distance_matrix(X, Y=None, alpha=1.0, beta=0.0, C=None, *, device=None):
    """L1 distances, ``C = beta*C + alpha*D``."""
    return _accumulate(_l1dist(*_operands(X, Y, device)), alpha, beta, C)


def expsemigroup_distance_matrix(X, Y=None, alpha=1.0, beta=0.0, C=None, *,
                                 device=None):
    """Semigroup "distance" Σ_k √(x_k + y_k) (nonnegative inputs),
    ``C = beta*C + alpha*D``."""
    return _accumulate(_semigroup_dist(*_operands(X, Y, device)), alpha, beta, C)
