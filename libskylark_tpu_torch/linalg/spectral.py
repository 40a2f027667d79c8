"""Chebyshev spectral collocation utilities (port of
``libskylark_tpu/linalg/spectral.py``, ≙ ``nla/spectral.hpp:17-96``).

Host numpy, as in the JAX package: tiny (N ≲ 100) matrices consumed by
the time-dependent PPR community detection (``graph/community.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_points", "chebyshev_diff_matrix"]


def chebyshev_points(N: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """N Chebyshev points of the second kind mapped to [a, b], descending
    (x_j = a + (cos(jπ/(N−1)) + 1)·(b−a)/2)."""
    n = N - 1
    j = np.arange(N)
    x = a + (np.cos(j * np.pi / n) + 1.0) * (b - a) / 2.0
    if n % 2 == 0:
        x[n // 2] = (a + b) / 2.0  # the midpoint exactly centred
    return x


def chebyshev_diff_matrix(N: int, a: float = -1.0, b: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(D, x): spectral differentiation matrix on N Chebyshev points with
    p' = D·p for polynomial values p at x (≙ ``ChebyshevDiffMatrix``)."""
    n = N - 1
    xc = chebyshev_points(N)  # on [-1, 1]
    c = np.ones(N)
    c[0] = c[n] = 2.0
    sign = np.where((np.arange(N)) % 2 == 0, 1.0, -1.0)
    w = c * sign  # Trefethen weights
    X = xc[:, None] - xc[None, :]
    D = (w[:, None] / w[None, :]) / (X + np.eye(N))
    D = D - np.diag(D.sum(axis=1))
    D = D * (2.0 / (b - a))
    x = a + (xc + 1.0) * (b - a) / 2.0
    return D, x
