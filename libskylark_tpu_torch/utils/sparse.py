"""Sparse input convention of the port.

The JAX package takes sparse matrices as ``jax.experimental.sparse.BCOO``
(``data`` (nnz,), ``indices`` (nnz, ndim)); the port takes a
``torch.sparse_coo_tensor`` (``indices`` (ndim, nnz)).  A BCOO may hold
duplicate coordinates, which add up; the port's COO tensor is left
uncoalesced for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["coo_from_bcoo_arrays", "is_sparse", "linear_ops"]


def coo_from_bcoo_arrays(data, indices, shape, device=None) -> torch.Tensor:
    """The sparse COO tensor holding a BCOO's ``data`` (nnz,) and
    ``indices`` (nnz, ndim) numpy arrays, uncoalesced, on ``device``
    (the default device when None)."""
    data = np.asarray(data)
    indices = np.asarray(indices)
    if indices.ndim != 2 or indices.shape[0] != data.shape[0]:
        raise ValueError(
            f"indices must be (nnz, ndim) with nnz = {data.shape[0]}, got "
            f"{indices.shape}"
        )
    if indices.shape[1] != len(shape):
        raise ValueError(f"indices have {indices.shape[1]} columns for shape {shape}")
    dev = resolve_device(device)
    idx = torch.from_numpy(np.ascontiguousarray(indices.T, dtype=np.int64)).to(dev)
    return torch.sparse_coo_tensor(idx, torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                                   tuple(int(s) for s in shape), check_invariants=False)


def is_sparse(A) -> bool:
    """True for a sparse COO tensor (the port's BCOO)."""
    return isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo


def _spmm(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    if X.ndim == 1:
        return torch.sparse.mm(A, X[:, None])[:, 0]
    return torch.sparse.mm(A, X)


def linear_ops(A):
    """``(matvec, rmatvec)``: ``x -> A @ x`` and ``y -> Aᵀ @ y`` for a
    dense tensor, a sparse COO tensor (coalesced once, and its transpose
    once) or an already given ``(matvec, rmatvec)`` pair.  Vectors may be
    1-D or 2-D (a block of columns)."""
    if isinstance(A, tuple):
        return A
    if is_sparse(A):
        A = A.coalesce()
        At = A.t().coalesce()
        return (lambda x: _spmm(A, x)), (lambda y: _spmm(At, y))
    return (lambda x: A @ x), (lambda y: A.T @ y)
