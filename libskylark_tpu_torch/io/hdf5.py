"""HDF5 dataset IO (port of ``libskylark_tpu/io/hdf5.py``; ≙ ``ml/io.hpp``
ReadHDF5/WriteHDF5 paths).

Layout matches the reference's skylark_ml HDF5 format: dense data in
datasets ``X`` (n × d) and ``Y`` (n,); sparse data in CSR-style datasets
``dimensions``/``indptr``/``indices``/``values`` + ``Y``
(``ml/io.hpp:256-520``), so a file written by either package reads in
the other.  Sparse data comes back as an uncoalesced CPU
``torch.sparse_coo_tensor`` (entries in the file's CSR order), as
``io.read_libsvm`` gives it.  Needs ``h5py`` (``utils.deps.require``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.deps import require
from .libsvm import _coo, _dense_numpy

__all__ = ["read_hdf5", "write_hdf5", "stream_hdf5"]


def _is_coo(X) -> bool:
    return isinstance(X, torch.Tensor) and X.layout == torch.sparse_coo


def _fromdense(X: np.ndarray):
    """COO of a dense array's nonzeros in row-major order (the order of
    the JAX package's ``BCOO.fromdense``)."""
    rows, cols = np.nonzero(X)
    return _coo(rows, cols, X[rows, cols], X.shape)


def write_hdf5(path, X, y, sparse: bool = False) -> None:
    h5py = require("h5py")

    with h5py.File(path, "w") as f:
        y = _dense_numpy(y)
        if sparse or _is_coo(X):
            if _is_coo(X):
                idx = X._indices().cpu().numpy().T
                data = X._values().cpu().numpy()
                n, d = X.shape
                order = np.lexsort((idx[:, 1], idx[:, 0]))
                rows, cols = idx[order, 0], idx[order, 1]
                vals = data[order]
            else:
                Xd = _dense_numpy(X)
                rows, cols = np.nonzero(Xd)
                vals = Xd[rows, cols]
                n, d = Xd.shape
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(indptr, rows + 1, 1)
            indptr = np.cumsum(indptr)
            # Reference order: [num_features, num_examples, nnz]
            # (ml/io.hpp writes dimensions[0]=height=d, [1]=width=n; indptr
            # runs over examples in both layouts).
            f.create_dataset("dimensions", data=np.asarray([d, n, len(vals)]))
            f.create_dataset("indptr", data=indptr)
            f.create_dataset("indices", data=cols.astype(np.int64))
            f.create_dataset("values", data=vals)
        else:
            f.create_dataset("X", data=_dense_numpy(X))
        f.create_dataset("Y", data=y)


def read_hdf5(path, sparse: bool | None = None):
    """Returns (X, y); X is a COO if the file holds sparse data (or
    ``sparse=True`` forces conversion of dense data)."""
    h5py = require("h5py")

    with h5py.File(path, "r") as f:
        y = np.asarray(f["Y"])
        if "X" in f:
            X = np.asarray(f["X"])
            return (_fromdense(X) if sparse else X), y
        d, n, nnz = (int(v) for v in f["dimensions"][:])
        indptr = np.asarray(f["indptr"])
        indices = np.asarray(f["indices"])
        values = np.asarray(f["values"])
    rows = np.repeat(np.arange(n), np.diff(indptr))
    if sparse is False:
        X = np.zeros((n, d), dtype=values.dtype)
        X[rows, indices] = values
        return X, y
    return _coo(rows, indices, values, (n, d)), y


def stream_hdf5(path, batch: int, sparse: bool | None = None):
    """Yield ``(X_batch, y_batch)`` row batches with bounded memory — the
    HDF5 face of :func:`..libsvm.stream_libsvm` (≙ the reference's
    chunked test-predict IO, ``ml/io.hpp:869-889``).  Dense files yield
    ndarray batches; CSR-style sparse files yield a COO per batch (each
    batch's indptr window is sliced straight from disk)."""
    h5py = require("h5py")

    with h5py.File(path, "r") as f:
        y = f["Y"]
        if "X" in f:
            X = f["X"]
            n = X.shape[0]
            for lo in range(0, n, batch):
                hi = min(lo + batch, n)
                Xb = np.asarray(X[lo:hi])
                yield (_fromdense(Xb) if sparse else Xb), np.asarray(y[lo:hi])
            return
        d, n, _ = (int(v) for v in f["dimensions"][:])
        indptr = np.asarray(f["indptr"])
        indices = f["indices"]
        values = f["values"]
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            p0, p1 = int(indptr[lo]), int(indptr[hi])
            cols = np.asarray(indices[p0:p1])
            vals = np.asarray(values[p0:p1])
            rows = np.repeat(np.arange(hi - lo), np.diff(indptr[lo: hi + 1]))
            if sparse is False:
                Xb = np.zeros((hi - lo, d), dtype=vals.dtype)
                Xb[rows, cols] = vals
                yield Xb, np.asarray(y[lo:hi])
                continue
            yield _coo(rows, cols, vals, (hi - lo, d)), np.asarray(y[lo:hi])
