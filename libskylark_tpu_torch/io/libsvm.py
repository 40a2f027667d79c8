"""LIBSVM-format reader/writer (port of ``libskylark_tpu/io/libsvm.py``).

≙ the reference's chunked MPI LIBSVM reader
(``utility/io/libsvm_io.hpp:529+``, ``ml/io.hpp:529-889``): rank 0 reads and
ships chunks over MPI.  Here the host reads once and the caller moves the
arrays to the card.

Convention: examples are **rows** — X is (n_examples, n_features) (the
reference stores examples as columns of a d×n Elemental matrix; its
columnwise/rowwise sketch tags already abstract this).  A dense X is a
numpy array, as in the JAX package; ``sparse=True`` gives an
**uncoalesced** CPU ``torch.sparse_coo_tensor`` whose entries stay in the
file's order (the JAX package's BCOO holds them in that order, and the
port's hash apply reads ``_indices()``/``_values()`` in order, so the
order is part of bitwise parity).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..utils.sparse import coo_from_bcoo_arrays
from .source import _lines_of, open_source

__all__ = ["read_libsvm", "write_libsvm", "stream_libsvm", "scan_libsvm_dims"]


def scan_libsvm_dims(path, chunk_bytes: int = 8 << 20) -> tuple[int, int]:
    """One cheap pass over a LIBSVM source → ``(n_examples, n_features)``.

    Streaming consumers must know the global shape up front (the row
    count addresses a columnwise sketch's counter stream; the feature
    count sizes the batches), and an out-of-core file cannot be read
    whole to find out.  This scan only tokenizes — no float parsing, no
    arrays — so it is bounded-memory and IO-dominated.
    """
    n = 0
    d = 0
    with open_source(path).open() as f:
        for block in _lines_of(f, chunk_bytes):
            for line in block.decode().splitlines():
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                n += 1
                for tok in line.split()[1:]:
                    idx = int(tok.split(":", 1)[0])
                    if idx > d:
                        d = idx
    return n, d


def _coo(rows, cols, vals, shape):
    """Uncoalesced CPU COO of the (rows, cols, vals) triplets in order."""
    return coo_from_bcoo_arrays(vals, np.stack([rows, cols], axis=1), shape, device="cpu")


def read_libsvm(
    path,
    n_features: int | None = None,
    sparse: bool = False,
    dtype=np.float64,
    max_rows: int | None = None,
):
    """Read a LIBSVM file → ``(X, y)``.

    ``sparse=True`` returns an uncoalesced CPU ``torch.sparse_coo_tensor``
    (entries in file order); otherwise a dense ndarray.  ``n_features``
    pads/clips the feature dimension (the reference's ``min_d`` flag,
    ``ml/io.hpp:534``); ``max_rows`` caps the number of examples read (the
    reference's ``max_n``, ``capi/cio.cpp sl_readlibsvm``).  Indices are
    1-based in the file (LIBSVM standard, matching the reference reader).

    Parsing uses the native multithreaded C++ parser when built
    (``libskylark_tpu_torch.native``, ≙ the reference's native chunked
    reader); otherwise, and for malformed input, the strict pure-Python
    path below.
    """
    from .. import native

    src = open_source(path)

    # max_rows must bound both the result AND the parsing work (the
    # reference's reader stops early), so it bypasses the slurp-everything
    # native fast path and breaks out of the line loop.
    parsed = None
    if native.available() and max_rows is None:
        with src.open() as f:
            data = f.read()
        try:
            parsed = native.parse_libsvm_bytes(data)
        except Exception:
            parsed = None  # malformed for the fast path; strict parser below
    if parsed is not None:
        y_all, rows_a, cols_a, vals_a = parsed[:4]
        n = len(y_all)
        y = y_all.astype(dtype)
        vals_a = vals_a.astype(dtype)
    else:
        labels: list[float] = []
        rows: list[int] = []
        cols: list[int] = []
        vals: list[float] = []
        with src.open() as f:
            for line in io.TextIOWrapper(f, encoding="utf-8"):
                if max_rows is not None and len(labels) >= max_rows:
                    break
                _parse_line(line, labels, rows, cols, vals)
        n = len(labels)
        y = np.asarray(labels, dtype=dtype)
        rows_a = np.asarray(rows, dtype=np.int64)
        cols_a = np.asarray(cols, dtype=np.int64)
        vals_a = np.asarray(vals, dtype=dtype)
    # Feature dimension is inferred AFTER the row cap, so columns that
    # appear only in discarded rows don't widen X.
    max_col = int(cols_a.max()) + 1 if len(cols_a) else 0
    d = n_features if n_features is not None else max_col
    keep = cols_a < d
    rows_a, cols_a, vals_a = rows_a[keep], cols_a[keep], vals_a[keep]
    if sparse:
        return _coo(rows_a, cols_a, vals_a, (n, d)), y
    X = np.zeros((n, d), dtype=dtype)
    X[rows_a, cols_a] = vals_a
    return X, y


def _parse_line(line, labels, rows, cols, vals) -> None:
    """Parse one LIBSVM line into the accumulator lists (shared by the
    batch reader's Python fallback and the streaming reader)."""
    line = line.split("#", 1)[0].strip()
    if not line:
        return
    parts = line.split()
    labels.append(float(parts[0]))
    r = len(labels) - 1
    for tok in parts[1:]:
        idx, val = tok.split(":", 1)
        c = int(idx) - 1
        if c < 0:
            raise ValueError(f"bad LIBSVM index {idx!r} (1-based)")
        rows.append(r)
        cols.append(c)
        vals.append(float(val))


def _assemble_batch(labels, rows, cols, vals, n_features, sparse, dtype):
    """(labels, triplet arrays with batch-local rows) → (X, y)."""
    n = len(labels)
    y = np.asarray(labels, dtype=dtype)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=dtype)
    keep = cols < n_features
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if sparse:
        return _coo(rows, cols, vals, (n, n_features)), y
    X = np.zeros((n, n_features), dtype)
    X[rows, cols] = vals
    return X, y


def stream_libsvm(
    path, n_features: int, batch: int = 4096, sparse: bool = False,
    dtype=np.float64, chunk_bytes: int = 8 << 20,
):
    """Yield ``(X, y)`` batches of up to ``batch`` examples (dense ndarray,
    or an uncoalesced CPU COO when ``sparse``).

    ≙ the reference's streaming line-by-line predict IO (``ml/io.hpp``)
    and its HDFS readers (``utility/io/libsvm_io.hpp:1495-1638``):
    bounded memory for files larger than RAM, from any byte source —
    ``path`` may be a local path, a ``scheme://`` URL, raw bytes, or a
    :class:`~libskylark_tpu_torch.io.source.ByteSource`.  Byte chunks go
    through the native multithreaded parser when built; the pure-Python
    per-line parser is the fallback.
    """
    from .. import native

    def parse_chunk(block: bytes):
        """Parse a newline-aligned byte chunk → numpy arrays.  The native
        parser is preferred; malformed chunks re-parse through the strict
        Python path so the exception type (ValueError) matches
        read_libsvm regardless of whether the library is built."""
        if native.available():
            try:
                labels, rows, cols, vals, _ = native.parse_libsvm_bytes(block)
                return labels, rows, cols, vals
            except ValueError:
                raise
            except Exception:
                pass
        l: list = []
        r: list = []
        c: list = []
        v: list = []
        for line in block.decode().splitlines():
            _parse_line(line, l, r, c, v)
        return (
            np.asarray(l, np.float64),
            np.asarray(r, np.int64),
            np.asarray(c, np.int64),
            np.asarray(v, np.float64),
        )

    # Pending examples carried across chunks, kept as numpy arrays (no
    # per-element Python boxing on the hot path).
    p_lab = np.empty(0, np.float64)
    p_rows = np.empty(0, np.int64)
    p_cols = np.empty(0, np.int64)
    p_vals = np.empty(0, np.float64)

    with open_source(path).open() as f:
        for block in _lines_of(f, chunk_bytes):
            if block:
                labels, rows, cols, vals = parse_chunk(block)
                p_rows = np.concatenate([p_rows, rows + len(p_lab)])
                p_lab = np.concatenate([p_lab, labels])
                p_cols = np.concatenate([p_cols, cols])
                p_vals = np.concatenate([p_vals, vals])
            while len(p_lab) >= batch:
                split = int(np.searchsorted(p_rows, batch))
                yield _assemble_batch(
                    p_lab[:batch], p_rows[:split], p_cols[:split],
                    p_vals[:split], n_features, sparse, dtype,
                )
                p_lab = p_lab[batch:]
                p_rows = p_rows[split:] - batch
                p_cols = p_cols[split:]
                p_vals = p_vals[split:]
    if len(p_lab):
        yield _assemble_batch(
            p_lab, p_rows, p_cols, p_vals, n_features, sparse, dtype
        )


def _dense_numpy(X) -> np.ndarray:
    """A dense numpy copy of a numpy array, a dense tensor or a COO."""
    if isinstance(X, torch.Tensor):
        X = X.to_dense() if X.layout == torch.sparse_coo else X
        return X.detach().cpu().numpy()
    return np.asarray(X)


def write_libsvm(path, X, y) -> None:
    """Write dense or sparse COO ``X`` with labels ``y`` in LIBSVM format
    (byte for byte the JAX package's writer)."""
    X = _dense_numpy(X)
    y = _dense_numpy(y)
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            label = y[i]
            lab = (
                str(int(label))
                if float(label).is_integer()
                else repr(float(label))
            )
            feats = " ".join(
                f"{j + 1}:{X[i, j]:.17g}"
                for j in range(X.shape[1])
                if X[i, j] != 0
            )
            f.write(f"{lab} {feats}\n".rstrip() + "\n")
