"""Simple undirected graph container built from an edge list (port of
``libskylark_tpu/graph/graph.py``).

Edges are symmetrized, self-loops dropped and duplicates collapsed;
vertex names may be arbitrary hashables and ``index`` maps name →
contiguous id, interned in first-seen order (``u`` then ``v`` per
edge), so both packages number the vertices of one edge list alike.
The CSR arrays are numpy, as in the JAX package; ``adjacency_coo`` is
the port's counterpart of ``adjacency_bcoo``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["SimpleGraph"]


def _csr(n: int, rows, cols):
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n)
    indptr = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(counts, dtype=np.int64)])
    return indptr, cols


class SimpleGraph:
    def __init__(self, edges):
        """edges: iterable of (u, v) pairs (strings or ints)."""
        # Self-loops drop before interning: a vertex appearing only in
        # self-loops gets no id.
        pairs = [(u, v) for u, v in edges if u != v]
        flat = [w for pair in pairs for w in pair]
        names = {w: i for i, w in enumerate(dict.fromkeys(flat))}
        self.vertices = list(names)
        self.index = names
        n = len(names)
        self.n = n
        if not pairs:
            self.indptr = np.zeros(n + 1, dtype=np.int64)
            self.indices = np.empty(0, dtype=np.int64)
            return
        ids = np.fromiter((names[w] for w in flat), dtype=np.int64,
                          count=len(flat)).reshape(-1, 2)
        und = np.unique(np.stack([ids.min(axis=1), ids.max(axis=1)], axis=1), axis=0)
        self.indptr, self.indices = _csr(n, np.concatenate([und[:, 0], und[:, 1]]),
                                         np.concatenate([und[:, 1], und[:, 0]]))

    def with_edges(self, pairs):
        """New graph absorbing extra edges over the EXISTING vertex set.

        ``pairs``: iterable of (u, v) vertex ids or names.  Returns
        ``(G2, new_pairs)``: the merged graph (same interning, CSR
        rebuilt) and the (r, 2) int64 array of undirected (lo, hi) pairs
        that were new (self-loops and edges already present dropped,
        duplicates collapsed).  Unknown vertices raise ``KeyError``.
        """
        ids = []
        for u, v in pairs:
            iu = u if isinstance(u, (int, np.integer)) else self.index.get(u)
            iv = v if isinstance(v, (int, np.integer)) else self.index.get(v)
            if iu is None or iv is None or not (
                0 <= int(iu) < self.n and 0 <= int(iv) < self.n
            ):
                raise KeyError(
                    f"with_edges: unknown vertex in ({u!r}, {v!r}); live "
                    "folds are over the registered vertex set"
                )
            if int(iu) != int(iv):
                ids.append((int(iu), int(iv)))
        g2 = object.__new__(SimpleGraph)
        g2.vertices = self.vertices
        g2.index = self.index
        g2.n = self.n
        g2.indptr, g2.indices = self.indptr, self.indices
        if not ids:
            return g2, np.empty((0, 2), np.int64)
        arr = np.asarray(ids, np.int64)
        cand = np.unique(np.stack([arr.min(axis=1), arr.max(axis=1)], axis=1), axis=0)
        old_rows = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        have = set(zip(old_rows.tolist(), self.indices.tolist()))
        fresh = np.asarray(
            [p for p in cand.tolist() if (p[0], p[1]) not in have], np.int64
        ).reshape(-1, 2)
        if fresh.size:
            g2.indptr, g2.indices = _csr(
                self.n, np.concatenate([old_rows, fresh[:, 0], fresh[:, 1]]),
                np.concatenate([self.indices, fresh[:, 1], fresh[:, 0]]))
        return g2, fresh

    # -- accessors ------------------------------------------------------------

    def degree(self, i: int) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    @property
    def volume(self) -> int:
        """Total volume Σ deg = 2·|E|."""
        return int(self.indices.size)

    def adjacency(self, dtype=np.float64):
        """Dense (n, n) numpy adjacency (for moderate graphs)."""
        A = np.zeros((self.n, self.n), dtype=dtype)
        A[np.repeat(np.arange(self.n), self.degrees), self.indices] = 1.0
        return A

    def adjacency_coo(self, dtype=None, device=None) -> torch.Tensor:
        """Sparse COO adjacency (n, n) of ones in ``dtype`` (torch's
        default dtype when None), in CSR order, on ``device``."""
        dev = resolve_device(device)
        rows = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        idx = torch.from_numpy(np.stack([rows, self.indices.astype(np.int64)])).to(dev)
        data = torch.ones(self.indices.size, dtype=dtype or torch.get_default_dtype(),
                          device=dev)
        return torch.sparse_coo_tensor(idx, data, (self.n, self.n), check_invariants=False)
