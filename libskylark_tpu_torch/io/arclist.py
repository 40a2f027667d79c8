"""Streamed arc-list reader: chunked COO edge blocks over ByteSources (port
of ``libskylark_tpu/io/arclist.py``; numpy, as there).

≙ the reference's arc-list loaders (``utility/io``) re-founded on the
same checkpointable-fold contract as ``stream_libsvm``: a billion-edge
file is parsed chunk-by-chunk from any :class:`~.source.ByteSource`
(local path, ``file://``, fsspec URL, in-memory bytes) and yielded as
fixed-size COO edge blocks — symmetrized, globally deduped, self-loops
dropped — without ever materializing the graph.

Contract (what makes the streamed fold bitwise-reproducible):

- **Deterministic blocks.** Given the same ``(source, index, batch_edges)``
  the generator yields the identical block sequence — chunk boundaries
  (``chunk_bytes``) never change *which* edges appear or their order,
  only how many file reads it takes to find them.  This is what lets
  ``streaming.engine.run_stream`` re-open the source at batch *k* on
  resume and replay into a bit-identical accumulator.
- **First-occurrence dedup.** Duplicate and reversed duplicates of an
  undirected edge (``u v`` then ``v u``) collapse to the first
  occurrence, in file order — matching ``SimpleGraph``'s ``set``-of-
  canonical-pairs semantics edge-for-edge.
- **Self-loops dropped by name** (before any id lookup), matching
  ``SimpleGraph.__init__``; a vertex appearing only in self-loops gets
  no id.

Dedup state is a sorted ``int64`` array of packed ``(lo << 32) | hi``
keys — O(unique undirected edges) host memory, the one thing that does
scale with the graph (ids, not the edge file, must fit; the adjacency
never does).
"""

from __future__ import annotations

from itertools import islice

import numpy as np

from .source import _lines_of, open_source

__all__ = [
    "scan_arc_list",
    "stream_arc_list",
    "arc_list_source",
]

# Vertex ids are packed two-per-int64 for the dedup set.
_MAX_VERTICES = 1 << 32


def _parse_edge_block(block: bytes):
    """Parse complete lines into (us, vs) name lists.

    Comment lines (``#``/``%``), blanks, and short lines are skipped;
    self-loops are dropped by *name* (``SimpleGraph`` semantics).  Extra
    columns (weights) are ignored — the graph layer is unweighted.
    """
    us: list[str] = []
    vs: list[str] = []
    for raw in block.decode().splitlines():
        line = raw.strip()
        if not line or line[0] in "#%":
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        u, v = parts[0], parts[1]
        if u == v:
            continue
        us.append(u)
        vs.append(v)
    return us, vs


def _chunk_lines(src, chunk_bytes: int):
    """Yield byte blocks of complete lines (torn-tail carry, as
    ``stream_libsvm`` does): a line split across two reads is re-joined
    before parsing, and a final line without a trailing newline is still
    delivered."""
    with src.open() as f:
        for block in _lines_of(f, chunk_bytes):
            if block:
                yield block


def _pack(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.astype(np.int64) << 32) | hi.astype(np.int64)


def scan_arc_list(path, chunk_bytes: int = 8 << 20):
    """One cheap pass over the file: returns ``(index, num_edges)``.

    ``index`` maps vertex name → contiguous id in first-seen order
    (scanning ``u`` then ``v`` per edge — identical to
    ``SimpleGraph.__init__``); ``num_edges`` counts unique undirected
    edges, i.e. the ``nrows`` an elastic ``RowPartition`` over the edge
    stream should be built with.
    """
    src = open_source(path)
    index: dict = {}
    seen = np.empty(0, dtype=np.int64)
    for block in _chunk_lines(src, chunk_bytes):
        us, vs = _parse_edge_block(block)
        if not us:
            continue
        for u, v in zip(us, vs):
            if u not in index:
                index[u] = len(index)
            if v not in index:
                index[v] = len(index)
        ids = np.fromiter(
            (index[w] for pair in zip(us, vs) for w in pair),
            dtype=np.int64,
            count=2 * len(us),
        ).reshape(-1, 2)
        lo, hi = ids.min(axis=1), ids.max(axis=1)
        seen = np.union1d(seen, _pack(lo, hi))
    if len(index) >= _MAX_VERTICES:
        raise ValueError(
            f"arc list has {len(index)} vertices; the packed dedup key "
            f"supports < {_MAX_VERTICES}"
        )
    return index, int(seen.size)


def stream_arc_list(
    path,
    *,
    index=None,
    batch_edges: int = 65536,
    chunk_bytes: int = 8 << 20,
    dtype=np.float64,
):
    """Yield symmetrized COO edge blocks from an arc list.

    Each block is ``{"rows", "cols", "vals"}`` holding ``2*k`` entries
    for ``k`` undirected edges (both directions, ``vals`` all ones in
    ``dtype``).  Every block carries exactly ``batch_edges`` undirected
    edges except the final one, which may be short.  Blocks appear in
    file order after first-occurrence dedup, so the sequence is
    deterministic and independent of ``chunk_bytes``.

    ``index``: vertex name → id mapping (from :func:`scan_arc_list` or a
    ``SimpleGraph``).  ``None`` runs the scan pass here first.
    """
    if index is None:
        index, _ = scan_arc_list(path, chunk_bytes=chunk_bytes)
    if len(index) >= _MAX_VERTICES:
        raise ValueError(
            f"index has {len(index)} vertices; the packed dedup key "
            f"supports < {_MAX_VERTICES}"
        )
    src = open_source(path)
    seen = np.empty(0, dtype=np.int64)
    plo = np.empty(0, dtype=np.int64)
    phi = np.empty(0, dtype=np.int64)

    def _block(lo: np.ndarray, hi: np.ndarray):
        k = lo.size
        return {
            "rows": np.concatenate([lo, hi]),
            "cols": np.concatenate([hi, lo]),
            "vals": np.ones(2 * k, dtype=dtype),
        }

    for block in _chunk_lines(src, chunk_bytes):
        us, vs = _parse_edge_block(block)
        if not us:
            continue
        ids = np.fromiter(
            (index[w] for pair in zip(us, vs) for w in pair),
            dtype=np.int64,
            count=2 * len(us),
        ).reshape(-1, 2)
        lo, hi = ids.min(axis=1), ids.max(axis=1)
        keys = _pack(lo, hi)
        # Within-chunk + cross-chunk dedup, keeping file order of first
        # occurrences: np.unique sorts by key, so re-sort the surviving
        # first-occurrence positions.
        uk, first = np.unique(keys, return_index=True)
        fresh = ~np.isin(uk, seen)
        firsts = np.sort(first[fresh])
        seen = np.union1d(seen, uk[fresh])
        plo = np.concatenate([plo, lo[firsts]])
        phi = np.concatenate([phi, hi[firsts]])
        while plo.size >= batch_edges:
            yield _block(plo[:batch_edges], phi[:batch_edges])
            plo, phi = plo[batch_edges:], phi[batch_edges:]
    if plo.size:
        yield _block(plo, phi)


def arc_list_source(
    path,
    *,
    index,
    batch_edges: int = 65536,
    chunk_bytes: int = 8 << 20,
    dtype=np.float64,
):
    """Checkpointable block factory over an arc list.

    Returns ``factory(start_batch)`` suitable for
    ``streaming.engine.run_stream`` / ``elastic_run_stream``: resume at
    batch *k* re-parses the file and skips the first *k* blocks (the
    generic re-parse skip — arc lists are not seekable by batch).  The
    vertex ``index`` is required here: a resumed rank must not re-derive
    it from a partial read.
    """

    def factory(start_batch: int = 0):
        it = stream_arc_list(
            path,
            index=index,
            batch_edges=batch_edges,
            chunk_bytes=chunk_bytes,
            dtype=dtype,
        )
        return islice(it, start_batch, None)

    return factory
