"""Graph sketching: adjacency folds over edge blocks, the in-core
adjacency sketch and the Nyström eigensolve from it (port of
``libskylark_tpu/graph/stream.py``).

- :func:`adjacency_sketch_fold` folds COO edge blocks (from
  :func:`graph_block_source`) into columnwise ``S·A`` through the same
  per-hash segment sum (``hash._segment_sum``) that the in-core sparse
  apply uses.
- :func:`incore_adjacency_sketch` is the reference:
  ``S.apply(A_coo, "columnwise", dense_output=True)``.
- :func:`ase_from_sketch` recovers the top eigenpairs from the one-pass
  sketch ``SA = Ω·A``.

Folded ≡ in-core is bitwise, not approximate: an unweighted adjacency
has 0/1 entries and the hash values are ±1 (CWT) or ±2⁻¹ (SJLT, nnz=4),
so every partial sum is an exact dyadic rational and IEEE addition is
exact in any order.  Block boundaries and summation schedules (the
kernel's or ``index_add_``'s) cannot change a bit.

:func:`streamed_adjacency_sketch` runs the fold on the streaming
engine (prefetch, checkpoint/resume), bitwise the in-core sketch, and
:func:`streaming_ase` embeds a graph from that one pass.  The elastic
route (``partition=``) and ``chained_adjacency_sketch`` need the
multi-device layer (ROADMAP Queue A item 9) and raise
``UnsupportedError`` naming it.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..sketch.hash import HashSketch, _segment_sum
from ..utils.exceptions import InvalidParameters, UnsupportedError, deferred

__all__ = [
    "graph_block_source",
    "adjacency_sketch_fold",
    "incore_adjacency_sketch",
    "streamed_adjacency_sketch",
    "chained_adjacency_sketch",
    "ase_from_sketch",
    "streaming_ase",
]

_ITEM9 = "ROADMAP Queue A item 9: multi-device (elastic edge partitions, sharded schedules)"
chained_adjacency_sketch = deferred("chained_adjacency_sketch", _ITEM9)


def graph_block_source(G, batch_edges: int = 65536, dtype=np.float64):
    """Block factory over an in-core graph's edges: yields symmetrized
    COO blocks ``{"rows", "cols", "vals"}`` (numpy) of at most
    ``batch_edges`` undirected edges each, in CSR edge order, from block
    ``start_batch`` on."""
    rows_full = np.repeat(np.arange(G.n, dtype=np.int64), G.degrees)
    upper = rows_full < G.indices
    lo = rows_full[upper]
    hi = G.indices[upper].astype(np.int64)

    def factory(start_batch: int = 0):
        for b0 in range(start_batch * batch_edges, lo.size, batch_edges):
            l, h = lo[b0 : b0 + batch_edges], hi[b0 : b0 + batch_edges]
            yield {
                "rows": np.concatenate([l, h]),
                "cols": np.concatenate([h, l]),
                "vals": np.ones(2 * l.size, dtype=dtype),
            }

    return factory


def adjacency_sketch_fold(S, ncols: int, dtype=torch.float64, device=None):
    """``(init_at, step)`` for folding edge blocks into columnwise ``S·A``.

    ``step`` scatters each block's entries through the per-hash segment
    sum keyed by ``bucket·ncols + col``, entry for entry the in-core
    sparse dense-output apply, addressed by global vertex ids.  The
    accumulator's ``"edge"`` leaf counts folded undirected edges."""
    if not isinstance(S, HashSketch):
        raise InvalidParameters(
            f"graph sketch folds need a hash sketch (CWT/SJLT), got "
            f"{type(S).__name__}"
        )
    dev = resolve_device(device)
    ncols = int(ncols)
    # The full bucket/value windows, once: the vertex set fits by contract.
    bs = [S.buckets(h * S.n, S.n, device=dev).long() for h in range(S.nnz)]
    vs = [S.values(dtype, h * S.n, S.n, device=dev) for h in range(S.nnz)]

    def init_at(edge0: int):
        return {
            "sa": torch.zeros((S.s, ncols), dtype=dtype, device=dev),
            "edge": np.asarray(edge0, np.int64),
        }

    def step(acc, block, index):
        rows = torch.as_tensor(block["rows"], device=dev).long()
        cols = torch.as_tensor(block["cols"], device=dev).long()
        vals = torch.as_tensor(block["vals"], device=dev).to(dtype)
        sa = acc["sa"]
        for h in range(S.nnz):
            key = (bs[h][rows] * ncols + cols).int()
            sa = sa + _segment_sum(vals * vs[h][rows], key,
                                   S.s * ncols).to(dtype).reshape(S.s, ncols)
        folded = int(block["rows"].shape[0]) // 2
        return {"sa": sa, "edge": np.asarray(int(acc["edge"]) + folded, np.int64)}

    return init_at, step


def incore_adjacency_sketch(G, S, dtype=None, device=None):
    """The bitwise reference: ``S.apply(A_coo, "columnwise",
    dense_output=True)``.  ``G`` is a ``SimpleGraph`` (its adjacency is
    built in ``dtype`` on ``device``) or a sparse COO adjacency."""
    from .graph import SimpleGraph

    A = G.adjacency_coo(dtype, device) if isinstance(G, SimpleGraph) else G
    if not (isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo):
        raise InvalidParameters(
            f"incore_adjacency_sketch needs a SimpleGraph or sparse COO "
            f"adjacency, got {type(G).__name__}"
        )
    return S.apply(A, "columnwise", dense_output=True)


def ase_from_sketch(SA, S, k: int):
    """Nyström symmetric eigensolve from the one-pass sketch ``SA = Ω·A``.

    With ``Y = AΩᵀ = SAᵀ`` and core ``C = ΩAΩᵀ`` (one more sketch apply,
    no second pass over ``A``), ``A ≈ Y C⁺ Yᵀ``; whitening ``Y`` by
    ``C``'s floored inverse square root and orthogonalizing through Gram
    eigensolves turns that into an eigendecomposition.  Signed: negative
    eigenvalues carry through, exact when ``rank(A) ≤ s``.  Returns
    ``(V, lam)``, the top ``k`` by |λ|; the embedding is
    ``V·√|λ|``.  On one device the reference's ``fully_replicated`` is
    the identity."""
    dtype = SA.dtype
    s = SA.shape[0]
    Y = SA.T  # (n, s) = A·Ωᵀ (A symmetric)
    C = S.apply(Y.contiguous(), "columnwise")  # (s, s) = Ω·A·Ωᵀ
    C = (C + C.T) / 2
    c, Uc = torch.linalg.eigh(C)
    abs_c = c.abs()
    eps = torch.finfo(dtype).eps
    floor = abs_c.max() * eps * s
    zero = torch.zeros((), dtype=dtype, device=SA.device)
    cscale = torch.where(abs_c > floor, torch.rsqrt(torch.maximum(abs_c, floor)), zero)
    sgn = torch.where(abs_c > floor, torch.sign(c), zero)
    M = Y @ (Uc * cscale[None, :])
    g, Vg = torch.linalg.eigh(M.T @ M)
    gfloor = torch.clamp(g[-1], min=0) * eps * s
    gscale = torch.where(g > gfloor, torch.rsqrt(torch.maximum(g, gfloor)), zero)
    Q = M @ (Vg * gscale[None, :])  # M ≈ Q·R
    R = torch.sqrt(torch.clamp(g, min=0))[:, None] * Vg.T
    T = (R * sgn[None, :]) @ R.T
    lam, W = torch.linalg.eigh((T + T.T) / 2)
    order = torch.argsort(-lam.abs())[:k]
    return (Q @ W)[:, order], lam[order]


def streamed_adjacency_sketch(source, S, *, ncols: int, dtype=torch.float64, partition=None,
                              params=None, fault_plan=None, epoch: int = 0):
    """One-pass columnwise ``S·A`` over a stream of edge blocks
    (:func:`graph_block_source`, or any iterable or factory of
    ``{"rows", "cols", "vals"}`` blocks), on the resilient streaming
    engine: checkpoint/resume through ``params`` (a
    :class:`~libskylark_tpu_torch.streaming.StreamParams`, whose placer
    stages the blocks and places the accumulator).  Bitwise
    :func:`incore_adjacency_sketch` (module docstring).  ``partition=``
    (elastic edge partitions) raises ``UnsupportedError`` (ROADMAP Queue A
    item 9)."""
    from .. import guard
    from ..sketch.base import Dimension
    from ..streaming.engine import StreamParams, run_stream, stream_device

    if partition is not None:
        raise UnsupportedError(f"streamed_adjacency_sketch(partition=) is not ported yet "
                               f"({_ITEM9})")
    params = params or StreamParams()
    kind = "graph_streaming_sketch"
    init_at, step = adjacency_sketch_fold(S, ncols, dtype, device=stream_device(params))
    report = guard.RecoveryReport(stage=kind)
    acc, _ = run_stream(source, step, init_at(0), params, kind=kind,
                        fault_plan=fault_plan, report=report)
    out = S.finalize_slices(acc["sa"], Dimension.COLUMNWISE)
    if guard.enabled():
        guard.check_finite(out, kind, report=report)
    return out


def streaming_ase(source, n: int, k: int, context, params=None, *, dtype=torch.float64,
                  partition=None, fault_plan=None, epoch: int = 0, stream_params=None):
    """Streaming randomized adjacency spectral embedding: ``(X, lam)``
    from ONE pass over the edges.  The only O(edges) work is the streamed
    fold ``SA = Ω·A`` (SJLT Ω of the oversampled width ``_sketch_size``
    gives); the embedding ``X = V·√|λ|`` follows from
    :func:`ase_from_sketch`.  Subspace iteration would re-stream the
    edges, so ``num_iterations > 0`` is refused.  ``stream_params``
    places and checkpoints the fold; ``partition=`` raises (ROADMAP
    Queue A item 9)."""
    from ..linalg.svd import SVDParams, _sketch_size
    from ..sketch.hash import SJLT

    params = params or SVDParams()
    if getattr(params, "num_iterations", 0):
        raise InvalidParameters(
            f"streaming ASE is one-pass: subspace iteration (num_iterations="
            f"{params.num_iterations}) would re-stream the edges; use the in-core route "
            "or num_iterations=0")
    k, s = _sketch_size(k, params, n)
    S = SJLT(n, s, context)
    SA = streamed_adjacency_sketch(source, S, ncols=n, dtype=dtype, partition=partition,
                                   params=stream_params, fault_plan=fault_plan, epoch=epoch)
    V, lam = ase_from_sketch(SA, S, k)
    return V * torch.sqrt(lam.abs())[None, :], lam
