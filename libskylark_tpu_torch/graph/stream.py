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
:func:`streaming_ase` embeds a graph from that one pass.  With
``partition=`` (an edge :class:`~..streaming.RowPartition`) every rank
of a ``torch.distributed`` world folds its edge share and one sum
merges the partials.  :func:`chained_adjacency_sketch` computes ``S₂·(S₁·A)``
in core through the sharded sparse-out schedule
(``parallel.columnwise_sharded_sparse_out``, then
``ShardedBCOO.sketch_columnwise``) or streamed, the same bits either
way by the argument above.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..sketch.hash import HashSketch, _segment_sum
from ..utils.exceptions import InvalidParameters

__all__ = [
    "graph_block_source",
    "adjacency_sketch_fold",
    "incore_adjacency_sketch",
    "streamed_adjacency_sketch",
    "chained_adjacency_sketch",
    "ase_from_sketch",
    "streaming_ase",
]


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
    ``V·√|λ|``.  ``SA`` is one tensor (a sharded sketch merges by psum
    onto slot 0's device), so the reference's ``fully_replicated`` points
    have nothing to gather."""
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
    stages the blocks and places the accumulator).  With
    ``partition=None`` it is bitwise :func:`incore_adjacency_sketch`
    (module docstring).  With an edge
    :class:`~libskylark_tpu_torch.streaming.RowPartition` (``nrows`` the
    unique undirected edges, ``params`` an ``ElasticParams``) every rank
    of a live ``torch.distributed`` world folds its edge share and the
    partials merge with one sum; simulated ranks drive
    ``elastic_run_stream`` over :func:`adjacency_sketch_fold` and merge
    by hand."""
    from .. import guard
    from ..sketch.base import Dimension
    from ..streaming.engine import StreamParams, run_stream, stream_device

    kind = "graph_streaming_sketch"
    report = guard.RecoveryReport(stage=kind)
    if partition is None:
        params = params or StreamParams()
        init_at, step = adjacency_sketch_fold(S, ncols, dtype, device=stream_device(params))
        acc, _ = run_stream(source, step, init_at(0), params, kind=kind,
                            fault_plan=fault_plan, report=report)
        merged = acc["sa"]
    else:
        from ..parallel.collectives import cross_host_psum
        from ..streaming.elastic import (ElasticParams, _make_watchdog, _require_real_world,
                                         _resolve_world, elastic_run_stream)

        _require_real_world(partition)
        params = params or ElasticParams()
        rank, world = _resolve_world(params)
        partition.validate_world(rank, world)
        e0, e1 = partition.row_range(rank)
        kind = "graph_distributed_sketch"
        init_at, step = adjacency_sketch_fold(S, ncols, dtype, device=stream_device(params))
        acc, _ = elastic_run_stream(source, step, init_at(e0), partition, params, kind=kind,
                                    fault_plan=fault_plan, report=report, epoch=epoch)
        edges = int(acc["edge"])
        if edges != e1:
            raise ValueError(f"rank {rank} folded edges [{e0}, {edges}) but its partition "
                             f"share is [{e0}, {e1}); the source and partition disagree")
        watchdog = (_make_watchdog(params, params.checkpoint_dir, rank, world, epoch)
                    if params.checkpoint_dir else None)
        merged = cross_host_psum({"sa": acc["sa"]}, watchdog=watchdog)["sa"]
    out = S.finalize_slices(merged, Dimension.COLUMNWISE)
    if guard.enabled():
        guard.check_finite(out, kind, report=report)
    return out


def chained_adjacency_sketch(G, S1, S2, *, mesh=None, streamed: bool = False,
                             batch_edges: int = 65536, dtype=None, device=None):
    """``S₂·(S₁·A)`` of a graph's adjacency without a densified
    intermediate in core.

    In core (default): the COO adjacency rides
    :func:`~libskylark_tpu_torch.parallel.columnwise_sharded_sparse_out`,
    so ``S₁·A`` lands ROW-BLOCK-SHARDED over ``mesh``'s slots, and
    :meth:`~libskylark_tpu_torch.parallel.ShardedBCOO.sketch_columnwise`
    hashes it in place (one psum, no gather); the result is one tensor on
    slot 0's device.  ``mesh=None`` is a 1-D mesh over the visible cards
    (over ``device`` where one is given).  ``streamed=True`` folds
    ``S₁·A`` from edge blocks first (:func:`streamed_adjacency_sketch`,
    placed on ``device``), then applies ``S₂``: the same bits, by the
    exactness argument of the module docstring.  ``dtype`` is torch's
    default dtype when None, for both routes (the JAX package's None is
    its default float in core and f64 streamed, one dtype under x64).
    Requires ``S2.n == S1.s``."""
    from ..parallel.collectives import columnwise_sharded_sparse_out
    from ..parallel.mesh import ROWS, make_mesh
    from .graph import SimpleGraph

    if S2.n != S1.s:
        raise InvalidParameters(
            f"chained sketch needs S2.n == S1.s, got S2.n={S2.n}, S1.s={S1.s}")
    dtype = dtype or torch.get_default_dtype()
    if streamed:
        from ..streaming.engine import StreamParams
        from ..streaming.pipeline import pinned_placer

        params = StreamParams(placer=pinned_placer(resolve_device(device)))
        SA1 = streamed_adjacency_sketch(graph_block_source(G, batch_edges=batch_edges), S1,
                                        ncols=G.n, dtype=dtype, params=params)
        return S2.apply(SA1, "columnwise")
    if not isinstance(G, SimpleGraph):
        raise InvalidParameters("chained_adjacency_sketch needs a SimpleGraph")
    if mesh is None:
        if device is None:
            mesh = make_mesh((torch.cuda.device_count() or 1,), (ROWS,))
        else:
            mesh = make_mesh((1,), (ROWS,), devices=device)
    A = G.adjacency_coo(dtype, mesh.device(0))
    sharded = columnwise_sharded_sparse_out(S1, A, mesh)
    return sharded.sketch_columnwise(S2, dense_output=True)


def streaming_ase(source, n: int, k: int, context, params=None, *, dtype=torch.float64,
                  partition=None, fault_plan=None, epoch: int = 0, stream_params=None):
    """Streaming randomized adjacency spectral embedding: ``(X, lam)``
    from ONE pass over the edges.  The only O(edges) work is the streamed
    fold ``SA = Ω·A`` (SJLT Ω of the oversampled width ``_sketch_size``
    gives); the embedding ``X = V·√|λ|`` follows from
    :func:`ase_from_sketch`.  Subspace iteration would re-stream the
    edges, so ``num_iterations > 0`` is refused.  ``stream_params``
    places and checkpoints the fold (an ``ElasticParams`` with
    ``partition=``, the elastic route of
    :func:`streamed_adjacency_sketch`)."""
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
