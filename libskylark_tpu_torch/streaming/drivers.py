"""Streaming drivers: one-pass sketching and solvers over batch sources
(port of ``libskylark_tpu/streaming/drivers.py``).

Every sketch is a counter-addressed linear (or linear-then-pointwise)
map, so ``S·A`` decomposes exactly into per-batch partial sketches
(``SketchTransform.apply_slice``) merged by sum (COLUMNWISE) or
concatenation (ROWWISE): data larger than the card streams through in
bounded memory while the prefetch pipeline copies the next batch.

- :func:`sketch` and :func:`sketch_batches` consume array blocks (rows
  of A);
- :func:`sketch_least_squares` and :func:`kernel_ridge` consume
  ``(X_block, y_block)`` pairs.

Each takes an iterable or a re-openable ``factory(start_batch) ->
iterator`` (needed for resume; ``engine.as_block_factory``).  Batches
are tensors or numpy arrays; the placer stages them on the card unless
``StreamParams(placer=pinned_placer("cpu"))`` says otherwise.  The
multi-host routes (``partition=``) raise ``UnsupportedError`` naming
ROADMAP Queue A item 9.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import guard
from ..sketch.base import Dimension
from ..utils.exceptions import UnsupportedError
from .engine import StreamParams, accumulate_slice, as_block_factory, run_stream, stream_device
from .pipeline import BucketedBatch, Prefetcher, ready

__all__ = ["sketch", "sketch_batches", "sketch_least_squares", "kernel_ridge"]

_ITEM9 = "ROADMAP Queue A item 9: multi-device (elastic streaming over a RowPartition)"


def _no_partition(partition) -> None:
    if partition is not None:
        raise UnsupportedError(f"partition= (distributed streaming) is not ported yet "
                               f"({_ITEM9})")


def _unwrap(block):
    """``(block, rows)``, transparent over ``bucketed_placer``'s batches."""
    if isinstance(block, BucketedBatch):
        return block.block, int(block.true_rows)
    return block, int(block.shape[0])


def _result_dtype(requested) -> torch.dtype:
    """The accumulators' dtype: as asked, else torch's default float (the
    JAX package's default follows its x64 mode the same way)."""
    return requested if requested is not None else torch.get_default_dtype()


def _float_dtype(x) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def sketch(source, S, dim: Dimension | str = Dimension.COLUMNWISE, *, ncols: int | None = None,
           dtype=None, params: StreamParams | None = None, fault_plan=None, partition=None):
    """One-pass ``S·A`` (COLUMNWISE) or ``A·Ωᵀ`` (ROWWISE) over row blocks
    of A, never materializing A.

    COLUMNWISE: blocks are consecutive row slices of the (N, m) input,
    their rows summing to ``S.n``; ``ncols`` (= m) sizes the (S, m)
    accumulator up front (it is also the resume prototype).  Partials
    merge by sum, then ``S.finalize_slices``.  Checkpoint/resume comes
    through ``params``: a killed pass resumed from its newest checkpoint
    is bitwise the uninterrupted run.

    ROWWISE: each block carries the whole feature axis; finished
    per-block sketches concatenate in stream order.  There is no
    fixed-shape state to checkpoint, so ``params.checkpoint_dir`` is
    refused; :func:`sketch_batches` keeps the output streamed too.
    """
    dim = Dimension.of(dim)
    _no_partition(partition)
    params = params or StreamParams()
    if dim is Dimension.ROWWISE:
        if params.checkpoint_dir:
            raise ValueError("rowwise streaming concatenates (no fixed-shape accumulator to "
                             "checkpoint); stream columnwise or drop checkpoint_dir")
        blocks = list(sketch_batches(source, S, params=params))
        if not blocks:
            raise ValueError("empty stream: no rows to sketch")
        return torch.cat(blocks, dim=0)
    if ncols is None:
        raise ValueError("columnwise streaming needs ncols (the width m of A) to size "
                         "the (S, m) accumulator")
    init = {
        "sa": torch.zeros((S.s, int(ncols)), dtype=_result_dtype(dtype),
                          device=stream_device(params)),
        "row": np.asarray(0, np.int64),
    }

    def step(acc, block, index):
        row = int(acc["row"])
        block, k = _unwrap(block)
        return {"sa": accumulate_slice(S, acc["sa"], block, row, fused=params.fused_chunks),
                "row": np.asarray(row + k, np.int64)}

    report = guard.RecoveryReport(stage="streaming_sketch")
    acc, _ = run_stream(source, step, init, params, kind="streaming_sketch",
                        fault_plan=fault_plan, report=report)
    rows = int(acc["row"])
    if rows != S.n:
        raise ValueError(f"stream covered {rows} rows but the sketch domain is {S.n}; "
                         "the source and transform disagree")
    out = S.finalize_slices(acc["sa"], Dimension.COLUMNWISE)
    if guard.enabled():
        guard.check_finite(out, "streaming_sketch", report=report)
    return out


def sketch_batches(source, S, *, params: StreamParams | None = None):
    """Generator of finished ROWWISE sketches, one per input block: input
    and output both streamed.  The transform's counter-realized operands
    are hoisted once (``hoistable_operands``, memoized by the transform)
    and every block goes through ``apply_with_operands``, bitwise its
    ``apply``."""
    params = params or StreamParams()
    it = iter(as_block_factory(source)(0))
    pf = None
    if params.prefetch > 0:
        pf = it = Prefetcher(it, depth=params.prefetch, placer=params.placer)
    elif params.placer is not None:
        it = (ready(params.placer(b)) for b in it)
    try:
        for block in it:
            block, _ = _unwrap(block)
            ops = S.hoistable_operands(_float_dtype(block), block.device)
            yield S.apply_with_operands(ops, block, Dimension.ROWWISE)
    finally:
        if pf is not None:
            pf.close()


def sketch_least_squares(source, S, *, ncols: int, targets: int = 1, alg: str = "qr",
                         dtype=None, params: StreamParams | None = None, fault_plan=None,
                         partition=None, policy_decision: dict | None = None):
    """Streaming sketch-and-solve least squares: accumulate ``(S·A, S·b)``
    over ``(A_block, b_block)`` batches in one pass, then solve the small
    (s, n) problem exactly (≙ ``ApproximateLeastSquares``,
    ``nla/least_squares.hpp:42-184``, with the applies decomposed over
    row blocks).  ``S`` must be a linear sketch.  Returns ``(x, info)``
    with ``info = {"rows", "batches", "seconds", "recovery"}`` (plus
    ``"policy"`` when a ``policy_decision`` is given); ``recovery`` is the
    guard's report (chunk replays, the certificate, the small-solve
    fallback).
    """
    from ..linalg.least_squares import exact_least_squares

    _no_partition(partition)
    params = params or StreamParams()
    dt = _result_dtype(dtype)
    dev = stream_device(params)
    init = {
        "sa": torch.zeros((S.s, int(ncols)), dtype=dt, device=dev),
        "sb": torch.zeros((S.s, int(targets)), dtype=dt, device=dev),
        "row": np.asarray(0, np.int64),
    }

    def step(acc, batch, index):
        A_b, b_b = batch
        row = int(acc["row"])
        b2 = b_b[:, None] if b_b.ndim == 1 else b_b
        return {
            "sa": accumulate_slice(S, acc["sa"], A_b, row, fused=params.fused_chunks),
            "sb": accumulate_slice(S, acc["sb"], b2, row, fused=params.fused_chunks),
            "row": np.asarray(row + A_b.shape[0], np.int64),
        }

    guarded = guard.enabled()
    report = (guard.RecoveryReport(stage="streaming_lsq") if guarded
              else guard.RecoveryReport.disabled("streaming_lsq"))
    t0 = time.perf_counter()
    acc, nbatches = run_stream(source, step, init, params, kind="streaming_lsq",
                               fault_plan=fault_plan, report=report)
    rows = int(acc["row"])
    if rows != S.n:
        raise ValueError(f"stream covered {rows} rows but the sketch domain is {S.n}")
    SA = S.finalize_slices(acc["sa"], Dimension.COLUMNWISE)
    SB = S.finalize_slices(acc["sb"], Dimension.COLUMNWISE)
    if guarded:
        # A streamed sketch is fixed after its one pass: no resketch rung,
        # so a failed certificate degrades the small solve to the SVD
        # pseudoinverse, which takes rank deficiency.
        cert = guard.certify_sketch(SA, stage="streaming_lsq")
        report.record("initial", verdict=cert.verdict, detail=cert.detail, cond=cert.cond,
                      sketch_size=int(SA.shape[0]))
        if not cert.ok:
            alg = "svd"
            report.record("fallback", verdict=guard.FALLBACK,
                          detail="svd pseudoinverse small solve")
            report.recovered = True
    X = exact_least_squares(SA, SB, alg=alg)
    if guarded:
        guard.check_finite(X, "streaming_lsq", report=report)
    x = X[:, 0] if targets == 1 else X
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    info = {"rows": rows, "batches": nbatches, "seconds": round(time.perf_counter() - t0, 6),
            "recovery": report.to_dict()}
    if policy_decision is not None:
        info["policy"] = policy_decision
    return x, info


def kernel_ridge(source, kernel, lam: float, s: int, context, *, targets: int = 1,
                 krr_params=None, params: StreamParams | None = None, fault_plan=None,
                 dtype=None):
    """Streaming approximate KRR: one pass over ``(X_block, y_block)``
    batches accumulates the (s, s) normal equations of
    ``approximate_kernel_ridge``,

        G += Z_bᵀ Z_b,   c += Z_bᵀ y_b,      Z_b = S(X_block) rowwise,

    then solves ``(G + λI) W = c`` once.  X is never resident; the feature
    map's W is realized once per pass.  Returns the ``FeatureMapModel``
    the in-core solver returns for the same ``context`` (equal up to the
    per-batch order of summation); ``model.info["recovery"]`` carries the
    guard's report (chunk replays, the Cholesky fallback).
    """
    from ..ml.krr import KrrParams, _cho_solve, _cholesky, _plus_lam_eye, _psd_gram, _tag
    from ..ml.model import FeatureMapModel

    params = params or StreamParams()
    krr_params = krr_params or KrrParams()
    S = kernel.create_rft(s, _tag(krr_params), context)
    dt = _result_dtype(dtype)
    acc_dt = torch.promote_types(dt, torch.float32)
    dev = stream_device(params)
    init = {
        "g": torch.zeros((s, s), dtype=acc_dt, device=dev),
        "c": torch.zeros((s, int(targets)), dtype=acc_dt, device=dev),
        "rows": np.asarray(0, np.int64),
    }

    def step(acc, batch, index):
        X_b, y_b = batch
        y2 = y_b[:, None] if y_b.ndim == 1 else y_b
        ops = S.hoistable_operands(_float_dtype(X_b), X_b.device)
        Z = S.apply_with_operands(ops, X_b, Dimension.ROWWISE)
        return {
            "g": acc["g"] + _psd_gram(Z.T, Z).to(acc_dt),
            "c": acc["c"] + (Z.T @ y2.to(Z.dtype)).to(acc_dt),
            "rows": np.asarray(int(acc["rows"]) + X_b.shape[0], np.int64),
        }

    guarded = guard.enabled()
    report = (guard.RecoveryReport(stage="streaming_krr") if guarded
              else guard.RecoveryReport.disabled("streaming_krr"))
    acc, nbatches = run_stream(source, step, init, params, kind="streaming_krr",
                               fault_plan=fault_plan, report=report)
    G = _plus_lam_eye(acc["g"], lam, acc_dt)
    L = _cholesky(G)
    if guarded and not guard.tree_all_finite(L):
        # A singular or indefinite-by-rounding Gram: the factor is NaN, so
        # solve by the eigh pseudoinverse instead.
        W = guard.pinv_psd_solve(G, acc["c"]).to(dt)
        report.record("fallback", verdict=guard.FALLBACK,
                      detail="non-finite Cholesky factor; eigh pseudoinverse solve")
        report.recovered = True
    else:
        W = _cho_solve(L, acc["c"]).to(dt)
    if guarded:
        guard.check_finite(W, "streaming_krr", report=report)
    model = FeatureMapModel([S], W)
    model.info = {"rows": int(acc["rows"]), "batches": nbatches,
                  "recovery": report.to_dict()}
    return model
