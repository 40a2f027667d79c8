"""The streaming accumulation engine: batches into a checkpointable fold
(port of ``libskylark_tpu/streaming/engine.py``).

One engine behind every streaming driver: an order-preserving left fold

    acc ← step_fn(acc, batch, index)        index = 0, 1, 2, ...

over a batch source, run as a :class:`~..resilient.chunked.ChunkedSolver`
so that the :class:`~..resilient.runner.ResilientRunner` brings
checkpoint/resume, IO retries, fault injection and the divergence guard.
The state is ``{"batch": int64, "acc": <driver state>}``; a killed pass
resumed from its newest checkpoint folds the remaining batches in the
same order, so its accumulator is bitwise the uninterrupted run's.

Sources are re-openable: a plain iterable (one pass, no resume) or a
``factory(start_batch) -> iterator`` that yields from ``start_batch`` on.

A columnwise step calls the transform's slice methods directly
(:func:`accumulate_slice`): the JAX package's planned steps compile the
same methods, so there is no planned/eager pair to keep equal here.
"""

from __future__ import annotations

import os
from itertools import islice

import numpy as np
import torch

from .. import guard
from .._device import resolve_device
from ..resilient import ChunkedSolver, ResilientParams, ResilientRunner
from ..sketch.base import Dimension
from . import overlap as _overlap
from .pipeline import Prefetcher, device_placer, ready

__all__ = ["StreamParams", "as_block_factory", "run_stream", "skip_batches",
           "accumulate_slice", "fused_enabled", "stream_device"]


def fused_enabled() -> bool:
    """Fused stream-chunk steps (``apply_slice_kernel_acc``) are on unless
    ``SKYLARK_NO_FUSED_CHUNKS=1`` (read per call), as in the JAX
    package."""
    return os.environ.get("SKYLARK_NO_FUSED_CHUNKS", "").lower() not in ("1", "true")


class StreamParams(ResilientParams):
    """Knobs of a streaming pass: the resilient runner's (checkpointing,
    retries, divergence; ``checkpoint_every`` counts batches here) plus
    the pipeline's: ``prefetch`` staged batches (0: no producer thread),
    the staging ``placer`` (host→card by default; its ``device``
    attribute, where it has one, places the accumulators),
    ``fused_chunks`` (the transform's fused chunk step, bitwise the
    two-step composite; None defers to :func:`fused_enabled`) and
    ``overlap`` (sync at chunk boundaries only; None defers to
    ``overlap.enabled``).  A pass leaves its prefetch counters in
    ``prefetch_stats``."""

    def __init__(self, *, prefetch: int = 2, placer=device_placer,
                 fused_chunks: bool | None = None, overlap: bool | None = None, **kw):
        super().__init__(**kw)
        self.prefetch = int(prefetch)
        self.placer = placer
        self.fused_chunks = fused_chunks
        self.overlap = overlap
        self.prefetch_stats = None


def stream_device(params: StreamParams) -> torch.device:
    """Where a pass keeps its accumulators: the placer's device, else the
    port's default device (the card)."""
    return resolve_device(getattr(params.placer, "device", None))


def accumulate_slice(S, acc, block, start: int, *, fused: bool | None = None):
    """One COLUMNWISE streaming step: ``acc + S.apply_slice(block, start)``
    cast to ``acc.dtype``.  Dense 2-D blocks of a transform with a slice
    kernel take ``apply_slice_kernel_acc`` (``fused``, default
    :func:`fused_enabled`: one launch per chunk for the hash sketches) or
    the composite ``acc + apply_slice_kernel``, bitwise the same; sparse
    blocks take ``apply_slice``."""
    if (block.layout != torch.strided or block.ndim != 2
            or not getattr(S, "supports_slice_kernel", False)):
        return acc + S.apply_slice(block, int(start), Dimension.COLUMNWISE).to(acc.dtype)
    if fused is None:
        fused = fused_enabled()
    if fused:
        return S.apply_slice_kernel_acc(acc, block, start)
    return acc + S.apply_slice_kernel(block, start).to(acc.dtype)


def as_block_factory(source):
    """A source as ``factory(start_batch) -> iterator``.  Callables pass
    through (they own the skip); an iterable becomes a one-shot factory
    that can only start at batch 0 — resume needs a real factory."""
    if callable(source):
        return source
    state = {"used": False}

    def factory(start: int):
        if state["used"] or start:
            raise ValueError(
                "this source is a one-shot iterable and cannot be re-opened "
                f"(requested start batch {start}); pass a factory "
                "`lambda start: ...` for resumable streams")
        state["used"] = True
        return iter(source)

    return factory


class _Cursor:
    """Lazily opened, position-tracked view of the batch stream with a
    one-item lookahead (so ``is_done`` needs no side channel), the
    prefetch pipeline around the remaining tail."""

    def __init__(self, factory, prefetch: int, placer):
        self._factory = factory
        self._prefetch = prefetch
        self._placer = placer
        self._it = None
        self._prefetcher = None
        self.pos = -1  # batch index of the lookahead item
        self.pending = None

    def ensure(self, at: int):
        if self._it is not None:
            if self.pos != at:
                raise RuntimeError(f"stream cursor at batch {self.pos}, state wants {at}; "
                                   "streaming passes must be driven sequentially")
            return
        raw = iter(self._factory(at))
        if self._prefetch > 0:
            self._prefetcher = Prefetcher(raw, depth=self._prefetch, placer=self._placer)
            self._it = self._prefetcher
        elif self._placer is not None:
            self._it = (ready(self._placer(b)) for b in raw)
        else:
            self._it = raw
        self.pos = at - 1
        self.advance()

    def advance(self):
        try:
            self.pending = next(self._it)
        except StopIteration:
            self.pending = None
        self.pos += 1

    @property
    def stats(self):
        return self._prefetcher.stats if self._prefetcher is not None else None

    def close(self):
        if self._prefetcher is not None:
            self._prefetcher.close()


def skip_batches(it, k: int):
    """Drop the first ``k`` items: the generic (re-parse) skip for
    factories over sources that cannot seek."""
    return islice(it, k, None)


def run_stream(source, step_fn, init_acc, params: StreamParams | None = None, *,
               kind: str = "streaming_pass", metadata: dict | None = None,
               fault_plan=None, report=None):
    """Fold ``step_fn`` over ``source`` with resilient checkpoints; returns
    ``(acc, batches)``.  ``init_acc`` is built without consuming the
    stream (the drivers know their output shapes) and is the prototype a
    resumed checkpoint is validated against.

    Guarding (``SKYLARK_GUARD``, on by default): one finiteness probe per
    chunk, at the chunk boundary, sees a poisoned batch anywhere in the
    chunk; then the chunk's fold replays from the chunk-entry
    accumulator over the buffered (clean) batches, and a replay that
    stays non-finite raises ``NumericalHealthError``.  ``report`` (a
    ``guard.RecoveryReport``) collects the replays.  The pass's
    :class:`~.pipeline.PrefetchStats` (None without prefetch) are left in
    ``params.prefetch_stats``.
    """
    params = params or StreamParams()
    overlapped = _overlap.enabled(params.overlap)
    cursor = _Cursor(as_block_factory(source), params.prefetch, params.placer)

    def init_state():
        return {"batch": np.asarray(0, np.int64), "acc": init_acc}

    def step_chunk(state, k):
        guarded = guard.enabled()
        b0 = int(state["batch"])
        cursor.ensure(b0)
        acc = state["acc"]
        blocks = [] if guarded else None
        b = b0
        for _ in range(k):
            if cursor.pending is None:
                break
            block = cursor.pending
            if blocks is not None:
                blocks.append(block)
            if fault_plan is not None:
                block = fault_plan.corrupt_block(b, block)
            acc = step_fn(acc, block, b)
            if not overlapped:
                _overlap.step_sync(acc)
            b += 1
            cursor.advance()
        if overlapped and b > b0:
            _overlap.chunk_sync(acc)
        if guarded and b > b0 and not guard.tree_all_finite(acc):
            if report is not None:
                report.record("replay", chunk=b0,
                              detail="non-finite accumulator; re-folding chunk")
            acc = state["acc"]
            for j, block in enumerate(blocks):
                if fault_plan is not None:
                    block = fault_plan.corrupt_block(b0 + j, block)
                acc = step_fn(acc, block, b0 + j)
            if not guard.tree_all_finite(acc):
                raise guard.NumericalHealthError(
                    f"streaming accumulator non-finite after replay of batches [{b0}, {b})",
                    stage=kind, report=report)
            if report is not None:
                report.recovered = True
        return {"batch": np.asarray(b, np.int64), "acc": acc}

    def is_done(state):
        cursor.ensure(int(state["batch"]))
        return cursor.pending is None

    solver = ChunkedSolver(
        init_state=init_state,
        step_chunk=step_chunk,
        extract_result=lambda state: (state["acc"], int(state["batch"])),
        is_done=is_done,
        iteration=lambda state: int(state["batch"]),
        kind=kind,
    )
    try:
        return ResilientRunner(solver, params, metadata=dict(metadata or {}),
                               fault_plan=fault_plan).run()
    finally:
        params.prefetch_stats = cursor.stats
        cursor.close()
