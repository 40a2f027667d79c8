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

A columnwise step goes through the plans layer
(:func:`accumulate_slice`, ``plans.accumulate_slice``): one captured
graph per bucket where the transform's step is launch-bound, bitwise
the eager step.  A step never updates its accumulator in place, so the
chunk-entry state the guard's replay reads again needs no copy.

Each chunk is a ``stream.chunk`` span.  With telemetry on the engine
waits for the folded accumulator inside it (the PhaseTimer rule, so
its seconds are device time) and it carries the chunk's ``rows`` and
``batches``, with the ``stream.rows``, ``stream.batches``,
``stream.sentinel_checks`` and ``stream.replays`` counters and the
``stream.rows_per_s`` gauge; a pass's prefetch counters fold into the
registry and a ``stream`` / ``prefetch`` event when it ends.
"""

from __future__ import annotations

from itertools import islice

import numpy as np
import torch

from .. import guard, plans, telemetry
from .._device import resolve_device
from ..plans import fused_enabled
from ..resilient import ChunkedSolver, ResilientParams, ResilientRunner
from ..utils.timer import _cuda_devices
from . import overlap as _overlap
from .pipeline import Prefetcher, device_placer, ready

__all__ = ["StreamParams", "as_block_factory", "run_stream", "skip_batches",
           "accumulate_slice", "fused_enabled", "stream_device"]


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


def accumulate_slice(S, acc, block, start: int, *, fused: bool | None = None,
                     true_rows: int | None = None):
    """One COLUMNWISE streaming step: ``acc + S.apply_slice(block, start)``
    cast to ``acc.dtype``, through ``plans.accumulate_slice`` (dense 2-D
    blocks of a transform with a launch-bound slice kernel replay one
    graph per bucket; ``fused``, default ``plans.fused_enabled()``, takes
    ``apply_slice_kernel_acc``, bitwise the composite; sparse blocks take
    ``apply_slice``).  ``true_rows`` is a host-padded block's real row
    count."""
    return plans.accumulate_slice(S, acc, block, start, fused=fused, true_rows=true_rows)


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


def _rows_of(acc):
    """Row count of a driver accumulator, when it carries one (the
    streaming drivers keep a host ``"row"``/``"rows"`` bookkeeping leaf)."""
    if isinstance(acc, dict):
        for key in ("row", "rows"):
            if key in acc:
                try:
                    return int(acc[key])
                except (TypeError, ValueError):
                    return None
    return None


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

    def fold_chunk(state, k, sp):
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
        if sp is not None:
            sp.attrs["batches"] = b - b0
            if guarded and b > b0:
                telemetry.inc("stream.sentinel_checks")
        if guarded and b > b0 and not guard.tree_all_finite(acc):
            if report is not None:
                report.record("replay", chunk=b0,
                              detail="non-finite accumulator; re-folding chunk")
            telemetry.inc("stream.replays")
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

    def step_chunk(state, k):
        if not telemetry.enabled():
            with telemetry.span("stream.chunk"):
                return fold_chunk(state, k, None)
        with telemetry.span("stream.chunk", kind=kind, chunk=int(state["batch"])) as sp:
            new_state = fold_chunk(state, k, sp)
            # PhaseTimer discipline: wait for the folded accumulator so the
            # span (and its derived rows/s) measures device time.
            for dev in _cuda_devices(new_state["acc"], set()):
                torch.cuda.current_stream(dev).synchronize()
            rows = _rows_of(new_state["acc"])
            if rows is not None:
                sp.attrs["rows"] = rows - (_rows_of(state["acc"]) or 0)
        if sp.seconds and sp.attrs.get("rows"):
            telemetry.inc("stream.rows", sp.attrs["rows"])
            telemetry.set_gauge("stream.rows_per_s", round(sp.attrs["rows"] / sp.seconds, 3))
        telemetry.inc("stream.batches", sp.attrs.get("batches", 0))
        return new_state

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
        st = params.prefetch_stats = cursor.stats
        cursor.close()
        if st is not None and telemetry.enabled():
            _fold_prefetch(st, kind, overlapped)


def _fold_prefetch(st, kind: str, overlapped: bool) -> None:
    """A pass's pipeline evidence into the registry (so ``snapshot()``'s
    ``prefetch_overlap`` and ``overlap_efficiency`` outlive the cursor)
    and one ``stream`` / ``prefetch`` ledger event; ``waits`` are the
    consumer's stalls, ``producer_seconds`` the staging (placer and
    copies), ``wait_seconds`` what the stalls cost."""
    telemetry.inc("prefetch.produced", st.produced)
    telemetry.inc("prefetch.consumed", st.consumed)
    telemetry.inc("prefetch.hits", st.hits)
    telemetry.inc("prefetch.waits", st.waits)
    telemetry.inc("prefetch.producer_seconds", round(st.producer_seconds, 6))
    telemetry.inc("prefetch.wait_seconds", round(st.wait_seconds, 6))
    gets = st.hits + st.waits
    telemetry.event("stream", "prefetch", {
        "kind": kind, "produced": st.produced, "consumed": st.consumed, "hits": st.hits,
        "waits": st.waits, "producer_seconds": round(st.producer_seconds, 6),
        "wait_seconds": round(st.wait_seconds, 6), "overlapped": overlapped,
        "overlap": round(st.hits / gets, 6) if gets else None})
