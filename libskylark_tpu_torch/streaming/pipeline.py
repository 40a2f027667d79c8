"""Prefetch pipeline: host IO and host→device copies overlapped with the
fold (port of ``libskylark_tpu/streaming/pipeline.py``).

- A producer thread pulls batches from the source iterator (parse,
  decompress: host work) and stages each through the ``placer``.
- :func:`device_placer` copies every host leaf of a batch from pinned
  memory (a pageable leaf is pinned first) with ``non_blocking=True`` on
  a dedicated copy stream (one per device), and records an event behind
  the copies.  The consumer's stream waits on that event
  (:func:`ready`), so the fold of batch k runs while batch k+1 copies.
- A bounded queue of ``depth`` staged batches is the backpressure: host
  memory stays O(depth · batch).

:class:`PrefetchStats` records the evidence of the overlap: ``hits``
count consumer gets that found a batch already staged;
``producer_seconds`` totals the staging (the producer waits for each
batch's copies, so the transfer is inside it) and ``wait_seconds`` the
part of it the consumer stalled on, so ``1 - wait/producer`` is the
fraction of staging hidden under the fold (:meth:`PrefetchStats.hidden`).

A producer's exception is raised in the consumer at the batch where it
happened.  Nothing falls back: a placer asked for CUDA without a card
raises.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "Prefetcher",
    "PrefetchStats",
    "device_placer",
    "pinned_placer",
    "BucketedBatch",
    "bucketed_placer",
    "ready",
]

_COPY_STREAMS: dict = {}


class Staged(NamedTuple):
    """A batch whose copies were issued on a copy stream, with the event
    recorded behind them and their device (None, None off the card)."""

    batch: Any
    event: Any = None
    device: Any = None


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, BucketedBatch):
        return BucketedBatch(_map(tree.block, fn), tree.true_rows)
    if type(tree) in (list, tuple):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _copy_stream(dev: torch.device):
    stream = _COPY_STREAMS.get(dev)
    if stream is None:
        stream = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


def _as_tensor(leaf):
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf


def device_placer(batch, device=None):
    """Stage ``batch`` (a tensor, a numpy array, or a nest of dicts,
    lists and tuples of them) on ``device``, by default the port's
    default device, the card.  Host leaves go to a card from pinned
    memory, asynchronously on the copy stream; leaves already on the
    device stay; other leaves (Python numbers) pass through.  Returns a
    :class:`Staged` batch, which :func:`ready` hands to the fold."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        def move(leaf):
            leaf = _as_tensor(leaf)
            return leaf.to(dev) if isinstance(leaf, torch.Tensor) else leaf

        return Staged(_map(batch, move))
    stream = _copy_stream(dev)

    def copy(leaf):
        leaf = _as_tensor(leaf)
        if not isinstance(leaf, torch.Tensor) or leaf.device == dev:
            return leaf
        if leaf.device.type == "cpu" and not leaf.is_pinned():
            leaf = leaf.pin_memory()
        return leaf.to(dev, non_blocking=True)

    with torch.cuda.stream(stream):
        staged = _map(batch, copy)
        event = torch.cuda.Event()
        event.record(stream)
    return Staged(staged, event, dev)


def pinned_placer(device):
    """A :func:`device_placer` bound to one destination device; its
    ``device`` attribute tells the streaming drivers where to keep their
    accumulators."""

    def placer(batch):
        return device_placer(batch, device)

    placer.device = torch.device(device)
    return placer


def ready(item):
    """The batch of a staged item, safe to use on the current stream: the
    stream waits for its copies, and each copied tensor is marked as used
    there (so its memory is not reused while the fold still reads it).
    Anything else passes through."""
    if not isinstance(item, Staged):
        return item
    if item.event is not None:
        stream = torch.cuda.current_stream(item.device)
        stream.wait_event(item.event)

        def mark(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(stream)
            return leaf

        _map(item.batch, mark)
    return item.batch


class BucketedBatch(NamedTuple):
    """A staged 2-D batch with its row count beside it (the drivers
    unwrap it for their row accounting)."""

    block: Any
    true_rows: int


def bucketed_placer(gates: tuple = (), device=None):
    """The JAX package's bucketing placer, without the bucketing: a 2-D
    dense batch is staged as a :class:`BucketedBatch` of its own rows,
    never padded.  Row buckets exist in the JAX package so that XLA
    compiles one program per bucket instead of one per batch size; the
    port compiles nothing per shape, so padding would only add rows.
    ``gates`` is accepted for the JAX signature and unused; other
    batches stage as :func:`device_placer` stages them."""

    def placer(batch):
        t = _as_tensor(batch)
        if isinstance(t, torch.Tensor) and t.ndim == 2 and t.layout == torch.strided:
            staged = device_placer(t, device)
            return staged._replace(batch=BucketedBatch(staged.batch, int(t.shape[0])))
        return device_placer(batch, device)

    placer.device = resolve_device(device)
    return placer


@dataclass
class PrefetchStats:
    """Pipeline counters: ``hits``/``waits`` partition the consumer's
    gets by whether a staged batch was ready; ``producer_seconds`` is the
    staging time (placer and its copies), ``wait_seconds`` what the
    consumer's stalls cost."""

    produced: int = 0
    consumed: int = 0
    hits: int = 0
    waits: int = 0
    producer_seconds: float = 0.0
    wait_seconds: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def hidden(self) -> float | None:
        """Fraction of the staging seconds hidden under the consumer's
        work (None before any staging)."""
        if self.producer_seconds <= 0.0:
            return None
        return max(0.0, 1.0 - self.wait_seconds / self.producer_seconds)


class _Done:
    """Queue sentinel; carries the producer's exception if it died."""

    def __init__(self, error=None):
        self.error = error


class Prefetcher:
    """Iterator wrapper that stages up to ``depth`` batches ahead of the
    consumer.  ``placer`` maps a raw batch to its staged form (default
    :func:`device_placer`; None stages raw batches, a pure IO prefetch).
    Exhaust it or call :meth:`close` (it is a context manager too) so
    that the producer thread ends."""

    def __init__(self, source, depth: int = 2, placer=device_placer):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._placer = placer
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.stats = PrefetchStats()
        self._finished = False
        self._thread = threading.Thread(target=self._produce, name="skylark-prefetch",
                                        daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                staged = batch if self._placer is None else self._placer(batch)
                if isinstance(staged, Staged) and staged.event is not None:
                    staged.event.synchronize()  # the copy counts as staging time
                with self.stats._lock:
                    self.stats.produced += 1
                    self.stats.producer_seconds += time.perf_counter() - t0
                # put() blocks while `depth` batches are staged: backpressure.
                while not self._stop.is_set():
                    try:
                        self._queue.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._queue.put(_Done())
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            while not self._stop.is_set():
                try:
                    self._queue.put(_Done(e), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        waited = 0.0
        try:
            item = self._queue.get_nowait()
            hit = True
        except queue.Empty:
            t0 = time.perf_counter()
            item = self._queue.get()
            waited = time.perf_counter() - t0
            hit = False
        with self.stats._lock:
            if hit:
                self.stats.hits += 1
            else:
                self.stats.waits += 1
                self.stats.wait_seconds += waited
        if isinstance(item, _Done):
            self._finished = True
            if item.error is not None:
                raise item.error
            raise StopIteration
        with self.stats._lock:
            self.stats.consumed += 1
        return ready(item)

    def close(self):
        """Stop the producer and drop staged batches (idempotent)."""
        self._stop.set()
        self._finished = True
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
