"""Nestable spans: host time + profiler annotations + ledger events (port
of ``libskylark_tpu/telemetry/spans.py``).

A span never waits for the card and records no CUDA event, so it is
legal anywhere, inside a CUDA graph capture too.  ``span(name)`` works
in three states:

- **off** (telemetry off, no profiler recording): the shared
  :data:`NOOP_SPAN`, after one ``config.enabled()`` lookup and torch's
  own profiler-enabled flag; nothing is allocated;
- **profiler recording** (``utils.profiling.trace``, or any
  ``torch.profiler`` profile): a ``utils.profiling.annotate`` region, a
  ``user_annotation`` in the same Chrome trace as the card's kernels and
  on the same clock; no ledger event, no registry lock;
- **telemetry on**: a :class:`Span`, the annotation plus ``span_start``
  / ``span_end`` ledger events and the ``span.<name>.calls`` /
  ``.seconds`` counters.  ``seconds`` is host time; ``start_ns`` /
  ``end_ns`` are read from ``time.time_ns()``, the Unix clock the
  profiler's exported timestamps are on (``ts`` in µs, plus the trace's
  ``baseTimeNanoseconds`` where it has one).

Nesting is tracked per thread: every span records its parent's id (the
``seq`` of the parent's ``span_start`` event) and ``root``, the id of
the outermost span open on the thread, so every span of one solve
shares one identifier (a nested span carries it on both events, the
outermost on its ``span_end``).  A caller that wants device time waits
for the card itself, at its own call site (the streaming engine does,
under the telemetry gate).

:data:`SPANS` is the catalog of every name the port opens, as
``<layer>.<what>``:

- ``ls.solve``: ``approximate_least_squares``, entry to return; the
  root of a solve's spans;
- ``policy.consult``: the least-squares entry's routing decision;
- ``sketch.apply``: ``plans.apply``, planned or bypassed, and the
  sketch of Blendenpik and LSRN;
- ``random.sample``: the counter stream's public draws (``sample``,
  ``sample_window``), eager or while a plan is captured;
- ``plans.capture``: a plan's warm-up, CUDA graph capture and
  instantiation on the card;
- ``plans.replay``: a planned call's copy-in, replay and clone-out;
- ``guard.certify``: ``guard.certify_sketch``, and Blendenpik's
  condition estimate of R with its verdict;
- ``dense.solve``: sketch-and-solve's exact solve of the sketched
  problem;
- ``dense.qr``: Blendenpik's QR of S·A;
- ``lsqr.run``: ``solvers.krylov.lsqr``, set-up to return;
- ``<kind>.capture``, ``<kind>.chunk``: a chunked solver's step
  captured as a CUDA graph (``resilient.chunked.StepGraph``), and each
  chunk of steps with its convergence read; ``kind`` is ``cond_est``
  (the guard's certificate) or ``lsqr`` (the other Krylov solvers open
  none);
- ``stream.chunk``: one chunk of a streaming pass (with telemetry on
  the engine waits for its accumulator, so its ``seconds`` are device
  time);
- ``train.stream``, ``train.factor``, ``train.iterate``: the phases of
  the distributed kernel-machine trainer.
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _torch_profiler

from ..utils import profiling
from . import config
from .ledger import event
from .registry import REGISTRY

__all__ = ["span", "Span", "NOOP_SPAN", "SPANS"]

#: The chunked solvers that open ``<kind>.capture`` / ``<kind>.chunk``.
CHUNKED_KINDS = ("cond_est", "lsqr")

SPANS = ("ls.solve", "policy.consult", "sketch.apply", "random.sample", "plans.capture",
         "plans.replay", "guard.certify", "dense.solve", "dense.qr", "lsqr.run") + tuple(
    f"{kind}.{what}" for kind in CHUNKED_KINDS for what in ("capture", "chunk")) + (
    "stream.chunk", "train.stream", "train.factor", "train.iterate")

_LOCAL = threading.local()


class _NoopSpan:
    """Shared off-path span: nests freely, holds nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def _stack() -> list:
    stack = getattr(_LOCAL, "spans", None)
    if stack is None:
        stack = _LOCAL.spans = []
    return stack


class Span:
    """One live span with telemetry on; ``attrs`` may be amended inside
    the region (the ``span_end`` event re-reads them, so late facts —
    rows folded, batches seen — land on the closing record)."""

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = None
        self.root = None
        self.seconds = None

    def __enter__(self):
        stack = _stack()
        start_attrs = dict(self.attrs)
        if stack:
            start_attrs["parent"] = stack[-1].id
            start_attrs["root"] = stack[0].id
        start_attrs["depth"] = len(stack)
        self._region = profiling.annotate(self.name)
        self._region.__enter__()
        self._t0 = time.perf_counter()
        self._start_ns = start_attrs["start_ns"] = time.time_ns()
        self.id = event("span_start", self.name, start_attrs)
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.time_ns()
        self.seconds = time.perf_counter() - self._t0
        self._region.__exit__(exc_type, exc, tb)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        REGISTRY.inc(f"span.{self.name}.calls")
        REGISTRY.inc(f"span.{self.name}.seconds", self.seconds)
        end_attrs = dict(self.attrs)
        end_attrs["span"] = self.id
        end_attrs["root"] = self.root
        end_attrs["seconds"] = round(self.seconds, 6)
        end_attrs["start_ns"] = self._start_ns
        end_attrs["end_ns"] = end_ns
        if exc_type is not None:
            end_attrs["error"] = exc_type.__name__
        event("span_end", self.name, end_attrs)
        return False


def span(name: str, **attrs):
    """Open a nestable span (context manager); ``name`` is one of
    :data:`SPANS`.

    Usage::

        with telemetry.span("stream.chunk", chunk=b0) as sp:
            acc = fold(acc, block)
            sp.attrs["rows"] = k   # telemetry on only: lands on span_end

    Off, returns the shared :data:`NOOP_SPAN`; with only a profiler
    recording, a ``utils.profiling.annotate`` region (``attrs`` are
    dropped).  Hot call sites pass no ``attrs``.
    """
    if config.enabled():
        return Span(name, attrs)
    if _torch_profiler._is_profiler_enabled:
        return profiling.annotate(name)
    return NOOP_SPAN
