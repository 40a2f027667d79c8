"""Nestable spans: wall time + device regions + ledger events (port of
``libskylark_tpu/telemetry/spans.py``).

A span is the telemetry analogue of one ``PhaseTimer`` phase, and keeps
its sync discipline: assign the span handle's ``result`` inside the
region and the exit path waits for every card that holds a tensor of it
(the current stream of each) before reading the clock, so the span
measures DEVICE time, not the time to queue the work.  That wait cannot
happen inside a CUDA graph capture: a span whose exit would wait while
the current stream is capturing raises instead, so a span placed inside
a captured body shows up at its first capture rather than timing
nothing.  Each span also opens a ``utils.profiling.annotate`` region,
so a ``torch.profiler`` trace taken around the run carries the same
names as the ledger.

Nesting is tracked per thread: every span records its parent's id (the
``seq`` of the parent's ``span_start`` event) so the ledger reconstructs
the span tree.  ``span(...)`` with telemetry disabled returns a shared
no-op singleton — no allocation, no sync, no events.
"""

from __future__ import annotations

import threading
import time

import torch

from ..utils import profiling
from ..utils.timer import _cuda_devices
from . import config
from .ledger import event
from .registry import REGISTRY

__all__ = ["span", "Span", "NOOP_SPAN"]

_LOCAL = threading.local()


class _NoopSpan:
    """Shared disabled-path span: accepts ``result`` assignment (ignored,
    never synced) and nests freely."""

    __slots__ = ("result",)

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


def _wait(name: str, result) -> None:
    """Wait for the current stream of every card that holds a tensor of
    ``result``; raise inside a capture, where a wait is illegal."""
    devices = _cuda_devices(result, set())
    if devices and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"telemetry span {name!r} would wait for the card inside a CUDA "
            "graph capture: open spans outside captured bodies")
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """One live span; ``attrs`` may be amended inside the region (the
    ``span_end`` event re-reads them, so late facts — rows folded,
    batches seen — land on the closing record)."""

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.result = None
        self.id = None
        self.seconds = None

    def __enter__(self):
        stack = _stack()
        start_attrs = dict(self.attrs)
        if stack:
            start_attrs["parent"] = stack[-1].id
        start_attrs["depth"] = len(stack)
        self._t0 = time.perf_counter()
        self.id = event("span_start", self.name, start_attrs)
        stack.append(self)
        self._region = profiling.annotate(self.name)
        self._region.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._region.__exit__(exc_type, exc, tb)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.result is not None:
            _wait(self.name, self.result)
        self.seconds = time.perf_counter() - self._t0
        REGISTRY.inc(f"span.{self.name}.calls")
        REGISTRY.inc(f"span.{self.name}.seconds", self.seconds)
        end_attrs = dict(self.attrs)
        end_attrs["span"] = self.id
        end_attrs["seconds"] = round(self.seconds, 6)
        if exc_type is not None:
            end_attrs["error"] = exc_type.__name__
        event("span_end", self.name, end_attrs)
        return False


def span(name: str, **attrs):
    """Open a nestable span (context manager).

    Usage::

        with telemetry.span("stream.chunk", chunk=b0) as sp:
            sp.result = acc        # waited for at exit (PhaseTimer rule)
            sp.attrs["rows"] = k   # lands on the span_end event

    Disabled (``SKYLARK_TELEMETRY=0``): returns the shared no-op span.
    """
    if not config.enabled():
        return NOOP_SPAN
    return Span(name, attrs)
