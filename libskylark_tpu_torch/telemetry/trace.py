"""Request-scoped tracing and the bounded flight recorder (port of
``libskylark_tpu/telemetry/trace.py``).

A :class:`TraceContext` is minted at serve admission (one per admitted
request) and rides the request end-to-end: coalesce → padded dispatch →
solo-retry → fan-out.  Its event list IS the response's
``trace["events"]`` — the same list object — so everything attached
mid-flight (the batch-dispatch span that links k coalesced requests,
guard-ladder rungs, plan-cache hits/compiles, policy route decisions)
is visible both in the answer the caller receives and in the flight
recorder afterwards.  One batch dispatch mints ONE span id shared by
every request it carried; a solo retry mints a fresh one, so the two
rungs are distinguishable after the fact.

Cross-layer attachment goes through a per-thread *active set*:
:func:`activate` marks the traces the current dispatch serves, and
:func:`trace_event` appends to every active trace.  The seams that
already emit telemetry (``plans/cache.py``, ``guard/ladder.py``,
``policy/record.py``) call :func:`trace_event` next to their ledger
event — with no active trace the call returns before allocating, so
non-serve code paths pay one thread-local read.

The :class:`FlightRecorder` keeps the last ``SKYLARK_TRACE_CAPACITY``
completed traces in a ring PLUS every SLO-violating one (deadline shed,
admission shed, solo-retry, guard escalation, structured errors) in a
larger bounded ring of its own — a quiet server remembers its recent
history, a misbehaving one remembers every incident.  ``drain()`` is
the API pull; error traces are additionally dumped to the run ledger
(kind ``"trace"``) the moment they finish, so a post-mortem needs no
live process.

Everything here rides the ``SKYLARK_TELEMETRY`` gate: disabled,
:func:`mint` returns ``None``, the recorder never sees a record, and no
trace object is allocated anywhere — pinned by
``tests/test_torch_trace.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

from . import config
from .ledger import event, flush
from .registry import LOCK, REGISTRY

__all__ = [
    "TraceContext",
    "FlightRecorder",
    "RECORDER",
    "mint",
    "next_id",
    "trace_enabled",
    "activate",
    "trace_event",
    "error_event",
    "finish",
    "is_violating",
    "get_trace",
    "drain_traces",
    "trace_ids",
    "dump_traces",
]

# Events per trace are bounded so one pathological request (a guard
# ladder that climbs forever, a retry loop) cannot grow its trace
# without bound; the drop is counted on the trace itself.
_MAX_EVENTS = 64

_LOCAL = threading.local()
_SEQ = {"n": 0}

# Statuses that mark a trace SLO-violating: the flight recorder keeps
# ALL of these (not just the last N), because they are exactly the
# answers someone will ask "why?" about after the fact.
VIOLATIONS = ("error", "shed_admission", "shed_deadline")


def _capacity() -> int:
    try:
        return max(8, int(os.environ.get("SKYLARK_TRACE_CAPACITY", "256")))
    except ValueError:
        return 256


def trace_enabled() -> bool:
    """Tracing rides the telemetry gate plus its own ``SKYLARK_TRACE``
    sub-gate (default ON): ``SKYLARK_TRACE=0`` keeps counters/spans/
    ledger but mints no traces — the bench's isolation knob for the
    <5%-QPS tracing-overhead row, and an operator's escape hatch."""
    return config.enabled() and os.environ.get("SKYLARK_TRACE", "1") != "0"


def next_id() -> int:
    """Monotonic id for traces and dispatch spans (shared stream, under
    the registry lock so ids are unique across worker threads)."""
    with LOCK:
        _SEQ["n"] += 1
        return _SEQ["n"]


class TraceContext:
    """One request's trace.  ``events`` aliases the serve entry's
    ``trace["events"]`` list when attached there, so appends land in the
    response envelope and the recorder simultaneously."""

    __slots__ = (
        "trace_id", "op", "key", "request_id", "deadline_ms",
        "t_start", "t_end", "events", "status", "code", "dropped",
        "violation",
    )

    def __init__(self, op, *, key=None, request_id=None, deadline_ms=None,
                 events=None, seq=None):
        pid = os.getpid()
        if seq is None:
            seq = next_id()
        self.trace_id = f"{pid:x}-{seq:08x}"
        self.op = op
        self.key = key
        self.request_id = request_id
        self.deadline_ms = deadline_ms
        self.t_start = time.time()
        self.t_end = None
        self.events = events if events is not None else []
        self.status = None
        self.code = None
        self.dropped = 0
        self.violation = False

    def event(self, kind: str, **attrs) -> None:
        if len(self.events) >= _MAX_EVENTS:
            self.dropped += 1
            return
        self.events.append({"kind": kind, **attrs})

    def to_dict(self) -> dict:
        end = self.t_end if self.t_end is not None else time.time()
        d = {
            "trace_id": self.trace_id,
            "op": self.op,
            "status": self.status,
            "ts": round(self.t_start, 6),
            "ms": round((end - self.t_start) * 1e3, 4),
            "events": list(self.events),
        }
        if self.violation and self.status not in VIOLATIONS:
            d["violation"] = True
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.key is not None:
            d["key"] = str(self.key)
        if self.deadline_ms is not None:
            d["deadline_ms"] = self.deadline_ms
        if self.code is not None:
            d["code"] = self.code
        if self.dropped:
            d["events_dropped"] = self.dropped
        return d


def mint(op, *, key=None, request_id=None, deadline_ms=None,
         events=None) -> TraceContext | None:
    """A new trace — or ``None`` (no allocation) with telemetry off."""
    if not trace_enabled():
        return None
    # One lock acquisition for both the id draw and the minted counter:
    # mint sits on the serve admission hot path, where 16 client threads
    # contend with the worker's own counters on the registry LOCK.
    with LOCK:
        _SEQ["n"] += 1
        seq = _SEQ["n"]
        c = REGISTRY.counters
        c["trace.minted"] = c.get("trace.minted", 0) + 1
    return TraceContext(
        op, key=key, request_id=request_id, deadline_ms=deadline_ms,
        events=events, seq=seq,
    )


# -- the per-thread active set ---------------------------------------------


def _active() -> list:
    traces = getattr(_LOCAL, "traces", None)
    if traces is None:
        traces = _LOCAL.traces = []
    return traces


@contextmanager
def activate(traces):
    """Mark ``traces`` (TraceContexts; Nones filtered) as the recipients
    of :func:`trace_event` on this thread for the duration."""
    live = [t for t in traces if t is not None]
    stack = _active()
    stack.append(live)
    try:
        yield live
    finally:
        stack.pop()


def trace_event(kind: str, **attrs) -> None:
    """Append an event to every active trace on this thread.

    The no-trace path is one thread-local read and a truthiness check —
    cheap enough for the plan-cache/guard/policy seams to call
    unconditionally next to their ledger events.
    """
    stack = getattr(_LOCAL, "traces", None)
    if not stack or not stack[-1]:
        return
    for t in stack[-1]:
        t.event(kind, **attrs)


def error_event(name: str, exc: BaseException, **attrs) -> None:
    """The one way an error becomes a telemetry event: kind ``"error"``
    with a MANDATORY ``code`` attr (the 100–114 ladder; foreign
    exceptions degrade to 100), so every code stays traceable.
    Lands on the ledger, the ``error.code.<n>`` counter, and every
    active trace."""
    if not config.enabled():
        return
    code = int(getattr(exc, "code", 100))
    payload = {"code": code, "type": type(exc).__name__, **attrs}
    REGISTRY.inc(f"error.code.{code}")
    trace_event("error", **payload)
    event("error", name, dict(payload, message=str(exc)))


# -- the flight recorder ----------------------------------------------------


class FlightRecorder:
    """Bounded ring of completed traces + a larger ring of violations.

    ``capacity`` bounds the recent ring (``SKYLARK_TRACE_CAPACITY``,
    default 256); violations keep 8× that.  "All SLO-violating traces"
    is therefore bounded too — a server being DoS'd with poison still
    has finite memory — but the violation window is wide enough that
    every incident of a normal run survives until drained.
    """

    def __init__(self, capacity: int | None = None):
        cap = capacity if capacity is not None else _capacity()
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=cap)
        self._violations: deque = deque(maxlen=8 * cap)

    def record(self, trace, violating=None) -> None:
        """Retain a finished trace — a :class:`TraceContext` (converted
        to its dict form lazily, at read time, to keep the serve hot
        path cheap) or an already-built payload dict."""
        if violating is None:
            if isinstance(trace, dict):
                violating = trace.get("status") in VIOLATIONS or trace.get(
                    "violation"
                )
            else:
                violating = trace.status in VIOLATIONS or trace.violation
        with self._lock:
            self._recent.append(trace)
            if violating:
                self._violations.append(trace)

    @staticmethod
    def _tid(p):
        return p.get("trace_id") if isinstance(p, dict) else p.trace_id

    @staticmethod
    def _payload(p) -> dict:
        return p if isinstance(p, dict) else p.to_dict()

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            for ring in (self._recent, self._violations):
                for p in reversed(ring):
                    if self._tid(p) == trace_id:
                        return self._payload(p)
        return None

    def ids(self) -> dict:
        with self._lock:
            return {
                "recent": [self._tid(p) for p in self._recent],
                "violations": [self._tid(p) for p in self._violations],
            }

    def drain(self) -> dict:
        """Remove and return everything recorded so far."""
        with self._lock:
            recent = list(self._recent)
            violations = list(self._violations)
            self._recent.clear()
            self._violations.clear()
        return {
            "recent": [self._payload(p) for p in recent],
            "violations": [self._payload(p) for p in violations],
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._recent)

    def dump(self, path) -> int:
        """Write every retained trace as JSONL; returns the line count."""
        with self._lock:
            rows = list(self._recent)
            seen = {id(p) for p in rows}
            rows += [p for p in self._violations if id(p) not in seen]
        with open(path, "w", encoding="utf-8") as fh:
            for p in rows:
                fh.write(json.dumps(self._payload(p), default=str) + "\n")
        return len(rows)


RECORDER = FlightRecorder()


def finish(tctx: TraceContext | None, status: str, *, code=None,
           violation: bool = False) -> None:
    """Close a trace into the flight recorder.  Violating traces (shed,
    error, or ``violation=True`` for solo-retry / guard-escalation runs
    that still answered OK) are retained in the violation ring and
    dumped to the run ledger immediately."""
    if tctx is None:
        return
    tctx.status = status
    tctx.t_end = time.time()
    if code is not None:
        tctx.code = int(code)
    violating = status in VIOLATIONS or violation
    tctx.violation = bool(violation)
    RECORDER.record(tctx, violating=violating)
    # One lock acquisition for both counters (hot path; see mint).
    with LOCK:
        c = REGISTRY.counters
        c["trace.finished"] = c.get("trace.finished", 0) + 1
        if violating:
            c["trace.violations"] = c.get("trace.violations", 0) + 1
    if violating:
        # dump-on-error: the ledger keeps the full trace even if the
        # process dies before anyone drains the recorder — flushed
        # through, since a buffered incident record is no evidence
        event("trace", tctx.op, tctx.to_dict())
        flush()


def is_violating(events) -> bool:
    """Did this event list record an SLO violation — a solo-retry or
    batch fallback, a structured error, or a guard-ladder escalation
    past the first rung?  Such traces are retained in the recorder's
    violation ring even after ``capacity`` newer traces arrive."""
    for ev in events:
        k = ev.get("kind")
        if k in ("fallback", "solo_retry", "error"):
            return True
        if k == "guard" and ev.get("rung", 0):
            return True
    return False


def get_trace(trace_id: str) -> dict | None:
    return RECORDER.get(trace_id)


def trace_ids() -> dict:
    return RECORDER.ids()


def drain_traces() -> dict:
    return RECORDER.drain()


def dump_traces(path) -> int:
    return RECORDER.dump(path)
