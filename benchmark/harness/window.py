"""The measured window: one caller, requests back to back (a closed
loop), each timed by the host clock from its call to the card's
synchronize after it."""

from __future__ import annotations

import statistics
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    records: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def count(self) -> int:
        return len(self.records)

    @property
    def failed(self) -> int:
        return sum(1 for r in self.records if "error" in r)

    def latencies(self) -> list[float]:
        return [r["latency_s"] for r in self.records]


def closed_loop(request, sync, seconds: float, tracer=None, clock=time.perf_counter) -> Window:
    """Call ``request(i)`` back to back until ``seconds`` have passed at a
    request boundary; the window ends when the last request does.  A
    request that raises is kept as ``{"error": ...}`` and still timed."""
    win = Window()
    win.start = clock()
    i = 0
    while clock() - win.start < seconds:
        if tracer is not None:
            tracer.before(clock() - win.start)
        t0 = clock()
        try:
            rec = request(i)
        except Exception:  # noqa: BLE001 - a failed request is counted, not fatal
            rec = {"error": traceback.format_exc(limit=4)}
        sync()
        t1 = clock()
        rec["latency_s"] = t1 - t0
        win.records.append(rec)
        i += 1
        if tracer is not None:
            tracer.after()
    win.end = clock()
    if tracer is not None:
        tracer.after(final=True)
    return win


def percentile(values: list[float], pct: int) -> float:
    """The ``pct``-th percentile of all values (inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]
