"""A bounded in-memory ring of periodic metric-snapshot deltas (port of
``libskylark_tpu/telemetry/timeline.py``).

``skylark-top`` (and anything else scraping ``GET /timeline``) wants
"what did the last ten minutes look like", which point-in-time counters
cannot answer.  The timeline rolls the registry forward in fixed
windows: every ``SKYLARK_TIMELINE_INTERVAL_S`` seconds (default 5) a
tick snapshots the registry, records the *delta* of every counter and
histogram (count/sum) against the previous tick plus the current gauge
values, and appends one window record to a ring bounded by
``SKYLARK_TIMELINE_CAPACITY`` (default 120 windows — ten minutes at the
default interval).

Ticks are lazy — there is no thread.  Hot paths (the serve worker loop)
and the ``/timeline`` endpoint call :func:`timeline_tick`; whichever
arrives first past the interval boundary closes the window.  Each
record derives the headline sparkline series: ``qps`` (request delta
over the window), ``p99_ms`` (estimated from ``serve.latency_ms``
bucket deltas when that histogram has buckets enabled — the serve
plane enables them at construction), ``cache_hit_rate``, and whatever
point-in-time extras the caller passes (queue depth).

Rides ``SKYLARK_TELEMETRY``: disabled, :func:`timeline_tick` returns
before taking a timestamp or allocating.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import config
from .registry import REGISTRY, inc

__all__ = ["Timeline", "TIMELINE", "timeline_tick", "timeline_windows",
           "timeline_state", "reset_timeline", "bucket_quantile"]

_DEF_INTERVAL_S = 5.0
_DEF_CAPACITY = 120


def _interval_s() -> float:
    try:
        v = float(os.environ.get("SKYLARK_TIMELINE_INTERVAL_S",
                                 _DEF_INTERVAL_S))
    except ValueError:
        v = _DEF_INTERVAL_S
    return max(0.05, v)


def _capacity() -> int:
    try:
        n = int(os.environ.get("SKYLARK_TIMELINE_CAPACITY", _DEF_CAPACITY))
    except ValueError:
        n = _DEF_CAPACITY
    return max(1, n)


def bucket_quantile(le, counts, q: float):
    """Upper-bound estimate of quantile ``q`` from (non-cumulative)
    bucket counts; returns the containing bucket's ``le`` (the last
    finite bound for the +Inf overflow bucket), or None when empty."""
    total = sum(counts)
    if total <= 0 or not le:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            return float(le[i]) if i < len(le) else float(le[-1])
    return float(le[-1])


class Timeline:
    """The ring itself; one module-level instance serves the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=_capacity())
        self._last_mono: float | None = None
        self._last_counters: dict = {}
        self._last_hist: dict = {}    # name -> (count, sum, bucket_counts)

    def maybe_tick(self, extra: dict | None = None,
                   force: bool = False) -> bool:
        """Close the current window if the interval has elapsed.

        Returns True when a window record was appended.  ``extra`` is a
        dict of point-in-time values (e.g. queue depth) merged into the
        record's ``derived`` map.  ``force`` closes the window
        regardless of the interval (test hook).
        """
        if not config.enabled():
            return False
        now = time.monotonic()
        with self._lock:
            cap = _capacity()
            if self._ring.maxlen != cap:
                self._ring = deque(self._ring, maxlen=cap)
            if self._last_mono is None:
                # First tick just baselines; no window to close yet.
                self._baseline_locked(now)
                return False
            dt = now - self._last_mono
            if not force and dt < _interval_s():
                return False
            snap = REGISTRY.snapshot()
            record = self._delta_locked(snap, dt, extra)
            self._ring.append(record)
            self._baseline_locked(now, snap)
        inc("timeline.ticks")
        return True

    def _baseline_locked(self, now: float, snap: dict | None = None) -> None:
        if snap is None:
            snap = REGISTRY.snapshot()
        self._last_mono = now
        self._last_counters = snap["counters"]
        self._last_hist = {
            k: (v["count"], v["sum"],
                tuple(v["buckets"]["counts"]) if "buckets" in v else None)
            for k, v in snap["histograms"].items()
        }

    def _delta_locked(self, snap: dict, dt: float,
                      extra: dict | None) -> dict:
        counters = {}
        for k, v in snap["counters"].items():
            d = v - self._last_counters.get(k, 0)
            if d:
                counters[k] = d
        hists = {}
        lat_buckets = None
        for k, v in snap["histograms"].items():
            prev = self._last_hist.get(k, (0, 0.0, None))
            dc = v["count"] - prev[0]
            if not dc:
                continue
            hists[k] = {"count": dc, "sum": round(v["sum"] - prev[1], 6)}
            if "buckets" in v:
                prev_counts = prev[2] or (0,) * len(v["buckets"]["counts"])
                if len(prev_counts) == len(v["buckets"]["counts"]):
                    dcounts = [a - b for a, b in
                               zip(v["buckets"]["counts"], prev_counts)]
                    if k == "serve.latency_ms":
                        lat_buckets = (v["buckets"]["le"], dcounts)
        derived = {
            "qps": round(counters.get("serve.requests", 0) / dt, 3),
            "cache_hit_rate": self._hit_rate(counters),
        }
        if lat_buckets is not None:
            p99 = bucket_quantile(lat_buckets[0], lat_buckets[1], 0.99)
            if p99 is not None:
                derived["p99_ms"] = p99
        if extra:
            for k, v in extra.items():
                derived[k] = v
        return {
            "ts": time.time(),
            "dt_s": round(dt, 3),
            "counters": counters,
            "gauges": dict(snap["gauges"]),
            "histograms": hists,
            "derived": derived,
        }

    @staticmethod
    def _hit_rate(counters: dict):
        hits = counters.get("serve.cache.hit", 0)
        lookups = hits + counters.get("serve.cache.miss", 0)
        return round(hits / lookups, 4) if lookups else None

    def windows(self) -> list:
        with self._lock:
            return list(self._ring)

    def state(self) -> dict:
        """The ``/timeline`` response body."""
        return {
            "interval_s": _interval_s(),
            "capacity": _capacity(),
            "windows": self.windows(),
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_mono = None
            self._last_counters = {}
            self._last_hist = {}


TIMELINE = Timeline()


def timeline_tick(extra: dict | None = None, force: bool = False) -> bool:
    """Module-level shorthand for ``TIMELINE.maybe_tick``."""
    return TIMELINE.maybe_tick(extra=extra, force=force)


def timeline_windows() -> list:
    return TIMELINE.windows()


def timeline_state() -> dict:
    return TIMELINE.state()


def reset_timeline() -> None:
    """Test hook: clear the ring and baselines."""
    TIMELINE.reset()
