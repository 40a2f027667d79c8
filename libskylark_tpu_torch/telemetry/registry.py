"""The process-wide metrics registry: counters, gauges, histograms (port
of ``libskylark_tpu/telemetry/registry.py``).

ONE lock (module-level ``LOCK``, shared with the ledger's sequence
counter) guards every mutation — the same single-lock discipline as
``plans.PlanCache`` — and the module-level helpers (:func:`inc`,
:func:`set_gauge`, :func:`observe`) check ``config.enabled()`` FIRST,
so with ``SKYLARK_TELEMETRY=0`` a call returns before any allocation
happens.

Histograms keep streaming moments (count / sum / min / max) by
default: enough for min/max/avg reporting without per-event lists.
Individual histograms can opt into log-spaced cumulative buckets via
:func:`enable_buckets` — bucket bounds are registry *configuration*
(they survive :func:`reset`), while bucket counts are data.  Buckets
stay off per histogram unless registered, so non-serve callers pay
nothing beyond one dict lookup per observe.
"""

from __future__ import annotations

import bisect
import threading

from . import config

__all__ = [
    "LOCK",
    "Registry",
    "REGISTRY",
    "DEFAULT_BUCKETS_MS",
    "inc",
    "set_gauge",
    "observe",
    "enable_buckets",
    "reset",
]

LOCK = threading.Lock()

# Log-spaced latency ladder in milliseconds (an implicit +Inf bucket is
# always appended at exposition time).
DEFAULT_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


class Registry:
    """Named counters / gauges / histograms behind the shared lock."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}
        # name -> sorted tuple of upper bounds (configuration, survives reset)
        self._bucket_bounds: dict = {}

    def inc(self, name: str, amount=1) -> None:
        with LOCK:
            self.counters[name] = self.counters.get(name, 0) + amount

    def set_gauge(self, name: str, value) -> None:
        with LOCK:
            self.gauges[name] = value

    def enable_buckets(self, name: str, bounds=None) -> None:
        """Opt histogram ``name`` into cumulative buckets.

        ``bounds`` are finite upper bounds (``le`` values); +Inf is implied.
        Idempotent; re-registering with different bounds restarts the
        bucket counts (moments are untouched).
        """
        bs = tuple(sorted(float(b) for b in (bounds or DEFAULT_BUCKETS_MS)))
        with LOCK:
            if self._bucket_bounds.get(name) == bs:
                return
            self._bucket_bounds[name] = bs
            h = self.histograms.get(name)
            if h is not None:
                h["bucket_counts"] = [0] * (len(bs) + 1)
                h["bucket_count"] = 0
                h["bucket_sum"] = 0.0

    def observe(self, name: str, value) -> None:
        v = float(value)
        with LOCK:
            h = self.histograms.get(name)
            if h is None:
                h = {"count": 1, "sum": v, "min": v, "max": v}
                self.histograms[name] = h
            else:
                h["count"] += 1
                h["sum"] += v
                h["min"] = min(h["min"], v)
                h["max"] = max(h["max"], v)
            bounds = self._bucket_bounds.get(name)
            if bounds is not None:
                counts = h.get("bucket_counts")
                if counts is None:
                    counts = [0] * (len(bounds) + 1)
                    h["bucket_counts"] = counts
                    h["bucket_count"] = 0
                    h["bucket_sum"] = 0.0
                counts[bisect.bisect_left(bounds, v)] += 1
                h["bucket_count"] += 1
                h["bucket_sum"] += v

    def snapshot(self) -> dict:
        """Point-in-time copy of every metric (safe to mutate).

        Bucketed histograms additionally carry a ``buckets`` dict:
        ``{"le": [...finite bounds...], "counts": [per-bucket counts,
        last entry is the +Inf overflow], "count", "sum"}`` where
        ``count``/``sum`` cover only observations made since buckets
        were enabled (so ``+Inf`` cumulative == ``count`` always holds).
        """
        with LOCK:
            hists = {}
            for k, v in self.histograms.items():
                h = {"count": v["count"], "sum": v["sum"],
                     "min": v["min"], "max": v["max"]}
                counts = v.get("bucket_counts")
                if counts is not None:
                    h["buckets"] = {
                        "le": list(self._bucket_bounds.get(k, ())),
                        "counts": list(counts),
                        "count": v.get("bucket_count", 0),
                        "sum": v.get("bucket_sum", 0.0),
                    }
                hists[k] = h
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": hists,
            }

    def reset(self) -> None:
        with LOCK:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


REGISTRY = Registry()


def inc(name: str, amount=1) -> None:
    """Bump counter ``name`` (no-op — and no allocation — when disabled)."""
    if not config.enabled():
        return
    REGISTRY.inc(name, amount)


def set_gauge(name: str, value) -> None:
    """Set gauge ``name`` (no-op when disabled)."""
    if not config.enabled():
        return
    REGISTRY.set_gauge(name, value)


def observe(name: str, value) -> None:
    """Record ``value`` into histogram ``name`` (no-op when disabled)."""
    if not config.enabled():
        return
    REGISTRY.observe(name, value)


def enable_buckets(name: str, bounds=None) -> None:
    """Register bucket bounds for histogram ``name``.

    Registration is configuration, not data: it always runs (even with
    telemetry disabled) so a server constructed before the gate flips
    still gets buckets once observations start flowing.
    """
    REGISTRY.enable_buckets(name, bounds)


def reset() -> None:
    """Zero every metric (test hook; always runs, even disabled)."""
    REGISTRY.reset()
