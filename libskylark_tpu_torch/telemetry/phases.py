"""The per-request phase clock: canonical phase names + observation
helpers (port of ``libskylark_tpu/telemetry/phases.py``).

A slow serve request spends its life in a fixed chain of phases; the
serve plane stamps the monotonic duration of each into the request's
trace envelope (``trace["phases"]``) and into bucketed histograms named
``phase.<name>_ms`` so fleet-wide phase quantiles are queryable from
``/metrics`` as real Prometheus ``_bucket{le=...}`` series.

The clock rides THREE gates: ``SKYLARK_TELEMETRY`` (the whole layer),
``SKYLARK_TRACE`` (phases are only assembled for traced requests), and
``SKYLARK_PHASES`` (default on; lets the bench A/B the clock itself
while tracing stays hot).  With any gate off, no phase dict is
allocated and no timestamp is taken beyond what tracing already does.
"""

from __future__ import annotations

import os

from . import config
from .registry import enable_buckets, observe

__all__ = ["PHASES", "phases_enabled", "observe_phase", "enable_phase_buckets"]

# Canonical phase names, in request-lifetime order.  ``collective_wait``
# is the odd one out: it is recorded per-rank at cross-host collective
# sites (straggler attribution), not per-request.
PHASES = (
    "admit_wait",
    "coalesce_linger",
    "dispatch_queue",
    "plan_compile",
    "device_execute",
    "depad_serialize",
    "collective_wait",
)

_OFF = ("0", "false", "False", "FALSE", "off", "no")

_REGISTERED: set = set()


def phases_enabled() -> bool:
    """True unless ``SKYLARK_PHASES`` is set falsy (and telemetry is on)."""
    if not config.enabled():
        return False
    return os.environ.get("SKYLARK_PHASES") not in _OFF


def enable_phase_buckets() -> None:
    """Register log-spaced buckets for every phase histogram (idempotent)."""
    for p in PHASES:
        name = "phase." + p + "_ms"
        if name not in _REGISTERED:
            enable_buckets(name)
            _REGISTERED.add(name)


def observe_phase(name: str, ms: float) -> None:
    """Record one phase duration (ms) into its bucketed histogram."""
    metric = "phase." + name + "_ms"
    if metric not in _REGISTERED:
        enable_buckets(metric)
        _REGISTERED.add(metric)
    observe(metric, ms)
