"""Prometheus text exposition of the telemetry snapshot (port of
``libskylark_tpu/telemetry/exposition.py``, byte-identical output for
equal snapshots).

Renders ``snapshot()`` (or any dict of its shape) as Prometheus
text-format 0.0.4 — the lingua franca every fleet scraper, the serve
``GET /metrics`` endpoint, and ``skylark-top --url`` share.  Naming
rules, stable so dashboards survive refactors:

- every metric is prefixed ``skylark_``; dots and other non-word
  characters in registry names become underscores;
- distinct raw names that sanitize to the SAME metric name (``a-b`` vs
  ``a.b``) are disambiguated: every member of a colliding group gets a
  short crc32 suffix (``skylark_a_b_3f2a91_total``) so no two raw
  series ever alias each other;
- counters are suffixed ``_total`` (``serve.requests`` →
  ``skylark_serve_requests_total``);
- per-tenant series (``serve.tenant.<tenant>.<metric>``) export with a
  proper ``{tenant="..."}`` label on a shared
  ``skylark_serve_tenant_<metric>`` family instead of a tenant-mangled
  metric name;
- histograms expose their streaming moments as four series:
  ``_count``, ``_sum``, ``_min``, ``_max``; histograms with buckets
  enabled (:func:`~.registry.enable_buckets`) export a real
  ``# TYPE ... histogram`` family with cumulative ``_bucket{le=...}``
  series (``+Inf`` included) whose ``_count``/``_sum`` cover the
  bucketed observations so the family is self-consistent;
- ``slo.budget_remaining.<key>`` gauges export as one
  ``skylark_slo_budget_remaining{objective="<key>"}`` family;
- the plan-cache block exports as ``skylark_plans_<counter>`` and the
  derived ratios (``plan_cache_hit_rate``, ``prefetch_overlap``,
  ``overlap_efficiency``, serve ``coalesce_ratio`` and latency
  percentiles) as gauges, skipped when undefined (``None``) rather
  than exported as NaN.

Rendering reads ONE consistent registry snapshot (one lock
acquisition) and never touches the worker thread — the concurrency
contract the serve plane's scrapes rely on.
"""

from __future__ import annotations

import re
import zlib

__all__ = ["prometheus_text", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
_TENANT_RE = re.compile(r"^serve\.tenant\.(.+)\.([a-zA-Z0-9_]+)$")
_SLO_GAUGE_PREFIX = "slo.budget_remaining."


def _name(raw: str) -> str:
    n = _SANITIZE.sub("_", str(raw))
    if not n or n[0].isdigit():
        n = "_" + n
    return f"skylark_{n}"


def _short_hash(raw: str) -> str:
    return format(zlib.crc32(str(raw).encode("utf-8")), "08x")[:6]


def _disambiguate(raws) -> dict:
    """``{raw: base_metric_name}`` — when several raw names sanitize to
    the same metric name, EVERY member of the colliding group gets a
    crc32 suffix (order-independent, stable across renders)."""
    groups: dict = {}
    for r in raws:
        groups.setdefault(_name(r), []).append(r)
    out = {}
    for base, members in groups.items():
        if len(members) == 1:
            out[members[0]] = base
        else:
            for r in members:
                out[r] = f"{base}_{_short_hash(r)}"
    return out


def _esc_label(v) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Writer:
    """Accumulates lines, emitting each family's TYPE line exactly once
    (and before its first sample, as the 0.0.4 format requires)."""

    def __init__(self):
        self.lines: list[str] = []
        self._typed: set = set()

    def sample(self, name: str, kind: str, value, labels=None,
               family: str | None = None) -> None:
        """Append one sample; the TYPE line is keyed on ``family`` (for
        histogram ``_bucket``/``_count``/``_sum`` children) or on the
        sample name itself."""
        if value is None:
            return
        fam = family or name
        if fam not in self._typed:
            self._typed.add(fam)
            self.lines.append(f"# TYPE {fam} {kind}")
        if labels:
            lab = ",".join(f'{k}="{_esc_label(v)}"' for k, v in labels)
            self.lines.append(f"{name}{{{lab}}} {_num(value)}")
        else:
            self.lines.append(f"{name} {_num(value)}")


def _split_tenant(items: dict):
    """Partition ``{raw: value}`` into plain entries and
    ``{metric: [(tenant, value), ...]}`` tenant-labeled families."""
    plain: dict = {}
    tenant: dict = {}
    for k, v in items.items():
        m = _TENANT_RE.match(k)
        if m:
            tenant.setdefault(m.group(2), []).append((m.group(1), v))
        else:
            plain[k] = v
    return plain, tenant


def _emit_histogram(w: _Writer, base: str, h: dict, labels=None) -> None:
    buckets = h.get("buckets")
    if buckets and buckets.get("le"):
        le = buckets["le"]
        counts = buckets["counts"]
        cum = 0
        for bound, c in zip(le, counts):
            cum += c
            w.sample(base + "_bucket", "histogram", cum,
                     (labels or []) + [("le", _num(bound))], family=base)
        cum += counts[len(le)] if len(counts) > len(le) else 0
        w.sample(base + "_bucket", "histogram", cum,
                 (labels or []) + [("le", "+Inf")], family=base)
        # _count/_sum cover the bucketed observations so that
        # +Inf bucket == _count always holds within the family.
        w.sample(base + "_count", "histogram", buckets["count"], labels,
                 family=base)
        w.sample(base + "_sum", "histogram", buckets["sum"], labels,
                 family=base)
    else:
        w.sample(base + "_count", "counter", h["count"], labels)
        w.sample(base + "_sum", "counter", h["sum"], labels)
    w.sample(base + "_min", "gauge", h["min"], labels)
    w.sample(base + "_max", "gauge", h["max"], labels)


def prometheus_text(snap: dict | None = None, *, extra_gauges=None) -> str:
    """Prometheus 0.0.4 text body for ``snap`` (default: a fresh
    ``telemetry.snapshot()``).  ``extra_gauges`` lets a caller inject
    point-in-time gauges sampled outside the registry (the serve front
    adds its live queue depth)."""
    if snap is None:
        from .report import snapshot

        snap = snapshot()
    w = _Writer()

    counters, tenant_counters = _split_tenant(dict(snap.get("counters") or {}))
    names = _disambiguate(counters)
    for k in sorted(counters):
        w.sample(names[k] + "_total", "counter", counters[k])
    for metric in sorted(tenant_counters):
        fam = f"skylark_serve_tenant_{_SANITIZE.sub('_', metric)}_total"
        for tenant, v in sorted(tenant_counters[metric]):
            w.sample(fam, "counter", v, [("tenant", tenant)])

    gauges = dict(snap.get("gauges") or {})
    gauges.update(extra_gauges or {})
    slo_gauges = {}
    for k in list(gauges):
        if k.startswith(_SLO_GAUGE_PREFIX):
            slo_gauges[k[len(_SLO_GAUGE_PREFIX):]] = gauges.pop(k)
    plain_gauges = {k: v for k, v in gauges.items()
                    if isinstance(v, (int, float))}
    names = _disambiguate(plain_gauges)
    for k in sorted(plain_gauges):
        w.sample(names[k], "gauge", plain_gauges[k])
    for key in sorted(slo_gauges):
        v = slo_gauges[key]
        if isinstance(v, (int, float)):
            w.sample("skylark_slo_budget_remaining", "gauge", v,
                     [("objective", key)])

    hists, tenant_hists = _split_tenant(dict(snap.get("histograms") or {}))
    names = _disambiguate(hists)
    for k in sorted(hists):
        _emit_histogram(w, names[k], hists[k])
    for metric in sorted(tenant_hists):
        fam = f"skylark_serve_tenant_{_SANITIZE.sub('_', metric)}"
        for tenant, h in sorted(tenant_hists[metric]):
            _emit_histogram(w, fam, h, [("tenant", tenant)])

    for k, v in sorted((snap.get("plans") or {}).items()):
        if isinstance(v, (int, float)):
            w.sample(_name(f"plans_{k}"), "gauge", v)
    for k in ("plan_cache_hit_rate", "prefetch_overlap",
              "overlap_efficiency"):
        w.sample(_name(k), "gauge", snap.get(k))
    serve = snap.get("serve") or {}
    for k in ("coalesce_ratio", "latency_p50_ms", "latency_p99_ms"):
        if k in serve and f"serve.{k}" not in (snap.get("counters") or {}):
            w.sample(_name(f"serve_{k}"), "gauge", serve[k])
    if "world" in snap:
        w.sample(_name("fleet_world"), "gauge", snap["world"])
    return "\n".join(w.lines) + "\n"
