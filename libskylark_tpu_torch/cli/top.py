"""skylark-torch-top: a live terminal view of a serving fleet (port of
``libskylark_tpu/cli/top.py``; it reads the HTTP surfaces and ledgers
only, so it watches a server of either package).

Tails whichever observability surfaces it is pointed at — any mix of:

- ``--url``: a ``serve_http`` front end; polls ``/stats``, ``/healthz``
  and ``/metrics`` (queue depth, coalesce ratio, p50/p99, shed and
  fallback counters, flight-recorder violation ids via ``/traces``).
  Repeatable: several ``--url`` flags render one per-replica fleet
  table (queue depth, QPS, primed rungs, heartbeat age); pointing one
  ``--url`` at a router front door expands its membership table the
  same way, plus — when the front door runs an autoscaler — the
  membership control-loop panel (bounds, owned/draining replicas, the
  decision-ledger tail).
- ``--telemetry-dir``: the JSONL run-ledger directory
  (``ledger-<pid>.jsonl``); shows event-kind totals and the most recent
  guard verdicts / dumped traces.
- ``--root``: an elastic checkpoint root; folds the epoch-fenced
  ``host-*/progress.jsonl`` ledgers into per-rank progress
  (``telemetry.fold_ledgers``).

Pure stdlib + the telemetry fold helpers — no server-side dependency
beyond the HTTP endpoints, so it runs on a bastion host against a
remote port forward.  ``--once`` renders a single frame and exits
(scripts, tests); otherwise the screen refreshes every ``--interval``
seconds until Ctrl-C.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import urllib.request

__all__ = ["main", "render_frame"]


def _fetch_json(url: str, timeout: float = 2.0) -> dict:
    """GET + parse, ALWAYS returning a dict: transport failures, JSON
    that does not parse (a dying replica truncates mid-body), and JSON
    that parses to a non-object all come back as ``{"_error": ...}`` —
    a displayed fact, never a dashboard traceback."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as fh:
            obj = json.loads(fh.read().decode())
    except Exception as e:  # noqa: BLE001 — a dead server is a displayed fact
        return {"_error": f"{type(e).__name__}: {e}"}
    if not isinstance(obj, dict):
        return {"_error": f"malformed response ({type(obj).__name__})"}
    return obj


def _dict(v) -> dict:
    """A truncated/hostile payload's nested field, dict-or-nothing."""
    return v if isinstance(v, dict) else {}


def _list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else []


def _tail_ledgers(telemetry_dir: str, limit: int = 2048) -> dict:
    """Fold the run-ledger files: event-kind totals plus the latest
    guard / trace / error events (the incident feed)."""
    kinds: dict[str, int] = {}
    incidents: list[dict] = []
    for path in sorted(glob.glob(os.path.join(telemetry_dir, "ledger-*.jsonl"))):
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                lines = fh.readlines()[-limit:]
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:  # torn tail
                continue
            kind = rec.get("kind", "?")
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind in ("guard", "error", "trace"):
                incidents.append(rec)
    incidents.sort(key=lambda r: float(r.get("ts", 0) or 0))
    return {"kinds": kinds, "incidents": incidents[-8:]}


def _fmt(v, nd=2):
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _serve_lines(stats: dict, health: dict, traces: dict) -> list[str]:
    if "_error" in stats:
        return [f"  server: UNREACHABLE ({stats['_error']})"]
    c = _dict(stats.get("counters"))
    lat = _dict(stats.get("latency"))
    reqs = c.get("requests", 0)
    out = []
    backend = health.get("backend", "?")
    reg = _dict(health.get("registry"))
    out.append(
        f"  backend {backend}  models {reg.get('models', '?')}"
        f"  systems {reg.get('systems', '?')}"
        f"  primed {len(_list(health.get('primed')))}"
        f"  worker {'up' if health.get('worker_alive') else 'DOWN'}"
    )
    coalesce = (c.get("coalesced", 0) / reqs) if reqs else None
    out.append(
        f"  queue {stats.get('queue_depth', '?')}"
        f"  requests {reqs}  ok {c.get('ok', 0)}"
        f"  errors {c.get('errors', 0)}"
        f"  coalesce {_fmt(coalesce)}"
    )
    out.append(
        f"  p50 {_fmt(lat.get('latency_p50_ms'))} ms"
        f"  p99 {_fmt(lat.get('latency_p99_ms'))} ms"
        f"  shed_admission {c.get('shed_admission', 0)}"
        f"  shed_deadline {c.get('shed_deadline', 0)}"
        f"  shed_quota {c.get('shed_quota', 0)}"
        f"  solo_retries {c.get('solo_retries', 0)}"
    )
    hits, misses = c.get("cache.hit", 0), c.get("cache.miss", 0)
    if hits or misses:
        rate = hits / (hits + misses) if (hits + misses) else None
        out.append(
            f"  cache hits {hits}  misses {misses}  hit_rate {_fmt(rate)}"
            f"  evictions {c.get('cache.evictions', 0)}"
            f"  invalidations {c.get('cache.invalidations', 0)}"
        )
    # Per-tenant QoS table from the serve.tenant.<t>.<metric> counters
    # (the /stats counters arrive with the "serve." prefix stripped).
    tenants: dict = {}
    for k, v in c.items():
        if k.startswith("tenant."):
            t, _, metric = k[len("tenant."):].partition(".")
            if metric:
                tenants.setdefault(t, {})[metric] = v
    if tenants:
        out.append(
            "  tenant                 reqs      ok    hits  shed q/a/d"
        )
        for t in sorted(tenants):
            m = tenants[t]
            shed = (
                f"{m.get('shed_quota', 0)}/{m.get('shed_admission', 0)}"
                f"/{m.get('shed_deadline', 0)}"
            )
            out.append(
                f"  {t:<20} {m.get('requests', 0):>6}"
                f"  {m.get('ok', 0):>6}  {m.get('cache_hits', 0):>6}"
                f"  {shed}"
            )
    if traces and "_error" not in traces:
        viol = _list(traces.get("violations"))
        line = (
            f"  traces: {len(_list(traces.get('recent')))} recent, "
            f"{len(viol)} violating"
        )
        if viol:
            line += f"  last: {viol[-1]}"
        out.append(line)
    return out


def _slo_lines(slo: dict) -> list[str]:
    """The SLO error-budget panel.  An older replica without the
    ``/slo`` endpoint (404) — or a dying one — renders ``n/a``; a
    healthy replica with no declared objectives renders nothing."""
    if "_error" in slo:
        return ["  slo: n/a"]
    objectives = _dict(slo.get("objectives"))
    if not objectives:
        return []
    out = [
        "  objective              thr(ms)  target%  window   bad"
        "   budget  state"
    ]
    for key in sorted(objectives):
        o = _dict(objectives[key])
        state = "BURNING" if o.get("burning") else "ok"
        out.append(
            f"  {str(key):<22} {_fmt(o.get('threshold_ms'), 1):>7}"
            f"  {_fmt(o.get('target_pct'), 2):>7}"
            f"  {str(o.get('window', '?')):>6}"
            f"  {str(o.get('bad', '?')):>4}"
            f"  {_fmt(o.get('budget_remaining'), 3):>7}  {state}"
        )
    return out


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _spark(values, width: int = 32) -> str:
    """Unicode sparkline over the last ``width`` numeric values."""
    vals = [float(v) for v in values if isinstance(v, (int, float))]
    vals = vals[-width:]
    if not vals:
        return "n/a"
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_CHARS[0] * len(vals)
    return "".join(
        _SPARK_CHARS[min(7, int((v - lo) / span * 8))] for v in vals
    )


def _timeline_lines(timeline: dict) -> list[str]:
    """Sparkline panel over the replica's ``/timeline`` ring.  Missing
    endpoint (older replica) or hostile payloads render ``n/a`` rows,
    never a crash."""
    if "_error" in timeline:
        return ["  timeline: n/a"]
    windows = [_dict(w) for w in _list(timeline.get("windows"))]
    if not windows:
        return ["  timeline: (no windows yet)"]
    derived = [_dict(w.get("derived")) for w in windows]
    out = [
        f"  timeline ({len(windows)} windows @"
        f" {_fmt(timeline.get('interval_s'), 1)}s)"
    ]
    for key, label in (
        ("qps", "qps"),
        ("p99_ms", "p99 ms"),
        ("queue_depth", "queue"),
        ("cache_hit_rate", "cache hit"),
    ):
        vals = [d.get(key) for d in derived]
        nums = [v for v in vals if isinstance(v, (int, float))]
        last = nums[-1] if nums else None
        out.append(f"  {label:<10} {_spark(vals)}  last {_fmt(last)}")
    return out


def _ledger_lines(fold: dict) -> list[str]:
    out = [
        "  events: "
        + (
            "  ".join(f"{k} {v}" for k, v in sorted(fold["kinds"].items()))
            or "(none)"
        )
    ]
    for rec in fold["incidents"]:
        attrs = rec.get("attrs") or {}
        bits = [f"  [{rec.get('kind')}] {rec.get('name')}"]
        for key in ("code", "action", "stage", "rung", "status", "verdict"):
            if key in attrs:
                bits.append(f"{key}={attrs[key]}")
        out.append(" ".join(bits))
    return out


def _rank_lines(hosts: dict) -> list[str]:
    out = [
        f"  epoch {hosts.get('epoch')}  rows {hosts.get('rows_total', 0)}"
        f"  stale {hosts.get('stale_records', 0)}"
        f"  lost {hosts.get('lost_hosts', [])}"
    ]
    for rank in sorted(hosts.get("ranks", {})):
        s = hosts["ranks"][rank]
        age = time.time() - s["last_ts"] if s["last_ts"] else None
        out.append(
            f"  rank {rank:>3}: rows {s['rows']:>10}  batches"
            f" {s['batches']:>6}  seq {s['last_seq']:>6}"
            f"  last write {_fmt(age, 1)}s ago"
        )
    return out


def _autoscale_lines(scale: dict) -> list[str]:
    """The membership control-loop panel: current shape vs targets and
    the tail of the decision ledger."""
    params = _dict(scale.get("params"))
    out = [
        f"  tick {scale.get('tick')}  bounds"
        f" [{params.get('min_replicas')}, {params.get('max_replicas')}]"
        f"  queue_high {_fmt(params.get('queue_high'))}"
        f"  p99_high {_fmt(params.get('p99_high_ms'))} ms"
        f"  cooldown {scale.get('cooldown')}"
    ]
    owned = [str(n) for n in _list(scale.get("owned"))]
    draining = [str(n) for n in _list(scale.get("draining"))]
    out.append(
        f"  owned {', '.join(owned) or '(none)'}"
        f"  draining {', '.join(draining) or '(none)'}"
    )
    for rec in _list(scale.get("ledger"))[-4:]:
        if not isinstance(rec, dict):
            continue
        bits = [f"  tick {str(rec.get('tick', '?')):>4}:"
                f" {rec.get('action', '?')}"]
        if rec.get("replica"):
            bits.append(str(rec["replica"]))
        bits.append(
            f"placeable {rec.get('placeable')}"
            f"  depth {_fmt(rec.get('mean_depth'))}"
            f"  p99 {_fmt(rec.get('p99_ms'))} ms"
        )
        out.append(" ".join(bits))
    return out


def _fleet_table(rows: list) -> list[str]:
    """Per-replica rows of (name, load report | None, heartbeat age)."""
    out = [
        "  replica                        queue    qps  primed  cache"
        "     heartbeat"
    ]
    for name, load, age in rows:
        if not isinstance(load, dict):
            out.append(f"  {name:<30} UNREACHABLE")
            continue
        qps = sum(
            float(_dict(v).get("rows_per_s") or 0.0)
            for v in _dict(load.get("throughput")).values()
        )
        cache = load.get("cache") or {}
        cc = (
            f"{cache.get('hits', 0)}h/{cache.get('entries', 0)}e"
            if isinstance(cache, dict) and cache
            else "n/a"
        )
        beat = "now" if age is None else f"{_fmt(age, 1)}s ago"
        out.append(
            f"  {name:<30} {str(load.get('queue_depth', '?')):>5}"
            f"  {qps:>5.1f}  {len(_list(load.get('primed'))):>6}  {cc:>8}"
            f"  {beat}"
        )
    return out


def render_frame(args, status: dict | None = None) -> str:
    """One full frame as a string (``--once`` prints exactly this).

    ``status`` (optional) is filled with ``{"urls": N, "answered": M}``
    so ``--once`` can report whether ANY replica responded.  A replica
    emitting malformed or truncated JSON renders as an UNREACHABLE-
    style row — one dying member never tracebacks the dashboard."""
    lines = [f"skylark-top  {time.strftime('%H:%M:%S')}"]
    urls = args.url or []
    if isinstance(urls, str):  # programmatic callers with a bare string
        urls = [urls]
    answered = 0
    fleet_rows: list = []
    for base in urls:
        base = base.rstrip("/")
        try:
            health = _fetch_json(base + "/healthz")
            if "_error" not in health:
                answered += 1
            if len(urls) == 1:
                stats = _fetch_json(base + "/stats")
                traces = _fetch_json(base + "/traces")
                lines.append(f"serve {base}")
                lines += _serve_lines(stats, health, traces)
                lines += _slo_lines(_fetch_json(base + "/slo"))
                lines += _timeline_lines(_fetch_json(base + "/timeline"))
            ok = "_error" not in health
            load = health.get("load") if ok else None
            if not isinstance(load, dict):
                load = None
            fleet = _dict(health.get("fleet")) if ok else None
            # A router front door has no load report of its own — it is
            # represented by its expanded members, not an UNREACHABLE
            # row.
            if load is not None or (len(urls) > 1 and not fleet):
                fleet_rows.append((base, load, None))
            if fleet:  # a router front door: expand its membership table
                for name, m in sorted(_dict(fleet.get("members")).items()):
                    m = _dict(m)
                    if m.get("draining"):
                        tag = f"{name} (draining)"
                    elif not m.get("placeable"):
                        tag = f"{name} (unplaceable)"
                    else:
                        tag = name
                    fleet_rows.append(
                        (tag, m.get("report"), m.get("heartbeat_age_s"))
                    )
            scale = health.get("autoscale") if ok else None
            if isinstance(scale, dict) and scale:
                lines.append(f"autoscale {base}")
                lines += _autoscale_lines(scale)
        except Exception as e:  # noqa: BLE001 — last-resort row, never a crash
            lines.append(f"serve {base}")
            lines.append(f"  server: UNREADABLE ({type(e).__name__}: {e})")
    if len(fleet_rows) > 1:
        lines.append(f"fleet ({len(fleet_rows)} replicas)")
        lines += _fleet_table(fleet_rows)
    if args.telemetry_dir:
        lines.append(f"ledger {args.telemetry_dir}")
        lines += _ledger_lines(_tail_ledgers(args.telemetry_dir))
    if args.root:
        from ..telemetry import fold_ledgers

        lines.append(f"fleet {args.root}")
        lines += _rank_lines(fold_ledgers(args.root))
    if status is not None:
        status["urls"] = len(urls)
        status["answered"] = answered
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="skylark-torch-top",
        description="live terminal view of a skylark serving fleet",
    )
    p.add_argument(
        "--url", action="append", default=None,
        help="serve_http base URL to poll (/stats, /healthz, /metrics, "
             "/traces), e.g. http://127.0.0.1:8080; repeatable — "
             "several URLs render a per-replica fleet table",
    )
    p.add_argument(
        "--telemetry-dir", default=None,
        help="run-ledger directory to tail (ledger-<pid>.jsonl)",
    )
    p.add_argument(
        "--root", default=None,
        help="elastic checkpoint root: fold host-*/progress.jsonl into "
             "per-rank progress",
    )
    p.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh period in seconds (default 2)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="render a single frame and exit (no screen clearing)",
    )
    args = p.parse_args(argv)
    if not (args.url or args.telemetry_dir or args.root):
        p.error("nothing to watch: give --url, --telemetry-dir or --root")
    if args.once:
        status: dict = {}
        print(render_frame(args, status))
        # Exit 0 while ANY polled replica answered (a partially-dead
        # fleet is still a rendered fact); 1 only when every --url was
        # unreachable.  Ledger/root-only invocations always exit 0.
        if status.get("urls") and not status.get("answered"):
            return 1
        return 0
    try:
        while True:
            frame = render_frame(args)
            # whole-frame repaint: clear + home, no curses dependency
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
