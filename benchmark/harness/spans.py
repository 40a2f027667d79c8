"""The card's idle time put down to the program's own layers.

The program opens a span (``libskylark_tpu_torch.telemetry.SPANS``) at
each layer it passes through: a ``user_annotation`` of the profiler's
trace, on the same clock as the card's kernels.  :func:`attribute`
splits a traced stretch at every span edge and every edge of the card's
busy time, and gives each piece to the innermost program span open on
the host there: its host time is that span's ``self_ms``, and, where
the card ran nothing, its ``idle_ms``.  Idle outside every program span
goes to :data:`OUTSIDE`; by construction the idle of all names sums to
the stretch's idle time.

The span readers (``metrics/*_idle_ms.ls.py``, ``graph_captures.ls``)
read one more traced stretch of the cell, taken by :func:`read` after
the window: the same closed loop of the driver's requests, bounded by
the same ``bench.stretch`` annotation and synchronizes, whose events
are kept for the spans (``trace.Tracer`` reads its stretch and drops
it).  A program without the catalog (one that opens no spans) reads
None, as every reader does off the card, and so does a stretch in which
a request failed (its failures are printed).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

from .env import CACHE_DIR
from .trace import DEVICE_CATS, STRETCH, Tracer, TraceSummary, merged, summarize
from .window import closed_loop

OUTSIDE = "(outside program spans)"


@dataclass
class SpanStretch:
    """A traced stretch read by span: ``spans[name]`` holds ``calls``,
    ``self_ms`` and ``idle_ms`` over the stretch (``OUTSIDE`` too)."""

    requests: int
    summary: TraceSummary  # the stretch read as trace.summarize reads the window's
    spans: dict = field(default_factory=dict)

    def per_solve(self, key: str, prefixes: tuple) -> float:
        """``key`` summed over the span names that start with one of
        ``prefixes`` (or equal one), per request of the stretch."""
        total = sum(v[key] for name, v in self.spans.items()
                    if name != OUTSIDE and name.startswith(prefixes))
        return total / self.requests

    def line(self) -> str:
        """The info line: idle and self ms a solve by span name, most idle first."""
        n = self.requests
        ranked = sorted(self.spans.items(), key=lambda kv: -kv[1]["idle_ms"])
        parts = ", ".join(f"{name} {v['idle_ms'] / n:.3f}/{v['self_ms'] / n:.3f}"
                          for name, v in ranked)
        t = self.summary
        summed = sum(v["idle_ms"] for v in self.spans.values())
        return (f"idle/self ms a solve by program span over {n} solves (0 failed) of a "
                f"{t.window_s:.4f} s stretch (device idle {t.idle_pct:.3f} %, "
                f"{1e3 * (t.window_s - t.busy_s):.3f} ms; by span {summed:.3f} ms): {parts}")


def attribute(events: list, names, t0: float, t1: float) -> dict:
    """``{name: {calls, self_ms, idle_ms}}`` over ``[t0, t1]`` (µs on the
    trace's clock) for the program spans named in ``names``.

    A span's calls are the spans that start in the stretch; each piece of
    the stretch between consecutive span or busy edges goes to the
    innermost span open there (the latest started), or to ``OUTSIDE``.
    """
    names = set(names)
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        f = s + float(e["dur"])
        if f <= t0 or s >= t1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((max(s, t0), min(f, t1)))
        elif cat == "user_annotation" and e.get("name") in names:
            spans.append((s, f, e["name"]))
    out = {OUTSIDE: {"calls": 0, "self_ms": 0.0, "idle_ms": 0.0}}
    for s, _, name in spans:
        entry = out.setdefault(name, {"calls": 0, "self_ms": 0.0, "idle_ms": 0.0})
        if s >= t0:
            entry["calls"] += 1
    busy = merged(dev)
    edges = {t0, t1}
    edges.update(x for s, f in busy for x in (s, f))
    edges.update(min(max(x, t0), t1) for s, f, _ in spans for x in (s, f))
    edges = sorted(edges)
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    active, nxt, b = [], 0, 0
    for a, z in zip(edges, edges[1:]):
        mid = 0.5 * (a + z)
        while nxt < len(spans) and spans[nxt][0] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] > mid]
        while b < len(busy) and busy[b][1] <= mid:
            b += 1
        idle = not (b < len(busy) and busy[b][0] <= mid)
        entry = out[max(active, key=lambda sp: (sp[0], -sp[1]))[2]] if active else out[OUTSIDE]
        entry["self_ms"] += (z - a) * 1e-3
        if idle:
            entry["idle_ms"] += (z - a) * 1e-3
    return out


def stretch_start(events: list) -> float:
    """Where the ``bench.stretch`` annotation starts (µs)."""
    starts = [float(e["ts"]) for e in events if e.get("name") == STRETCH
              and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not starts:
        raise ValueError("no bench.stretch annotation in the trace")
    return min(starts)


class _KeepingTracer(Tracer):
    """A :class:`~.trace.Tracer` that keeps its stretch's events."""

    def finish(self) -> TraceSummary | None:
        if self.prof is None or self.summary is not None:
            return self.summary
        os.makedirs(os.path.dirname(self.out_path), exist_ok=True)
        self.prof.export_chrome_trace(str(self.out_path))
        self.prof = None
        with open(self.out_path) as fh:
            self.events = json.load(fh).get("traceEvents", [])
        os.remove(self.out_path)
        self.summary = summarize(self.events, self.length)
        self.summary.requests = self.requests
        return self.summary


def catalog():
    """The program's span names, or None where it has no catalog."""
    from libskylark_tpu_torch import telemetry

    return getattr(telemetry, "SPANS", None)


def read(run) -> SpanStretch | None:
    """The cell's span stretch, taken once per run and kept on it; None
    off the card, without a traced run, or where the program opens no
    spans."""
    if run.trace is None or run.device.type != "cuda":
        return None
    if "span_stretch" in run.__dict__:
        return run.__dict__["span_stretch"]
    run.__dict__["span_stretch"] = got = _take(run)
    if got is not None:
        print(got.line(), file=sys.stdout, flush=True)
    return got


def _take(run) -> SpanStretch | None:
    import torch

    names = catalog()
    if names is None:
        return None
    drv = run.driver
    length = float(drv.mix.get("trace_stretch", {}).get("length_s", 2.0))
    tracer = _KeepingTracer(torch, run.device, Path(CACHE_DIR) / "trace-spans.json",
                            start_s=0.0, length_s=length)
    dev = run.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    win = closed_loop(drv.request, sync, length, tracer=tracer)
    summary = tracer.finish()
    if win.failed:
        first = next(r["error"] for r in win.records if "error" in r)
        print(f"span stretch: {win.failed} failed requests of {win.count}, span metrics "
              f"left out; the first: {first}", file=sys.stdout, flush=True)
        return None
    if summary is None or not summary.requests:
        return None
    t0 = stretch_start(tracer.events)
    spans = attribute(tracer.events, names, t0, t0 + 1e6 * tracer.length)
    if len(spans) == 1:  # only OUTSIDE: the trace holds no program span
        return None
    return SpanStretch(requests=summary.requests, summary=summary, spans=spans)
