"""One run of one cell: set-up, the measured window, the metrics, and
the comparison with the plain reference that decides ``correct``.

Order: the driver makes its inputs from the seed and warms up every
shape the window uses, and with tracing on the profiler is started once
(set-up ends here); the window runs; the peak
memory is read; with tracing on, the per-layer readers run (some time a
public call of the program by CUDA events); the program's state is
released; then the reference judges what the window produced.
"""

from __future__ import annotations

import json
import math
import random
import statistics
from dataclasses import dataclass, field
from pathlib import Path

from . import registry
from .env import CACHE_DIR
from .trace import Tracer
from .window import Window, closed_loop


@dataclass
class Run:
    """What the metric readers see."""

    seed: int
    device: object
    driver: object
    setup_s: float = 0.0
    window: Window = field(default_factory=Window)
    trace: object = None  # TraceSummary with --trace 1

    def device_ms(self, fn, reps: int = 5) -> float | None:
        """Device milliseconds of one ``fn()`` by CUDA events over
        ``reps`` calls after one warm-up; None off the card."""
        import torch

        if self.device.type != "cuda":
            return None
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / reps


def _metric_values(run: Run, entries: list[dict]) -> dict:
    out = {}
    for entry in entries:
        value = registry.reader(entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             started: float, clock, *, config: dict | None = None,
             traffic: dict | None = None) -> tuple[dict, list[str], list[str], Run]:
    """Run ``cell`` once; returns (result line, check lines, info lines,
    the run with its driver and window).  ``config`` and ``traffic``
    replace the files' (the CPU rehearsals run a cell at a tiny size
    this way)."""
    import torch

    wl = registry.workload(bench, cell)
    cfg = config if config is not None else registry.config(bench, wl["config"])
    mix = traffic if traffic is not None else registry.traffic(wl["traffic"])
    drv = registry.driver(mix["driver"]).Driver(cfg, mix, seed, device)
    t0 = clock()
    drv.setup()
    driver_s = clock() - t0
    tracer = None
    if trace:
        span = mix.get("trace_stretch", {})
        tracer = Tracer(torch, device, Path(CACHE_DIR) / f"trace-{cell}.json",
                        start_s=span.get("start_s", 1.0), length_s=span.get("length_s", 2.0))
        tracer.warm()
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    run = Run(seed, device, drv, setup_s=clock() - started)
    drv.begin_window()
    run.window = closed_loop(drv.request, sync, seconds, tracer=tracer, clock=clock)
    peaks = ([int(torch.cuda.max_memory_allocated(i)) for i in range(torch.cuda.device_count())]
             if device.type == "cuda" else [0])
    if tracer is not None:
        run.trace = tracer.finish()

    entries = (registry.per_layer(bench, cell) if trace else registry.end_to_end(bench, cell))
    metrics = _metric_values(run, entries)
    info = drv.info_lines(run.window)
    if run.trace is not None:
        t = run.trace
        info.append(f"trace stretch {t.window_s:.4f} s, {t.requests} requests, {t.device_events} "
                    f"device events, the last ending at {t.last_device_s:.4f} s")
    errors = [r["error"] for r in run.window.records if "error" in r]
    if errors:
        info.append(f"{len(errors)} failed requests; the first: {errors[0]}")
    info.append(f"set-up: inputs and warm-up {driver_s:.3f} s")
    lat = run.window.latencies()
    q = max(1, len(lat) // 4)
    info.append("median latency by quarter of the window (ms): " + ", ".join(
        f"{1e3 * statistics.median(lat[i:i + q]):.3f}" for i in range(0, len(lat), q) if lat[i:i + q]))
    slow = sorted(enumerate(lat), key=lambda il: -il[1])[:5]
    info.append("slowest requests (index, s): " + ", ".join(f"({i}, {t:.4f})" for i, t in slow))
    if device.type == "cuda":
        info.append(f"card memory after the window: allocated {torch.cuda.memory_allocated(device)} B,"
                    f" reserved {torch.cuda.memory_reserved(device)} B, peak reserved "
                    f"{torch.cuda.max_memory_reserved(device)} B")

    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = clock()
    checks = drv.check(run.window.records, random.Random(seed))
    info.append(f"reference {clock() - t0:.4f} s")
    failed = run.window.failed
    correct = (failed == 0 and run.window.count > 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks))

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": sum(1 for p in peaks if p > 0), "memory_peak_bytes": max(peaks)}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": bool(correct), "attempted": run.window.count, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    lines = [f"check {c['name']} {c['value']!r} limit {c['limit']!r}" for c in checks]
    return result, lines, info, run


def emit(result: dict, checks: list[str], info: list[str], out, err) -> None:
    """Print the info lines, then the result as the last line of ``out``
    with ``checks`` its last key, then the check lines as the last lines
    of ``err``."""
    for line in info:
        print(line, file=out)
    result = dict(result)
    result["checks"] = result.pop("checks")
    print(json.dumps(result), file=out, flush=True)
    for line in checks:
        print(line, file=err)
    err.flush()
