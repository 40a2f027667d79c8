"""The traced stretch of a ``--trace 1`` window and what is read from it.

``torch.profiler`` records the CPU and the card over a stretch of the
window that starts at the first request boundary past ``start_s`` and
ends at the first boundary past ``length_s`` later (at least one whole
request).  The stretch is the ``bench.stretch`` annotation; the card's
busy time is the union of its kernel, copy and set intervals inside it.
While the stretch runs, the calls of the program's kernel wrappers are
recorded with their shapes (:mod:`.kernels`).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from . import kernels as kernel_calls

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "bench.stretch"
# Kernels of the program's own CUDA sources: top-level anonymous
# namespace functions of csrc/*.cu (torch's lie under at::).
PORT_KERNELS = ("gather_scaled_rows_kernel", "gather_elems_kernel", "count_kernel",
                "place_kernel", "seg_start_kernel", "walk_wide_kernel", "walk_narrow_kernel",
                "fold_kernel", "accumulate_kernel", "rfut_rowwise_kernel",
                "rfut_rowwise_sampled_kernel", "rfut_rowwise_warp_kernel")


def is_port_kernel(name: str) -> bool:
    head = name[5:] if name.startswith("void ") else name
    if not head.startswith("(anonymous namespace)::"):
        return False
    base = head[len("(anonymous namespace)::"):].split("<", 1)[0].split("(", 1)[0]
    return base in PORT_KERNELS


def merged(intervals):
    """Sorted, disjoint [start, end] lists covering the same time."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class TraceSummary:
    """What a traced stretch gives the metric readers (times in s)."""

    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)   # [(name, seconds)], top 10
    idle_gaps: list = field(default_factory=list)    # [(host activity, seconds)], top 10
    port_kernel_s: float = 0.0
    kernel_calls: list = field(default_factory=list)  # wrapper calls, see kernels.py
    launch_delta: dict = field(default_factory=dict)  # program's counters over the stretch
    requests: int = 0
    device_events: int = 0
    last_device_s: float = 0.0  # end of the last device event, from the stretch's start

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def summarize(events: list, length_s: float, top: int = 10) -> TraceSummary:
    """Reduce chrome-trace events to a :class:`TraceSummary` of the
    stretch that starts where the ``bench.stretch`` annotation does and
    lasts ``length_s`` (the host clock's reading between the two
    synchronizes that bound it)."""
    stretch = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError("no bench.stretch annotation in the trace")
    t0 = min(float(e["ts"]) for e in stretch)
    t1 = t0 + 1e6 * length_s
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        f = s + float(e["dur"])
        if f <= t0 or s >= t1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((max(s, t0), min(f, t1), e.get("name", "?")))
        elif cat in HOST_CATS and e.get("name") != STRETCH:
            host.append((s, f, e.get("name", "?")))
    by_name: dict = {}
    port_s = 0.0
    for s, f, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (f - s) * 1e-6
        if is_port_kernel(name):
            port_s += (f - s) * 1e-6
    busy = merged([(s, f) for s, f, _ in dev])
    gaps = []
    prev = t0
    for s, f in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, f)
    by_host: dict = {}
    host.sort()
    active, nxt = [], 0
    for g0, g1 in gaps:  # in time order, so one sweep over the host events
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        covering = [(f - s, name) for s, f, name in active]
        what = min(covering)[1] if covering else "host: no traced activity"
        by_host[what] = by_host.get(what, 0.0) + (g1 - g0) * 1e-6
    rank = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=(t1 - t0) * 1e-6,
                        busy_s=sum(f - s for s, f in busy) * 1e-6,
                        device_ops=rank(by_name), idle_gaps=rank(by_host),
                        port_kernel_s=port_s,
                        device_events=len(dev),
                        last_device_s=max((f for _, f, _ in dev), default=t0) * 1e-6 - t0 * 1e-6)


class Tracer:
    """Starts and stops the profiler at request boundaries of a window."""

    def __init__(self, torch, device, out_path, start_s: float, length_s: float):
        self.torch, self.device, self.out_path = torch, device, out_path
        self.start_s, self.length_s = float(start_s), float(length_s)
        self.prof = self.annotation = self.recorder = None
        self.delta = {}
        self.clock_on = self.length = None
        self.done = False
        self.requests = 0
        self.launches_before = None
        self.summary: TraceSummary | None = None

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start in a
        process loads the card's tracing library, which takes seconds that
        would otherwise come out of the window."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            self._sync()

    def before(self, elapsed: float) -> None:
        if self.prof is not None or self.done or elapsed < self.start_s:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        from libskylark_tpu_torch.sketch import _launch

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()  # the stretch starts after it
        self.launches_before = _launch.launch_counts()
        self.recorder = kernel_calls.Recorder()
        self.recorder.__enter__()
        self.annotation = record_function(STRETCH)
        self.annotation.__enter__()
        self.clock_on = time.perf_counter()

    def after(self, final: bool = False) -> None:
        if self.prof is None or self.done:
            return
        if not final:
            self.requests += 1
        if not final and time.perf_counter() - self.clock_on < self.length_s:
            return
        from libskylark_tpu_torch.sketch import _launch

        self._sync()
        self.length = time.perf_counter() - self.clock_on
        self.annotation.__exit__(None, None, None)
        self.recorder.__exit__(None, None, None)
        self.delta = _launch.launch_delta(self.launches_before, _launch.launch_counts())
        self.prof.stop()
        self.done = True

    def finish(self) -> TraceSummary | None:
        """Export and read the stretch's trace, once the window is over."""
        if self.prof is None or self.summary is not None:
            return self.summary
        os.makedirs(os.path.dirname(self.out_path), exist_ok=True)
        self.prof.export_chrome_trace(str(self.out_path))
        self.prof = None
        with open(self.out_path) as fh:
            events = json.load(fh).get("traceEvents", [])
        os.remove(self.out_path)
        self.summary = summarize(events, self.length)
        self.summary.kernel_calls = self.recorder.calls
        self.summary.launch_delta = {k[1]: v for k, v in self.delta.items() if k[2] is None}
        self.summary.requests = self.requests
        return self.summary
