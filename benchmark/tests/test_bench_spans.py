"""The span readers: idle time of a synthetic trace put down to the
innermost program span, split exactly at span edges; the six readers'
values; their silence off the card, without a trace and on a program
without spans; and a CPU stretch of the least-squares driver read by
span."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import registry, spans, trace
from benchmark.harness.spans import OUTSIDE, SpanStretch, attribute

from .tiny import CPU, cell_inputs

NAMES = ("ls.solve", "sketch.apply", "plans.capture", "plans.replay", "random.sample",
         "guard.certify", "cond_est.capture", "cond_est.chunk", "lsqr.run", "lsqr.capture",
         "lsqr.chunk", "dense.solve")
READERS = ("graph_captures.ls", "plans_idle_ms.ls", "guard_idle_ms.ls", "krylov_idle_ms.ls",
           "sketch_idle_ms.ls", "counter_stream_idle_ms.ls")


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _ann(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


def _kernel(ts, dur, name="at::native::elementwise"):
    return _x(name, "kernel", ts, dur)


# One solve in a 1000 µs stretch at t = 1000.  Busy: [1050, 1100],
# [1300, 1400] (two kernels overlapping), [1700, 1750] and [1950, 2000].
SPANS = [
    _ann("ls.solve", 1000.0, 990.0),
    _ann("sketch.apply", 1010.0, 390.0),
    _ann("plans.capture", 1020.0, 280.0),
    _ann("random.sample", 1150.0, 50.0),
    _ann("plans.replay", 1300.0, 100.0),
    _ann("guard.certify", 1400.0, 400.0),
    _ann("cond_est.capture", 1420.0, 80.0),
    _ann("cond_est.chunk", 1500.0, 100.0),
    _ann("cond_est.chunk", 1600.0, 100.0),
    _ann("dense.solve", 1800.0, 150.0),
    _ann("lsqr.chunk", 500.0, 100.0),          # before the stretch: not read
    _ann("other.name", 1000.0, 1000.0),        # not a program span
]
DEVICE = [_kernel(1050.0, 50.0), _kernel(1300.0, 80.0), _kernel(1350.0, 50.0),
          _x("Memcpy DtoD", "gpu_memcpy", 1700.0, 50.0), _kernel(1950.0, 80.0)]
HOST = [_x("aten::mm", "cpu_op", 1120.0, 10.0), _x("cudaGraphLaunch", "cuda_runtime", 1310.0, 5.0)]
EVENTS = [_ann(trace.STRETCH, 1000.0, 1000.0)] + SPANS + DEVICE + HOST

# Idle by innermost span (µs): ls.solve [1000, 1010); sketch.apply [1010, 1020);
# plans.capture [1020, 1050) + [1100, 1150) + [1200, 1300); random.sample
# [1150, 1200); plans.replay none (busy); guard.certify [1400, 1420) + [1750, 1800);
# cond_est.capture [1420, 1500); cond_est.chunk [1500, 1700); dense.solve
# [1800, 1950); [1950, 2000) is busy.
IDLE = {"ls.solve": 10.0, "sketch.apply": 10.0, "plans.capture": 180.0, "random.sample": 50.0,
        "plans.replay": 0.0, "guard.certify": 70.0, "cond_est.capture": 80.0,
        "cond_est.chunk": 200.0, "dense.solve": 150.0, OUTSIDE: 0.0}


def test_idle_goes_to_the_innermost_span_split_at_span_edges():
    got = attribute(EVENTS, NAMES, 1000.0, 2000.0)
    assert {k: v["idle_ms"] * 1e3 for k, v in got.items()} == pytest.approx(IDLE, abs=1e-9)
    assert got["cond_est.chunk"]["calls"] == 2 and got["plans.capture"]["calls"] == 1
    assert "lsqr.chunk" not in got and "other.name" not in got
    # Self time: the span's host time less its program children's.
    assert got["plans.capture"]["self_ms"] * 1e3 == pytest.approx(280.0 - 50.0)
    assert got["sketch.apply"]["self_ms"] * 1e3 == pytest.approx(390.0 - 280.0 - 100.0)
    assert got["ls.solve"]["self_ms"] * 1e3 == pytest.approx(990.0 - 390.0 - 400.0 - 150.0)
    assert got[OUTSIDE]["self_ms"] * 1e3 == pytest.approx(10.0)
    assert sum(v["self_ms"] for v in got.values()) == pytest.approx(1.0)


def test_an_idle_gap_across_a_span_edge_is_split_there_not_at_its_midpoint():
    events = [_ann("plans.capture", 0.0, 100.0), _ann("random.sample", 40.0, 40.0),
              _kernel(0.0, 10.0), _kernel(90.0, 10.0)]
    got = attribute(events, NAMES, 0.0, 100.0)
    # The gap [10, 90) holds the draw [40, 80): 30 + 10 to the capture, 40 to the draw.
    assert got["plans.capture"]["idle_ms"] * 1e3 == pytest.approx(40.0)
    assert got["random.sample"]["idle_ms"] * 1e3 == pytest.approx(40.0)
    assert sum(v["idle_ms"] for v in got.values()) * 1e3 == pytest.approx(80.0)


@pytest.mark.parametrize("shift", [0.0, 1.7e12])
def test_idle_by_span_plus_outside_is_the_stretch_idle(shift):
    """On the trace's absolute clock too (µs since the epoch, as exported)."""
    moved = [dict(e, ts=e["ts"] + shift) for e in EVENTS
             + [_kernel(1005.0, 2.0), _ann("dense.qr", 1960.0, 60.0)]]
    summary = trace.summarize(moved, 1e-3)
    got = attribute(moved, NAMES + ("dense.qr",), 1000.0 + shift, 2000.0 + shift)
    idle_s = sum(v["idle_ms"] for v in got.values()) * 1e-3
    assert abs(idle_s - (summary.window_s - summary.busy_s)) < 1e-9
    assert abs(summary.idle_pct * summary.window_s / 100 - idle_s) < 1e-9


def test_program_spans_leave_the_device_fields_of_the_summary_as_they_were():
    """``trace.summarize`` reads the card's time as before; the program's
    annotations only give ``idle_gaps`` smaller covering host events."""
    plain = trace.summarize([_ann(trace.STRETCH, 1000.0, 1000.0)] + DEVICE + HOST, 1e-3)
    spanned = trace.summarize(EVENTS, 1e-3)
    for name in ("window_s", "busy_s", "device_ops", "port_kernel_s", "device_events",
                 "last_device_s", "requests", "kernel_calls", "launch_delta"):
        assert getattr(spanned, name) == getattr(plain, name), name
    assert dict(plain.idle_gaps)["host: no traced activity"] > 0
    assert "host: no traced activity" not in dict(spanned.idle_gaps)


def _stretch(requests=2):
    got = attribute(EVENTS, NAMES, 1000.0, 2000.0)
    got["lsqr.capture"] = {"calls": 1, "self_ms": 0.02, "idle_ms": 0.01}
    got["lsqr.chunk"] = {"calls": 17, "self_ms": 0.5, "idle_ms": 0.3}
    got["lsqr.run"] = {"calls": 1, "self_ms": 0.1, "idle_ms": 0.06}
    return SpanStretch(requests=requests, summary=trace.summarize(EVENTS, 1e-3), spans=got)


def _run(stretch, device="cuda", trace_=True):
    run = SimpleNamespace(trace=object() if trace_ else None, device=torch.device(device),
                          window=None, driver=SimpleNamespace())
    run.span_stretch = stretch
    return run


def test_each_reader_reads_its_spans_per_solve():
    run = _run(_stretch(requests=2))
    got = {name: registry.reader(name).read(run) for name in READERS}
    # One capture each of a plan, the certificate's sweep and LSQR's step.
    assert got["graph_captures.ls"] == pytest.approx((1 + 1 + 1) / 2)
    assert got["plans_idle_ms.ls"] == pytest.approx(0.180 / 2)
    assert got["guard_idle_ms.ls"] == pytest.approx((0.070 + 0.080 + 0.200) / 2)
    assert got["krylov_idle_ms.ls"] == pytest.approx((0.01 + 0.3 + 0.06) / 2)
    assert got["sketch_idle_ms.ls"] == pytest.approx(0.010 / 2)
    assert got["counter_stream_idle_ms.ls"] == pytest.approx(0.050 / 2)


def test_the_info_line_ranks_spans_by_idle():
    line = _stretch(requests=2).line()
    assert line.startswith("idle/self ms a solve by program span over 2 solves")
    order = [part.split(" ")[0] for part in line.split("): ", 1)[1].split(", ")]
    assert order[:3] == ["lsqr.chunk", "cond_est.chunk", "plans.capture"]


def test_span_readers_read_nothing_off_the_card_without_a_trace_or_spans(monkeypatch):
    for run in (_run(_stretch(), device="cpu"), _run(_stretch(), trace_=False)):
        for name in READERS:
            assert registry.reader(name).read(run) is None, name
    # A program without the catalog (the parent of the spans) reads None
    # without running anything.
    monkeypatch.setattr(spans, "catalog", lambda: None)
    run = SimpleNamespace(trace=object(), device=torch.device("cuda"), window=None,
                          driver=SimpleNamespace(request=lambda i: pytest.fail("ran")))
    for name in READERS:
        assert registry.reader(name).read(run) is None, name


@pytest.mark.parametrize("cell,expect", [
    ("ls_sketch_fjlt", {"ls.solve", "policy.consult", "sketch.apply", "guard.certify",
                        "cond_est.chunk", "dense.solve", "random.sample"}),
    ("ls_blendenpik_cwt", {"ls.solve", "policy.consult", "sketch.apply", "dense.qr",
                           "guard.certify", "lsqr.run", "lsqr.chunk", "random.sample"}),
])
def test_a_cpu_stretch_of_the_driver_is_read_by_span(cell, expect):
    _, cfg, mix = cell_inputs(cell)
    mix["trace_stretch"] = {"start_s": 0.0, "length_s": 0.05}
    drv = registry.driver(mix["driver"]).Driver(cfg, mix, 2 ** 31 + 3, CPU)
    drv.setup()
    # The traced run's own stretch comes first: the profiler and its first
    # annotation (a millisecond of set-up) are warm when the spans' starts.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function(trace.STRETCH):
            drv.request(0)
    got = spans._take(SimpleNamespace(device=CPU, driver=drv))
    assert got is not None and got.requests >= 1
    assert set(got.spans) - {OUTSIDE} == expect
    assert got.spans["ls.solve"]["calls"] == got.requests
    t = got.summary
    assert t.busy_s == 0.0  # no card: all of the stretch is idle
    idle = sum(v["idle_ms"] for v in got.spans.values()) * 1e-3
    assert abs(idle - t.window_s) < 1e-9


def test_a_span_stretch_with_a_failed_request_reads_none(capsys):
    _, cfg, mix = cell_inputs("ls_sketch_fjlt")
    mix["trace_stretch"] = {"start_s": 0.0, "length_s": 0.05}
    drv = registry.driver(mix["driver"]).Driver(cfg, mix, 2 ** 31 + 5, CPU)
    drv.setup()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function(trace.STRETCH):
            drv.request(0)
    request = drv.request

    def failing(i):
        if i == 0:
            raise RuntimeError("a failed solve")
        return request(i)

    drv.request = failing
    assert spans._take(SimpleNamespace(device=CPU, driver=drv)) is None
    out = capsys.readouterr().out
    assert "span stretch: 1 failed requests of " in out and "a failed solve" in out
