"""The metric arithmetic: a rate over the whole window, a percentile over
every sample, the idle share and breakdown of a synthetic trace, and the
readers' refusal to report what they cannot read."""

import statistics
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import registry, trace
from benchmark.harness.window import Window, closed_loop, percentile


def test_closed_loop_rate_counts_every_second_and_request():
    t = [0.0]

    def clock():
        return t[0]

    def request(i):
        t[0] += 0.3 if i % 2 else 0.1   # alternating 100 ms and 300 ms solves
        return {}

    win = closed_loop(request, lambda: None, 1.0, clock=clock)
    assert win.count == 6                          # stops at the first boundary past 1 s
    assert win.seconds == pytest.approx(1.2)
    reader = registry.reader("solve_ms")
    assert reader.read(SimpleNamespace(window=win)) == pytest.approx(200.0)


def test_failed_request_is_kept_and_counted():
    t = [0.0]

    def request(i):
        t[0] += 0.5
        if i == 1:
            raise RuntimeError("boom")
        return {}

    win = closed_loop(request, lambda: None, 1.0, clock=lambda: t[0])
    assert win.count == 2 and win.failed == 1
    assert win.records[1]["latency_s"] == pytest.approx(0.5)


def test_p95_is_over_all_samples():
    lat = [0.001 * i for i in range(1, 201)]
    win = Window(records=[{"latency_s": v} for v in lat], start=0.0, end=sum(lat))
    got = registry.reader("solve_p95_ms").read(SimpleNamespace(window=win))
    assert got == pytest.approx(1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert percentile([0.5], 95) == 0.5


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_share_and_breakdown_of_a_synthetic_trace():
    events = [
        _x(trace.STRETCH, "user_annotation", 1000.0, 1000.0),
        _x("void (anonymous namespace)::gather_scaled_rows_kernel<float>(float const*)",
           "kernel", 1100.0, 100.0),
        _x("at::native::elementwise", "kernel", 1150.0, 100.0),   # overlaps: union 150
        _x("Memcpy DtoH", "gpu_memcpy", 1500.0, 50.0),
        _x("aten::linalg_qr", "cpu_op", 1250.0, 250.0),          # host during the gap
        _x("bench.request", "user_annotation", 1000.0, 1000.0),
        _x("outside", "kernel", 3000.0, 10.0),                    # past the stretch
    ]
    s = trace.summarize(events, 1e-3)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(200e-6)
    assert s.idle_pct == pytest.approx(80.0)
    assert s.port_kernel_s == pytest.approx(100e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["aten::linalg_qr"] == pytest.approx(250e-6)
    assert gaps["bench.request"] == pytest.approx((100 + 450) * 1e-6)
    assert s.device_ops[0][1] == pytest.approx(100e-6)
    assert len(s.device_ops) == 3


def test_port_kernels_are_told_from_torch_kernels():
    assert trace.is_port_kernel("void (anonymous namespace)::walk_wide_kernel<float>(int)")
    assert trace.is_port_kernel("(anonymous namespace)::fold_kernel(int const*, float*)")
    assert not trace.is_port_kernel(
        "void at::native::(anonymous namespace)::count_kernel<float>(int)")
    assert not trace.is_port_kernel("void (anonymous namespace)::other_kernel(int)")


def test_trace_readers_read_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, device=torch.device("cpu"),
                          window=Window(), driver=SimpleNamespace())
    for name in ("device_idle_pct.ls", "device_idle_pct.krr", "cuda_kernel_roofline.ls",
                 "sketch_roofline.ls", "panel_roofline.krr", "sweep_s.krr", "lsqr_iters.ls",
                 "guard_attempts.ls"):
        assert registry.reader(name).read(run) is None, name


def test_kernel_roofline_prices_each_launch_by_its_shapes():
    M, N, S = 50_000, 500, 2000
    calls = [{"kernel": "gather_scaled_rows", "T": (M, N), "idx": (S,), "itemsize": 4},
             {"kernel": "gather_scaled_rows", "T": (M, 1), "idx": (S,), "itemsize": 4},
             {"kernel": "gather_scaled_rows", "T": (M, 1), "idx": (S,), "itemsize": 4}]
    from benchmark import counts

    least = counts.gather_scaled_rows(M, N, S).least_s() + 2 * counts.gather_scaled_rows(
        M, 1, S).least_s()
    t = trace.TraceSummary(window_s=1.0, busy_s=0.5, port_kernel_s=4 * least,
                           kernel_calls=calls, launch_delta={"gather_scaled_rows": 3})
    got = registry.reader("cuda_kernel_roofline.ls").read(SimpleNamespace(trace=t))
    assert got == pytest.approx(25.0)
    # A launch whose shapes were never seen is not priced.
    t.launch_delta["scatter_rows"] = 1
    assert registry.reader("cuda_kernel_roofline.ls").read(SimpleNamespace(trace=t)) is None
