"""The span contract of ``libskylark_tpu_torch.telemetry.spans``, on the CPU.

- Off (telemetry off, no profiler recording) ``span`` returns the shared
  ``NOOP_SPAN`` and allocates nothing.
- Under ``torch.profiler`` a span is a ``user_annotation`` of the
  exported trace; with telemetry on its ledger ``start_ns`` is on the
  trace's clock, and every span records its ``parent`` and ``root``.
- No span synchronizes a stream or the device, or records a CUDA event,
  in a (simulated) CUDA graph capture or out of one.
- ``telemetry.SPANS`` is the catalog: every name the port opens is in it
  and every name in it is opened somewhere.
- A least-squares solve on the ``sketch`` (FJLT) and ``blendenpik`` (CWT)
  routes gives the catalog's span tree (on the CPU, without the card's
  graph captures and replays).
"""

import json
import re
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libskylark_tpu_torch import telemetry
from libskylark_tpu_torch.core.context import SketchContext
from libskylark_tpu_torch.linalg.least_squares import (
    LeastSquaresParams,
    approximate_least_squares,
)
from libskylark_tpu_torch.telemetry import spans as tspans

pytestmark = pytest.mark.telemetry

PORT = Path(__file__).resolve().parents[1] / "libskylark_tpu_torch"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in ("SKYLARK_TELEMETRY", "SKYLARK_TELEMETRY_DIR", "SKYLARK_NO_PLANS",
                 "SKYLARK_GUARD", "SKYLARK_POLICY_DIR"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    telemetry.close()
    telemetry.configure(None)
    telemetry.reset()
    yield
    telemetry.close()
    telemetry.configure(None)
    telemetry.reset()


def _ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.configure(tmp_path / "ledger")


def _read_ledger():
    telemetry.flush()
    with open(telemetry.ledger_path(), encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


def _trace(prof, tmp_path):
    """(events, base ns) of a stopped profiler's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0))


def _annotations(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") in telemetry.SPANS]


def _tree(events):
    """The program spans as nested ``(name, [children])`` in time order."""
    spans = sorted(_annotations(events), key=lambda e: (float(e["ts"]), -float(e["dur"])))
    roots, stack = [], []
    for e in spans:
        s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        while stack and stack[-1][0] <= s:
            stack.pop()
        node = (e["name"], [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((f, node))
    return roots


def _spin(n):
    for _ in range(n):
        with telemetry.span("ls.solve"):
            pass


def test_off_path_is_the_shared_noop_and_allocates_nothing():
    assert telemetry.span("ls.solve") is telemetry.NOOP_SPAN
    with telemetry.span("random.sample") as sp:
        assert sp is telemetry.NOOP_SPAN
    _spin(10)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        _spin(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before
    # Nothing grows with the calls: the peak is one call's transient key
    # lookup in the environment.
    assert peak - before < 4096
    assert telemetry.REGISTRY.snapshot()["counters"] == {}


def test_profiler_only_span_is_an_annotation_without_ledger_or_counters(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = telemetry.span("dense.qr")
        assert sp is not telemetry.NOOP_SPAN and not isinstance(sp, telemetry.Span)
        with sp:
            torch.ones(4).sum()
    assert telemetry.span("dense.qr") is telemetry.NOOP_SPAN  # off again
    events, _ = _trace(prof, tmp_path)
    assert [e["name"] for e in _annotations(events)] == ["dense.qr"]
    assert telemetry.REGISTRY.snapshot()["counters"] == {}
    assert telemetry.ledger_path() is None


def test_ledger_start_ns_is_on_the_profiler_clock(tmp_path, monkeypatch):
    _ledger(tmp_path, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("ls.solve"):
            with telemetry.span("dense.solve") as sp:
                torch.ones(8).cumsum(0)
    events, base = _trace(prof, tmp_path)
    marks = {e["name"]: e for e in _annotations(events)}
    assert set(marks) == {"ls.solve", "dense.solve"}
    ledger = {(e["kind"], e["name"]): e["attrs"] for e in _read_ledger()}
    for name, mark in marks.items():
        start_ns = ledger[("span_start", name)]["start_ns"]
        end = ledger[("span_end", name)]
        assert end["start_ns"] == start_ns and end["end_ns"] >= start_ns
        ts_ns = float(mark["ts"]) * 1e3 + base
        assert abs(start_ns - ts_ns) < 1e6, (name, start_ns, ts_ns)
        assert abs(end["end_ns"] - (ts_ns + float(mark["dur"]) * 1e3)) < 1e6
    # seconds are host seconds, read on the span's own clock.
    assert 0 <= sp.seconds <= (end["end_ns"] - end["start_ns"]) * 1e-9 + 1e-3


def test_parent_and_root_ids(tmp_path, monkeypatch):
    _ledger(tmp_path, monkeypatch)
    with telemetry.span("ls.solve") as top:
        with telemetry.span("guard.certify") as mid:
            with telemetry.span("cond_est.chunk") as leaf:
                pass
        with telemetry.span("dense.solve") as second:
            pass
    with telemetry.span("ls.solve") as other:
        pass
    assert top.root == mid.root == leaf.root == second.root == top.id
    assert other.root == other.id != top.id
    events = _read_ledger()
    starts = {e["seq"]: e["attrs"] for e in events if e["kind"] == "span_start"}
    assert "parent" not in starts[top.id] and "root" not in starts[top.id]
    assert starts[mid.id]["parent"] == top.id and starts[mid.id]["root"] == top.id
    assert starts[leaf.id]["parent"] == mid.id and starts[leaf.id]["root"] == top.id
    assert starts[second.id]["parent"] == top.id and starts[second.id]["depth"] == 1
    ends = {e["attrs"]["span"]: e["attrs"] for e in events if e["kind"] == "span_end"}
    assert {s: a["root"] for s, a in ends.items()} == {
        top.id: top.id, mid.id: top.id, leaf.id: top.id, second.id: top.id,
        other.id: other.id}
    assert tspans._stack() == []


@pytest.mark.parametrize("state", ["off", "profiler", "telemetry"])
@pytest.mark.parametrize("capturing", [True, False])
def test_no_span_waits_or_records_a_cuda_event(monkeypatch, tmp_path, state, capturing):
    calls = []
    record = lambda what: lambda *a, **k: calls.append(what)
    monkeypatch.setattr(torch.cuda, "synchronize", record("device.synchronize"))
    monkeypatch.setattr(torch.cuda, "current_stream", record("current_stream"))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", record("stream.synchronize"))
    monkeypatch.setattr(torch.cuda, "Event", record("Event"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    if state == "telemetry":
        _ledger(tmp_path, monkeypatch)
    prof = profile(activities=[ProfilerActivity.CPU]) if state == "profiler" else None
    if prof is not None:
        prof.start()
    try:
        for name in telemetry.SPANS:
            with telemetry.span(name):
                with telemetry.span("random.sample"):
                    torch.ones(2).add_(1)
    finally:
        if prof is not None:
            prof.stop()
    assert calls == []
    if state == "telemetry":
        assert telemetry.REGISTRY.snapshot()["counters"]["span.random.sample.calls"] == len(
            telemetry.SPANS) + 1


def test_spans_module_never_waits_for_the_card():
    src = (PORT / "telemetry" / "spans.py").read_text()
    for word in ("synchronize", "_cuda_devices", "Event(", ".result"):
        assert word not in src, word


def _opened_in_source():
    """(literal span names, chunked-solver kinds) the port's sources open."""
    literal, kinds = set(), set()
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        literal |= set(re.findall(r"telemetry\.span\(\s*\"([^\"]+)\"", src))
        kinds |= set(re.findall(r"(?:_chunked|chunk_span)\(\s*\"(\w+)\"", src))
    return literal, kinds


def test_the_catalog_is_what_the_port_opens():
    literal, passed = _opened_in_source()
    assert literal <= set(telemetry.SPANS), literal - set(telemetry.SPANS)
    # Every kind with spans is passed down; other kinds open none.
    kinds = passed & set(tspans.CHUNKED_KINDS)
    assert kinds == set(tspans.CHUNKED_KINDS), passed
    opened = literal | {f"{k}.{what}" for k in kinds for what in ("capture", "chunk")}
    assert set(telemetry.SPANS) == opened, set(telemetry.SPANS) ^ opened
    assert len(set(telemetry.SPANS)) == len(telemetry.SPANS)
    for name in telemetry.SPANS:
        assert re.fullmatch(r"[a-z_]+\.[a-z_]+", name), name
    doc = tspans.__doc__
    for name in set(telemetry.SPANS) - {f"{k}.{w}" for k in kinds for w in ("capture", "chunk")}:
        assert f"``{name}``" in doc, name


# GPU-only spans: the plans' captures and replays, the solvers' step graphs.
CARD_ONLY = {"plans.capture", "plans.replay", "cond_est.capture", "lsqr.capture"}


@pytest.mark.parametrize("route,stype,children", [
    ("sketch", "FJLT", ["policy.consult", "sketch.apply", "sketch.apply", "guard.certify",
                        "dense.solve"]),
    ("blendenpik", "CWT", ["policy.consult", "sketch.apply", "dense.qr", "guard.certify",
                           "lsqr.run"]),
])
def test_least_squares_span_tree(tmp_path, monkeypatch, route, stype, children):
    gen = torch.Generator().manual_seed(3)
    A = torch.randn(512, 12, generator=gen, dtype=torch.float64)
    b = torch.randn(512, generator=gen, dtype=torch.float64)
    ctx = SketchContext(seed=11)
    params = LeastSquaresParams(sketch_type=stype, sketch_size=64)
    solve = lambda: approximate_least_squares(A, b, ctx, params, route=route,
                                              return_info=True, device="cpu")
    solve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            solve()
    events, _ = _trace(prof, tmp_path)
    roots = _tree(events)
    assert [name for name, _ in roots] == ["ls.solve", "ls.solve"]
    for _, kids in roots:
        assert [name for name, _ in kids] == children
        for name, sub in kids:
            below = {n for n, _ in sub}
            if name == "sketch.apply":
                assert below <= {"random.sample"}
            elif name == "guard.certify" and route == "sketch":
                assert "cond_est.chunk" in below and below <= {"random.sample", "cond_est.chunk"}
            elif name == "lsqr.run":
                assert below == {"lsqr.chunk"} and len(sub) >= 2
            else:
                assert below == set(), (name, below)
    assert "random.sample" in {n for _, kids in roots for _, sub in kids for n, _ in sub}
    names = {e["name"] for e in _annotations(events)}
    assert not names & CARD_ONLY
    # With telemetry on the same solve's spans share the ls.solve span's id.
    _ledger(tmp_path, monkeypatch)
    solve()
    ends = [e["attrs"] for e in _read_ledger() if e["kind"] == "span_end"]
    top = [a for a in ends if a["root"] == a["span"]]
    assert len(top) == 1 and {a["root"] for a in ends} == {top[0]["span"]}


@pytest.mark.parametrize("solver,opened", [
    ("lsqr", {"lsqr.run", "lsqr.chunk"}),
    ("cg", set()),
    ("flexible_cg", set()),
    ("chebyshev", set()),
])
def test_only_the_catalog_kinds_open_krylov_spans(tmp_path, monkeypatch, solver, opened):
    """LSQR opens its spans (no capture off the card); the Krylov solvers
    outside ``CHUNKED_KINDS`` open none."""
    from libskylark_tpu_torch.solvers import krylov

    _ledger(tmp_path, monkeypatch)
    g = torch.Generator().manual_seed(7)
    A = torch.diag(torch.linspace(1.0, 2.0, 16, dtype=torch.float64))
    A += 1e-3 * torch.randn(16, 16, generator=g, dtype=torch.float64)
    A = 0.5 * (A + A.T)
    B = torch.randn(16, 2, generator=g, dtype=torch.float64)
    if solver == "chebyshev":
        sv = torch.linalg.svdvals(A)
        krylov.chebyshev(A, B, float(sv.min()) * 0.9, float(sv.max()) * 1.1)
    else:
        getattr(krylov, solver)(A, B)
    counters = telemetry.REGISTRY.snapshot()["counters"]
    got = {k[5:].rsplit(".", 1)[0] for k in counters if k.startswith("span.")}
    assert got == opened
