"""Port vs JAX package: the pure-Python half of the telemetry layer —
request traces and the flight recorder (``telemetry/trace.py``), SLO
budgets (``slo.py``), the timeline ring (``timeline.py``), the phase
clock (``phases.py``), the Prometheus exposition (``exposition.py``) and
the fleet folds (``fleet.py``) — on the CPU.

Each is held to ``tests/test_trace.py``'s contracts that need no server
(the serve plane is the next slice of the port) and to the JAX module
fed the same calls: ``prometheus_text`` byte-identical for the same
snapshot, ``merge_snapshots`` and the SLO reports equal, and
``fold_ledgers`` equal to the JAX package's fold of progress ledgers and
an epoch marker written by the JAX package's own elastic writers.  No
tolerance: everything compared here is exact.
"""

import importlib
import json
import os

import pytest
import torch

from libskylark_tpu import telemetry as JT
from libskylark_tpu_torch import telemetry
from libskylark_tpu_torch.telemetry import fleet as tfleet
from libskylark_tpu_torch.telemetry.trace import FlightRecorder, is_violating
from libskylark_tpu_torch.utils import exceptions as ex

pytestmark = pytest.mark.trace

JSLO = importlib.import_module("libskylark_tpu.telemetry.slo")
TSLO = importlib.import_module("libskylark_tpu_torch.telemetry.slo")
JTL = importlib.import_module("libskylark_tpu.telemetry.timeline")
TTL = importlib.import_module("libskylark_tpu_torch.telemetry.timeline")
JPLANS = importlib.import_module("libskylark_tpu.plans")
TPLANS = importlib.import_module("libskylark_tpu_torch.plans")
JSERVER = importlib.import_module("libskylark_tpu.serve.server")
TSERVER = importlib.import_module("libskylark_tpu_torch.serve.server")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("SKYLARK_TELEMETRY", "SKYLARK_TELEMETRY_DIR", "SKYLARK_TRACE", "SKYLARK_SLO",
                 "SKYLARK_SLO_WINDOW", "SKYLARK_SLO_BURN", "SKYLARK_TIMELINE_INTERVAL_S",
                 "SKYLARK_TIMELINE_CAPACITY", "SKYLARK_PHASES", "SKYLARK_TELEMETRY_FLEET_ROOT"):
        monkeypatch.delenv(knob, raising=False)
    for pkg in (telemetry, JT):
        pkg.close()
        pkg.configure(None)
        pkg.reset()
        pkg.drain_traces()
        pkg.reset_slo()
        pkg.reset_timeline()
    # The snapshot's plan_cache_hit_rate and serve latency percentiles
    # read process-wide state (the plan counters, the serve layer's
    # latency reservoir), which earlier tests in this process may have
    # moved.
    for plans in (JPLANS, TPLANS):
        plans.reset()
    for server in (JSERVER, TSERVER):
        server._LATENCIES.clear()
    yield
    for pkg in (telemetry, JT):
        pkg.close()
        pkg.configure(None)
        pkg.reset()
        pkg.drain_traces()
        pkg.reset_slo()
        pkg.reset_timeline()


@pytest.fixture
def traced(monkeypatch, tmp_path):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.configure(tmp_path)
    return tmp_path


def _ledger():
    telemetry.flush()
    with open(telemetry.ledger_path(), encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


# -- traces and the flight recorder ---------------------------------------------


def test_trace_context_round_trip(traced):
    tctx = telemetry.mint("ls_solve", key="sys", request_id="r1", deadline_ms=50)
    assert tctx.trace_id == f"{os.getpid():x}-{int(tctx.trace_id.split('-')[1], 16):08x}"
    with telemetry.activate([tctx, None]) as live:
        assert live == [tctx]
        telemetry.trace_event("dispatch", span=7, batch_size=1)
        with telemetry.activate([]):
            telemetry.trace_event("dropped")  # no active trace on this level
    telemetry.trace_event("outside")  # no active trace at all
    telemetry.finish_trace(tctx, "ok")
    d = telemetry.get_trace(tctx.trace_id)
    assert [e["kind"] for e in d["events"]] == ["dispatch"]
    assert set(d) == {"trace_id", "op", "status", "ts", "ms", "events", "request_id", "key",
                      "deadline_ms"}
    assert (d["op"], d["status"], d["key"], d["deadline_ms"]) == ("ls_solve", "ok", "sys", 50)
    counters = telemetry.REGISTRY.snapshot()["counters"]
    assert counters["trace.minted"] == counters["trace.finished"] == 1
    assert "trace.violations" not in counters
    assert telemetry.trace_ids() == {"recent": [tctx.trace_id], "violations": []}


def test_flight_recorder_keeps_all_violations_past_capacity():
    rec = FlightRecorder(capacity=8)
    for i in range(30):
        rec.record({"trace_id": f"ok-{i}", "status": "ok"})
    rec.record({"trace_id": "bad-1", "status": "error"})
    for i in range(30, 60):
        rec.record({"trace_id": f"ok-{i}", "status": "ok"})
    assert len(rec) == 8
    assert rec.get("bad-1") is not None
    assert rec.ids()["violations"] == ["bad-1"]
    drained = rec.drain()
    assert [p["trace_id"] for p in drained["violations"]] == ["bad-1"]
    assert len(rec) == 0 and rec.get("bad-1") is None


def test_is_violating_flags_retry_and_guard_rungs():
    assert not is_violating([{"kind": "dispatch"}, {"kind": "policy"}])
    assert is_violating([{"kind": "fallback", "reason": "x"}])
    assert is_violating([{"kind": "error", "code": 108}])
    assert not is_violating([{"kind": "guard", "rung": 0}])
    assert is_violating([{"kind": "guard", "rung": 1}])


def test_trace_event_bounded_per_trace(traced):
    tctx = telemetry.mint("op")
    with telemetry.activate([tctx]):
        for i in range(200):
            telemetry.trace_event("spam", i=i)
    telemetry.finish_trace(tctx, "ok")
    payload = telemetry.get_trace(tctx.trace_id)
    assert len(payload["events"]) == 64
    assert payload["events_dropped"] == 200 - 64


def test_violating_trace_is_dumped_to_the_ledger(traced, tmp_path):
    ok, bad = telemetry.mint("op"), telemetry.mint("op")
    with telemetry.activate([bad]):
        telemetry.error_event("solve", ex.NumericalHealthError("nan", stage="x"), where="w")
    telemetry.finish_trace(ok, "ok")
    telemetry.finish_trace(bad, "error", code=108)
    ledger = _ledger()
    (err,) = [r for r in ledger if r["kind"] == "error"]
    assert err["name"] == "solve" and err["attrs"]["code"] == 108
    assert err["attrs"]["type"] == "NumericalHealthError" and err["attrs"]["where"] == "w"
    dumped = [r for r in ledger if r["kind"] == "trace"]
    assert [r["attrs"]["trace_id"] for r in dumped] == [bad.trace_id]
    assert dumped[0]["attrs"]["code"] == 108
    assert telemetry.trace_ids()["violations"] == [bad.trace_id]
    counters = telemetry.REGISTRY.snapshot()["counters"]
    assert counters["error.code.108"] == 1 and counters["trace.violations"] == 1
    assert telemetry.dump_traces(tmp_path / "traces.jsonl") == 2


def test_disabled_and_subgated_tracing_mint_nothing(monkeypatch):
    assert telemetry.mint("op") is None and not telemetry.trace_enabled()
    telemetry.error_event("x", ValueError("y"))
    telemetry.finish_trace(None, "ok")
    assert telemetry.REGISTRY.snapshot()["counters"] == {}
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    monkeypatch.setenv("SKYLARK_TRACE", "0")
    assert telemetry.mint("op") is None
    telemetry.inc("serve.requests")
    counters = telemetry.REGISTRY.snapshot()["counters"]
    assert counters == {"serve.requests": 1} and len(telemetry.RECORDER) == 0


# -- SLO budgets, the timeline and the phase clock -----------------------------------


@pytest.mark.parametrize("spec", [
    "ls_solve:50:99.9,predict@acme:20:99",
    "a:1:50, ,b:2:100,bad,c:0:50,d:1:0,e:x:5,f:1:101",
    "",
])
def test_parse_slos_matches_jax(monkeypatch, spec):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    got = [{k: o.to_dict() for k, o in mod.parse_slos(spec).items()} for mod in (TSLO, JSLO)]
    assert got[0] == got[1]
    assert (telemetry.REGISTRY.snapshot()["counters"]
            == JT.REGISTRY.snapshot()["counters"])


def test_slo_budgets_burn_and_recover_as_jax(monkeypatch, traced):
    """The same latencies through both trackers: the same reports, gauges
    and counters after each, one edge-triggered burn record and one
    recovery."""
    monkeypatch.setenv("SKYLARK_SLO", "ls_solve:10:90,ls_solve@acme:5:50")
    monkeypatch.setenv("SKYLARK_SLO_WINDOW", "20")
    lat = [1.0] * 10 + [50.0] * 6 + [1.0] * 40
    for i, ms in enumerate(lat):
        for mod in (TSLO, JSLO):
            mod.observe_slo("ls_solve", ms, tenant="acme" if i % 2 else None, shed=(i == 3))
        assert TSLO.slo_report() == JSLO.slo_report()
    snaps = [pkg.REGISTRY.snapshot() for pkg in (telemetry, JT)]
    assert snaps[0]["counters"] == snaps[1]["counters"]
    assert snaps[0]["gauges"] == snaps[1]["gauges"]
    assert snaps[0]["counters"]["slo.burns"] >= 1 and snaps[0]["counters"]["slo.recoveries"] >= 1
    burns = [r for r in _ledger() if (r["kind"], r["name"]) == ("slo", "burn")]
    assert len(burns) == snaps[0]["counters"]["slo.burns"]
    assert telemetry.snapshot()["slo"]["objectives"] == TSLO.slo_report()


def test_timeline_windows_match_jax(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    for pkg in (telemetry, JT):
        pkg.enable_buckets("serve.latency_ms")
        assert pkg.timeline_tick() is False  # the first tick baselines
        for ms in (0.3, 3.0, 30.0, 30.0):
            pkg.observe("serve.latency_ms", ms)
        pkg.inc("serve.requests", 4)
        pkg.inc("serve.cache.hit", 1)
        pkg.inc("serve.cache.miss", 3)
        pkg.set_gauge("q", 2)
        assert pkg.timeline_tick({"queue_depth": 5}, force=True) is True
    windows = [pkg.timeline_windows() for pkg in (telemetry, JT)]
    def strip(w):  # the clock's fields: the window's time, its length and qps = requests / dt
        return dict({k: v for k, v in w.items() if k not in ("ts", "dt_s", "derived")},
                    derived={k: v for k, v in w["derived"].items() if k != "qps"})

    assert [strip(w) for w in windows[0]] == [strip(w) for w in windows[1]]
    (w,) = windows[0]
    assert w["derived"]["qps"] > 0
    assert w["derived"]["cache_hit_rate"] == 0.25 and w["derived"]["queue_depth"] == 5
    assert w["derived"]["p99_ms"] == 50.0 and w["histograms"]["serve.latency_ms"]["count"] == 4
    state = telemetry.timeline_state()
    assert state["interval_s"] == 5.0 and state["capacity"] == 120 and state["windows"] == windows[0]
    le, counts = [1.0, 10.0, 100.0], [3, 0, 1, 2]
    assert TTL.bucket_quantile(le, counts, 0.5) == JTL.bucket_quantile(le, counts, 0.5) == 1.0
    assert TTL.bucket_quantile(le, counts, 0.99) == JTL.bucket_quantile(le, counts, 0.99)
    assert TTL.bucket_quantile(le, [0, 0, 0, 0], 0.5) is None


def test_phase_clock_matches_jax(monkeypatch):
    assert telemetry.PHASES == JT.PHASES
    assert not telemetry.phases_enabled()
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    assert telemetry.phases_enabled()
    monkeypatch.setenv("SKYLARK_PHASES", "0")
    assert not telemetry.phases_enabled()
    for pkg in (telemetry, JT):
        pkg.enable_phase_buckets()
        pkg.observe_phase("device_execute", 3.0)
        pkg.observe_phase("collective_wait", 0.2)
    assert telemetry.REGISTRY.snapshot()["histograms"] == JT.REGISTRY.snapshot()["histograms"]


# -- exposition and the fleet folds ---------------------------------------------------


def _rich_snapshot():
    return {
        "counters": {"serve.requests": 12, "serve.ok": 11, "a-b": 1, "a.b": 2, "9lives": 3,
                     "serve.tenant.acme.requests": 4, "serve.tenant.b-2.requests": 5,
                     "stream.rows": 1e16},
        "gauges": {"serve.queue_depth": 0, "stream.rows_per_s": 123.456, "label": "x",
                   "slo.budget_remaining.ls_solve": 0.75, "slo.budget_remaining.p@a": -1.0},
        "histograms": {
            "serve.latency_ms": {"count": 3, "sum": 6.5, "min": 0.5, "max": 4.0,
                                 "buckets": {"le": [1.0, 5.0], "counts": [1, 2, 0],
                                             "count": 3, "sum": 6.5}},
            "span.x.seconds": {"count": 2, "sum": 0.25, "min": 0.1, "max": 0.15},
            "serve.tenant.acme.latency_ms": {"count": 1, "sum": 2.0, "min": 2.0, "max": 2.0},
        },
        "plans": {"hits": 3, "misses": 1, "compile_seconds": 0.5, "bytes": 4096},
        "plan_cache_hit_rate": 0.75, "prefetch_overlap": None, "overlap_efficiency": 0.9,
        "serve": {"coalesce_ratio": 0.5, "latency_p50_ms": 1.5, "latency_p99_ms": 4.0},
        "world": 2,
    }


def test_prometheus_text_is_byte_identical_to_jax(monkeypatch):
    snap = _rich_snapshot()
    text = telemetry.prometheus_text(snap, extra_gauges={"serve.queue_depth": 3})
    assert text == JT.prometheus_text(snap, extra_gauges={"serve.queue_depth": 3})
    assert "# TYPE skylark_serve_requests_total counter" in text
    assert 'skylark_serve_tenant_requests_total{tenant="b-2"} 5' in text
    assert 'skylark_serve_latency_ms_bucket{le="+Inf"} 3' in text
    assert 'skylark_slo_budget_remaining{objective="p@a"} -1' in text
    # The same registry contents through each package's own snapshot.
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    for pkg in (telemetry, JT):
        pkg.enable_buckets("serve.latency_ms")
        pkg.inc("serve.requests", 2)
        pkg.inc("stream.rows", 4096)
        pkg.observe("serve.latency_ms", 2.0)
        pkg.set_gauge("stream.rows_per_s", 1.5)
    snaps = [{k: v for k, v in pkg.snapshot().items() if k != "plans"} for pkg in (telemetry, JT)]
    assert telemetry.prometheus_text(snaps[0]) == JT.prometheus_text(snaps[1])
    for line in telemetry.prometheus_text().splitlines():
        assert line.startswith("#") or (len(line.split()) == 2 and line.startswith("skylark_"))


def test_merge_snapshots_matches_jax_and_sums_counters(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    per_rank = []
    for rank in range(3):
        telemetry.reset()
        telemetry.enable_buckets("serve.latency_ms", [5.0, 50.0] if rank < 2 else [1.0])
        for _ in range(rank + 1):
            telemetry.inc("serve.requests")
            telemetry.inc("guard.attempts")
        telemetry.inc("prefetch.hits", rank)
        telemetry.inc("prefetch.waits", 1)
        telemetry.observe("serve.latency_ms", 10.0 * (rank + 1))
        telemetry.set_gauge("rank", rank)
        per_rank.append(telemetry.snapshot())
    merged = telemetry.merge_snapshots(per_rank)
    assert merged == JT.merge_snapshots(per_rank)
    assert merged["world"] == 3
    for key in ("serve.requests", "guard.attempts", "prefetch.hits"):
        assert merged["counters"][key] == sum(s["counters"].get(key, 0) for s in per_rank)
    h = merged["histograms"]["serve.latency_ms"]
    assert (h["count"], h["sum"], h["min"], h["max"]) == (3, 60.0, 10.0, 30.0)
    assert "buckets" not in h  # mismatched bounds drop the buckets
    assert merged["gauges_by_rank"]["rank"] == {0: 0, 1: 1, 2: 2}
    assert merged["prefetch_overlap"] == 0.5


def test_fleet_snapshot_single_process_and_larger_worlds(monkeypatch, tmp_path):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.inc("serve.requests", 7)
    fleet = telemetry.snapshot(fleet=True)
    assert fleet["world"] == 1 and fleet["counters"]["serve.requests"] == 7
    assert "hosts" not in fleet
    monkeypatch.setenv("SKYLARK_TELEMETRY_FLEET_ROOT", str(tmp_path))
    assert telemetry.snapshot(fleet=True)["hosts"]["ranks"] == {}
    # A world of 2 (the gather stood in for: real worlds are in
    # tests/test_torch_distributed_world.py): counters sum over the ranks.
    from libskylark_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives, "gather_objects", lambda obj: [obj, obj])
    fleet2 = telemetry.snapshot(fleet=True)
    assert fleet2["world"] == 2 and fleet2["counters"]["serve.requests"] == 14
    monkeypatch.setattr(collectives, "gather_objects",
                        lambda obj: [obj, {**obj, "counters": {"other": 1}}])
    with pytest.raises(RuntimeError, match="different counter-name sets"):
        telemetry.snapshot(fleet=True)


def _write_jax_progress(root):
    """Progress ledgers and an epoch marker written by the JAX package's
    own elastic writers: epoch-0 records from two hosts, then an epoch-1
    world where only rank 0 survived."""
    from libskylark_tpu.streaming import elastic, repartition

    for epoch, ranks, rows in ((0, (0, 1), 100), (1, (0,), 250)):
        for rank in ranks:
            d = elastic.host_dir(root, rank, epoch)
            os.makedirs(d, exist_ok=True)
            led = elastic.HostLedger(os.path.join(d, elastic.PROGRESS_NAME), rank=rank,
                                     epoch=epoch)
            for _ in range(3):
                led.record("fold", rows=rows, batches=1)
            led.close()
    return repartition


def test_fold_ledgers_matches_jax_on_jax_written_files(tmp_path):
    _write_jax_progress(tmp_path)
    fold = telemetry.fold_ledgers(tmp_path)
    assert fold == JT.fold_ledgers(tmp_path)
    assert fold["epoch"] == 1 and set(fold["ranks"]) == {0}
    assert fold["rows_total"] == 3 * 250 and fold["stale_records"] == 6
    assert all(rec["attrs"]["epoch"] == 1 for rec in fold["timeline"])
    empty = telemetry.fold_ledgers(tmp_path / "nothing")
    assert empty == JT.fold_ledgers(tmp_path / "nothing")
    assert empty["ranks"] == {} and empty["rows_total"] == 0


def test_fold_ledgers_follows_the_jax_epoch_marker(tmp_path):
    """An ``epoch.json`` written by the JAX package's repartition layer
    fences the fold to its epoch, in both packages."""
    import libskylark_tpu as J

    repartition = _write_jax_progress(tmp_path)
    partition = J.streaming.RowPartition(nrows=1000, batch_rows=100, world_size=1)
    repartition.write_epoch(tmp_path, epoch=0, partition=partition, kind="distributed_sketch")
    fold = telemetry.fold_ledgers(tmp_path)
    assert fold == JT.fold_ledgers(tmp_path)
    assert fold["epoch"] == 0 and set(fold["ranks"]) == {0, 1}
    assert fold["stale_records"] == 3
    assert tfleet.read_epoch(tmp_path) == repartition.read_epoch(tmp_path)


def test_private_readers_match_the_jax_ones_on_torn_files(tmp_path):
    from libskylark_tpu.streaming import elastic, repartition

    assert tfleet.PROGRESS_NAME == elastic.PROGRESS_NAME
    assert tfleet.EPOCH_NAME == repartition.EPOCH_NAME
    path = tmp_path / "progress.jsonl"
    recs = [{"seq": 2, "attrs": {"epoch": 0, "rows": 1}}, {"seq": 1, "attrs": {"epoch": 0}},
            {"seq": 2, "attrs": {"epoch": 0, "rows": 9}}, {"attrs": {"epoch": 1}},
            {"seq": 1, "attrs": {"epoch": 1}}, [1, 2]]
    with open(path, "w", encoding="utf-8") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
        fh.write('{"seq": 3, "att')  # a torn tail
    assert tfleet.read_progress(path) == elastic.read_progress(path)
    assert [r.get("seq") for r in tfleet.read_progress(path)] == [1, 2, 1, None]
    assert tfleet.read_progress(tmp_path / "missing.jsonl") == []
    (tmp_path / "epoch.json").write_text("{not json")
    assert tfleet.read_epoch(tmp_path) is None is repartition.read_epoch(tmp_path)


def test_profiling_trace_and_annotate(tmp_path):
    """``utils.profiling``: a trace writes a Chrome trace whose events
    carry the ``annotate`` regions (context manager and decorator)."""
    from libskylark_tpu_torch.utils import profiling

    @profiling.annotate("skylark.decorated")
    def work(x):
        return x @ x

    with profiling.trace(str(tmp_path)):
        with profiling.annotate("skylark.region"):
            work(torch.ones(8, 8))
        work(torch.ones(4, 4))
    (path,) = list(tmp_path.glob("trace-*.json"))
    names = {ev.get("name") for ev in json.loads(path.read_text())["traceEvents"]}
    assert {"skylark.region", "skylark.decorated"} <= names
