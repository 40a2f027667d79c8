"""Port vs JAX package: the telemetry layer (``libskylark_tpu_torch/
telemetry``: registry, ledger, spans, snapshot/run_summary/report) and its
wiring into the port's call sites, on the CPU.

- The registry, the ledger's schema and the span tree are held to the
  JAX package's tests (``tests/test_telemetry.py``) and to the JAX
  registry fed the same calls; the disabled path allocates nothing,
  waits for nothing and registers no ``atexit`` hook; a span never
  waits for the card, inside a CUDA graph capture or outside one
  (``tests/test_torch_spans.py`` holds the rest of the span contract).
- The acceptance run of ``tests/test_telemetry.py`` (guarded streaming
  least squares of a rank-deficient A with ``FaultPlan(bad_sketch_at=1)``)
  passes the JAX assertions on the port's ledger, and its ``(kind,
  name)`` sequence and counters equal the JAX ledger's.  The JAX side
  runs with ``SKYLARK_NO_PLANS=1`` (its plan path needs
  ``jax.core.trace_state_clean``, which the installed jax lacks); the
  port runs its default, planned path.  So the comparisons leave out the
  plans layer's events (kind ``plan``) and counters (``plans.*``) and the
  spans only the port opens (``telemetry.SPANS`` but the streaming and
  training ones: ``sketch.apply``, ``random.sample``, ... and their
  ``span.<name>.*`` counters), and compare the
  timing counters (``*seconds*``, ``prefetch.hits``/``waits``/``produced``,
  which depend on the producer thread's timing) and ``checkpoint.bytes``
  (the container's size) by name only.
- Telemetry off ≡ on, bitwise: x and info of the same calls.
- Static contracts (the port's copies of
  ``tests/test_review_regressions.py:187-230, 273-300``): every ``(x,
  info)`` entry point emits ``telemetry.run_summary`` (or delegates to a
  layer that does), ``run_summary`` flushes the policy store before its
  gate, and a routed run writes its observation to the store exactly
  once.

Every test resets the process-wide state it touches (registry, ledger
handle, flight recorder) and writes only under ``tmp_path``.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import telemetry as JT
from libskylark_tpu_torch import plans, telemetry
from libskylark_tpu_torch.streaming import StreamParams, pinned_placer
from libskylark_tpu_torch.telemetry import spans as tspans

pytestmark = pytest.mark.telemetry

N, D, BATCH = 96, 6, 12  # 8 batches per pass (tests/test_telemetry.py)
# Compared by name only: they follow the producer thread's timing, and a
# checkpoint's file size (the npz container's own bytes) is no contract.
TIMING = ("prefetch.hits", "prefetch.waits", "prefetch.produced", "checkpoint.bytes")
# The spans only the port opens (the JAX package's are the streaming and
# training ones).
PORT_SPANS = set(telemetry.SPANS) - {"stream.chunk", "train.stream", "train.factor",
                                     "train.iterate"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in ("SKYLARK_TELEMETRY", "SKYLARK_TELEMETRY_DIR", "SKYLARK_NO_PLANS",
                 "SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX",
                 "SKYLARK_POLICY_DIR", "SKYLARK_TRACE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # the JAX side's x64 accumulators
    for pkg in (telemetry, JT):
        pkg.close()
        pkg.configure(None)
        pkg.reset()
    plans.clear()
    yield
    for pkg in (telemetry, JT):
        pkg.close()
        pkg.configure(None)
        pkg.reset()
        pkg.drain_traces()
    plans.clear()
    torch.set_default_dtype(old)


@pytest.fixture
def ledger_dir(tmp_path, monkeypatch):
    """Telemetry ON with a fresh port ledger in tmp_path."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.configure(tmp_path / "port")
    return tmp_path


def _read(pkg):
    pkg.flush()
    path = pkg.ledger_path()
    assert path is not None, "no ledger file was opened"
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


def _kinds(events):
    return [(e["kind"], e["name"]) for e in events
            if e["kind"] != "plan" and e["name"] not in PORT_SPANS]


def _counters(snap):
    """Counter values comparable across the packages: the plans layer's
    and the port's own spans' left out, timing counters by name only."""
    out = {}
    for k, v in snap["counters"].items():
        if k.startswith("plans.") or (
                k.startswith("span.") and k[5:].rsplit(".", 1)[0] in PORT_SPANS):
            continue
        out[k] = None if ("seconds" in k or k in TIMING) else v
    return out


# -- registry -------------------------------------------------------------------


def test_all_is_the_jax_all():
    assert telemetry.__all__ == JT.__all__
    assert "telemetry" in T.__all__


def test_counters_gauges_histograms_match_jax(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    snaps = []
    for pkg in (telemetry, JT):
        pkg.enable_buckets("lat", [1.0, 10.0])
        pkg.inc("a.calls")
        pkg.inc("a.calls", 2)
        pkg.set_gauge("g", 1.5)
        for v in (2.0, 4.0, 0.5, 50.0):
            pkg.observe("h", v)
            pkg.observe("lat", v)
        snaps.append(pkg.REGISTRY.snapshot())
    assert snaps[0] == snaps[1]
    snap = telemetry.snapshot()
    assert snap["counters"]["a.calls"] == 3 and snap["gauges"]["g"] == 1.5
    h = snap["histograms"]["h"]
    assert (h["count"], h["sum"], h["min"], h["max"]) == (4, 56.5, 0.5, 50.0)
    assert snap["histograms"]["lat"]["buckets"] == {
        "le": [1.0, 10.0], "counts": [1, 2, 1], "count": 4, "sum": 56.5}


def test_registry_is_thread_safe(monkeypatch):
    """16 threads (more than the cores) bump one counter and observe one
    histogram under a short switch interval: no update is lost."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [(telemetry.inc("c"), telemetry.observe("h", 1))
                                                    for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    snap = telemetry.REGISTRY.snapshot()
    assert snap["counters"]["c"] == threads * per
    assert snap["histograms"]["h"]["count"] == threads * per


def test_disabled_path_is_inert(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.inc("a.calls")
    monkeypatch.setenv("SKYLARK_TELEMETRY", "0")
    telemetry.inc("a.calls")
    telemetry.set_gauge("g", 9)
    telemetry.observe("h", 9)
    assert telemetry.span("x") is telemetry.NOOP_SPAN
    with telemetry.span("x") as sp:
        assert sp is telemetry.NOOP_SPAN  # holds nothing: no result, no attrs
        with pytest.raises(AttributeError):
            sp.result = torch.ones(3)
    assert telemetry.event("k", "n", {"a": 1}) is None
    assert telemetry.emit("k", "n", a=1) is None
    assert telemetry.run_summary("n", {"a": 1}) is None
    assert telemetry.mint("op") is None
    snap = telemetry.snapshot()
    assert snap["counters"]["a.calls"] == 1
    assert "g" not in snap["gauges"] and "h" not in snap["histograms"]


def test_disabled_telemetry_registers_no_atexit_hooks():
    """The port's copy of ``tests/test_review_regressions.py:233-270``:
    importing the port and emitting disabled-path events adds nothing to
    the ``atexit`` table (the ledger registers its hook only when a file
    opens).  A fresh process that imports torch, not JAX."""
    code = (
        "import os\n"
        "os.environ['SKYLARK_TELEMETRY'] = '0'\n"
        "os.environ.pop('SKYLARK_TELEMETRY_DIR', None)\n"
        "import atexit\n"
        "import libskylark_tpu_torch\n"
        "from libskylark_tpu_torch import telemetry\n"
        "base = atexit._ncallbacks()\n"
        "telemetry.emit('probe', 'noop', k=1)\n"
        "telemetry.inc('noop.counter')\n"
        "with telemetry.span('noop.span'):\n"
        "    pass\n"
        "assert telemetry.ledger_path() is None, telemetry.ledger_path()\n"
        "assert atexit._ncallbacks() == base, (base, atexit._ncallbacks())\n"
        "import sys\n"
        "assert 'jax' not in sys.modules\n"
        "print('ZERO-ATEXIT-OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=110, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ZERO-ATEXIT-OK" in out.stdout


def test_report_reuses_timer_table(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.inc("x.count", 5)
    telemetry.set_gauge("rate", 2.5)
    telemetry.set_gauge("label", "not a number")
    rep = telemetry.report()
    assert "x.count" in rep and "gauge.rate" in rep and "gauge.label" not in rep
    # Without a process group the collective table is over one process
    # (tests/test_torch_distributed_world.py gathers real worlds).
    dist_rep = telemetry.report(distributed=True)
    assert "over 1 process)" in dist_rep and "x.count" in dist_rep


# -- ledger and spans -----------------------------------------------------------


def test_span_nesting_and_schema(ledger_dir):
    with telemetry.span("outer", stage="t"):
        with telemetry.span("inner") as si:
            si.attrs["late"] = 1
    events = _read(telemetry)
    for ev in events:
        assert set(ev) == {"ts", "seq", "pid", "kind", "name", "attrs"}
        assert ev["pid"] == os.getpid()
    assert os.path.basename(telemetry.ledger_path()) == f"ledger-{os.getpid()}.jsonl"
    seqs = [ev["seq"] for ev in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert [(ev["kind"], ev["name"]) for ev in events] == [
        ("span_start", "outer"), ("span_start", "inner"),
        ("span_end", "inner"), ("span_end", "outer")]
    outer_start, inner_start, inner_end, outer_end = events
    assert "parent" not in outer_start["attrs"] and outer_start["attrs"]["depth"] == 0
    assert inner_start["attrs"]["parent"] == outer_start["seq"]
    assert inner_start["attrs"]["depth"] == 1
    assert inner_end["attrs"]["late"] == 1  # amended inside the region
    assert inner_end["attrs"]["span"] == inner_start["seq"]
    assert outer_end["attrs"]["stage"] == "t" and outer_end["attrs"]["seconds"] >= 0
    snap = telemetry.snapshot()
    assert snap["counters"]["span.outer.calls"] == 1
    assert snap["counters"]["span.inner.calls"] == 1


def test_span_records_the_error(ledger_dir):
    with pytest.raises(KeyError):
        with telemetry.span("boom"):
            raise KeyError("x")
    end = _read(telemetry)[-1]
    assert (end["kind"], end["name"]) == ("span_end", "boom")
    assert end["attrs"]["error"] == "KeyError"
    assert tspans._stack() == []


def test_numpy_and_tensor_attrs_coerce_to_json(ledger_dir):
    telemetry.emit("probe", "coerce", i=np.int64(3), f=np.float32(1.5), a=np.arange(2),
                   t0=torch.tensor(2.5), t1=torch.arange(3), tb=torch.ones(2, dtype=torch.bfloat16),
                   b=np.bool_(True), dt=torch.float32)
    (ev,) = _read(telemetry)
    assert ev["attrs"] == {"i": 3, "f": 1.5, "a": [0, 1], "t0": 2.5, "t1": [0, 1, 2],
                           "tb": [1.0, 1.0], "b": True, "dt": "torch.float32"}


def test_no_directory_means_no_file(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    seq1 = telemetry.emit("probe", "nofile", k=1)
    seq2 = telemetry.emit("probe", "nofile", k=2)
    assert seq1 is not None and seq2 == seq1 + 1
    assert telemetry.ledger_path() is None


def test_configure_reopens_in_the_new_directory(ledger_dir):
    telemetry.emit("probe", "first")
    first = telemetry.ledger_path()
    telemetry.configure(ledger_dir / "other")
    assert telemetry.ledger_path() is None  # the old sink closed
    telemetry.emit("probe", "second")
    assert telemetry.ledger_path() != first
    assert os.path.dirname(telemetry.ledger_path()) == str(ledger_dir / "other")


def test_span_raises_instead_of_waiting_inside_a_capture(monkeypatch):
    """A span never waits for the card, so it is legal inside a CUDA graph
    capture: with telemetry on, in a (simulated) capture and out of one,
    no span raises, synchronizes a stream or a device, or records a CUDA
    event, and it still writes its ledger events (the CPU stands in for
    a capturing card here)."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: waits.append("device"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: waits.append("stream"))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: waits.append("event"))
    for capturing in (True, False):
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
        with telemetry.span("captured") as sp:
            assert not hasattr(sp, "result")
            acc = torch.ones(2) * 2
    assert waits == []
    assert float(acc.sum()) == 4.0
    snap = telemetry.snapshot()
    assert snap["counters"]["span.captured.calls"] == 2


# -- snapshot, run_summary and the static contracts -------------------------------


def test_snapshot_key_set_is_the_jax_one(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    keys = []
    for pkg in (telemetry, JT):
        keys.append(set(pkg.snapshot()))
        for name in ("guard.initial", "checkpoint.saves", "policy.decisions", "serve.requests",
                     "router.placements", "autoscale.ticks", "registry.epoch.bumps",
                     "train.runs", "slo.observed", "timeline.ticks", "prefetch.hits"):
            pkg.inc(name)
        keys.append(set(pkg.snapshot()))
    assert keys[0] == keys[2] and keys[1] == keys[3]
    snap = telemetry.snapshot()
    assert snap["plans"] == plans.stats()
    for group in ("guard", "checkpoint", "policy", "router", "train"):
        assert snap[group], group


def test_solver_entrypoints_emit_run_summary():
    """Every public ``(x, info)`` solver entry point emits a terminal
    ``telemetry.run_summary`` carrying its ``info`` — or delegates to the
    layer that does (the port's copy of
    ``tests/test_review_regressions.py:187-230``)."""
    from libskylark_tpu_torch.linalg.least_squares import (
        approximate_least_squares,
        streaming_least_squares,
    )
    from libskylark_tpu_torch.ml.krr import (
        approximate_kernel_ridge,
        streaming_approximate_kernel_ridge,
    )
    from libskylark_tpu_torch.solvers.accelerated import (
        faster_least_squares,
        lsrn_least_squares,
    )
    from libskylark_tpu_torch.streaming.drivers import kernel_ridge, sketch_least_squares

    for fn in (approximate_least_squares, streaming_least_squares, faster_least_squares,
               lsrn_least_squares, sketch_least_squares, kernel_ridge,
               approximate_kernel_ridge, streaming_approximate_kernel_ridge):
        src = inspect.getsource(fn)
        assert "telemetry.run_summary(" in src or (
            "sketch_least_squares" in src or "kernel_ridge(" in src), (
            f"{fn.__module__}.{fn.__name__} returns (x, info) but never emits a "
            "terminal telemetry.run_summary (or delegates to a layer that does)")
    # No routed entry point flushes the store by hand any more, except
    # streaming LS after its driver's run_summary (the JAX package's order).
    for mod in ("linalg.least_squares", "ml.krr", "solvers.accelerated"):
        src = inspect.getsource(importlib.import_module(f"libskylark_tpu_torch.{mod}"))
        assert src.count("policy.flush(") == (1 if mod == "linalg.least_squares" else 0)


def test_run_summary_flushes_policy_before_its_gate():
    """The port's copy of ``tests/test_review_regressions.py:273-300``."""
    report = importlib.import_module("libskylark_tpu_torch.telemetry.report")
    snap_src = inspect.getsource(report.snapshot)
    assert '"policy"' in snap_src and "policy." in snap_src
    rs_src = inspect.getsource(report.run_summary)
    flush_at = rs_src.find("policy.flush")
    gate_at = rs_src.find("config.enabled()")
    assert flush_at != -1 and (gate_at == -1 or flush_at < gate_at)


def _store_runs(directory):
    [path] = [p for p in os.listdir(directory) if p.startswith("profile-")]
    with open(os.path.join(directory, path), encoding="utf-8") as fh:
        doc = json.load(fh)
    return {k: v["runs"] for k, v in doc["payload"]["entries"].items()}


@pytest.mark.parametrize("telemetry_on", [False, True])
def test_a_run_flushes_its_observation_exactly_once(tmp_path, monkeypatch, telemetry_on, rng):
    """With telemetry off or on, each routed call writes its observation to
    the store once: one run per call, one profile write per call."""
    monkeypatch.setenv("SKYLARK_POLICY", "1")
    if telemetry_on:
        monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    T.policy.configure(tmp_path / "store")
    T.policy.reset()
    try:
        A = torch.from_numpy(rng.standard_normal((400, 6)))
        b = torch.from_numpy(rng.standard_normal(400))
        for _ in range(2):
            T.linalg.approximate_least_squares(A, b, T.SketchContext(seed=1))
        X = torch.from_numpy(rng.standard_normal((64, 3)))
        T.ml.approximate_kernel_ridge(T.ml.GaussianKernel(3, sigma=2.0), X, X[:, 0], 0.1, 32,
                                      T.SketchContext(seed=2))

        def factory(start):
            for i in range(start, 4):
                yield A[100 * i:100 * (i + 1)], b[100 * i:100 * (i + 1)]

        T.linalg.streaming_least_squares(
            factory, 400, 6, T.SketchContext(seed=3),
            stream_params=StreamParams(placer=pinned_placer("cpu")))
        runs = _store_runs(tmp_path / "store")
    finally:
        T.policy.configure(None)
        T.policy.reset()
    assert sorted(runs.values()) == [1, 1, 2], runs
    if telemetry_on:
        # A write per call, and streaming LS's driver's run_summary writes
        # the planned steps' records before its observation exists.
        assert telemetry.snapshot()["counters"]["policy.profile_writes"] >= 4


# -- the acceptance run ------------------------------------------------------------


def _problem(rng_seed=7):
    rng = np.random.default_rng(rng_seed)
    A = rng.standard_normal((N, D))
    A[:, -1] = A[:, 0]  # rank-deficient: certify_sketch says RESKETCH
    b = rng.standard_normal(N)
    return A, b


def _batches(A, b, conv):
    def factory(start):
        for i in range(start, N // BATCH):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            yield conv(A[sl]), conv(b[sl])

    return factory


def _port_run(fault=None, **kw):
    A, b = _problem()
    return T.linalg.streaming_least_squares(
        _batches(A, b, torch.from_numpy), N, D, T.SketchContext(seed=3),
        stream_params=StreamParams(placer=pinned_placer("cpu"), **kw),
        fault_plan=T.resilient.FaultPlan(**(fault or {"bad_sketch_at": 1})))


def _jax_run(fault=None, **kw):
    A, b = _problem()
    return J.linalg.streaming_least_squares(
        _batches(A, b, lambda a: a), N, D, J.SketchContext(seed=3),
        stream_params=J.streaming.StreamParams(**kw),
        fault_plan=J.resilient.FaultPlan(**(fault or {"bad_sketch_at": 1})))


def _jax_side(monkeypatch, fn, *args, **kw):
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")
    try:
        return fn(*args, **kw)
    finally:
        monkeypatch.delenv("SKYLARK_NO_PLANS")


@pytest.mark.streaming
@pytest.mark.guard
def test_acceptance_ledger_passes_the_jax_assertions_and_equals_jax(ledger_dir, monkeypatch):
    monkeypatch.setenv("SKYLARK_GUARD", "1")
    x, info = _port_run()
    events = _read(telemetry)
    kinds = {(e["kind"], e["name"]) for e in events}
    # tests/test_telemetry.py:185-230, on the port's ledger.
    assert ("span_start", "stream.chunk") in kinds and ("span_end", "stream.chunk") in kinds
    chunk_ends = [e for e in events if e["kind"] == "span_end" and e["name"] == "stream.chunk"]
    assert chunk_ends and all("rows" in e["attrs"] for e in chunk_ends)
    assert sum(e["attrs"]["rows"] for e in chunk_ends) == N
    assert len([e for e in events if e["kind"] == "guard" and e["name"] == "replay"]) == 1
    initial = [e for e in events if e["kind"] == "guard" and e["name"] == "initial"]
    assert initial and initial[-1]["attrs"]["verdict"] == "RESKETCH"
    assert any(e["kind"] == "guard" and e["name"] == "fallback" for e in events)
    summaries = [e for e in events if e["kind"] == "run_summary"]
    assert len(summaries) == 1 and summaries[0]["name"] == "streaming_lsq"
    assert summaries[0]["seq"] == max(e["seq"] for e in events)
    payload = summaries[0]["attrs"]
    assert set(payload["info"]) == set(info)
    assert payload["info"]["recovery"] == info["recovery"]
    assert payload["info"]["rows"] == N
    assert payload["snapshot"]["plans"] == plans.stats()
    assert payload["snapshot"]["guard"].get("replay") == 1
    assert payload["snapshot"]["counters"]["stream.replays"] == 1
    # ... and equal to the JAX package's ledger of the same run.
    JT.configure(ledger_dir / "jax")
    xj, info_j = _jax_side(monkeypatch, _jax_run)
    jevents = _read(JT)
    assert _kinds(events) == _kinds(jevents)
    assert _counters(payload["snapshot"]) == _counters(jevents[-1]["attrs"]["snapshot"])
    assert set(payload["snapshot"]) == set(jevents[-1]["attrs"]["snapshot"])
    assert [a["action"] for a in info["recovery"]["attempts"]] == [
        a["action"] for a in info_j["recovery"]["attempts"]]
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


@pytest.mark.streaming
def test_checkpoint_events_and_counters_match_jax(tmp_path, monkeypatch):
    """The runner's ``checkpoint`` save/restore events and counters, on a
    killed and resumed checkpointed stream, equal the JAX package's."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    runs = []
    for tag, pkg, run in (("port", telemetry, _port_run), ("jax", JT, _jax_run)):
        pkg.configure(tmp_path / tag)
        ck = dict(checkpoint_dir=str(tmp_path / f"ck_{tag}"), checkpoint_every=2)
        call = (lambda f: f()) if tag == "port" else (lambda f: _jax_side(monkeypatch, f))
        with pytest.raises(Exception, match="injected preemption"):
            call(lambda: run({"preempt_after_chunk": 1}, **ck))
        call(lambda: run({}, resume=True, **ck))
        events = _read(pkg)
        runs.append((_kinds(events), _counters(pkg.snapshot())))
        saved = [e["attrs"]["bytes"] for e in events if (e["kind"], e["name"]) == ("checkpoint", "save")]
        assert pkg.snapshot()["counters"]["checkpoint.bytes"] == sum(saved) > 0
        pkg.close()
        pkg.configure(None)
    assert runs[0] == runs[1]
    kinds = runs[0][0]
    assert kinds.count(("checkpoint", "save")) == runs[0][1]["checkpoint.saves"] > 0
    assert kinds.count(("checkpoint", "restore")) == runs[0][1]["checkpoint.restores"] == 1


@pytest.mark.guard
@pytest.mark.parametrize("stype", ["FJLT", "CWT"])
def test_guard_ladder_events_match_jax(tmp_path, monkeypatch, rng, stype):
    """A bad first sketch climbs the ladder: the same ``guard`` events,
    trace events and counters as the JAX package's."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    A = rng.standard_normal((300, 5))
    b = rng.standard_normal(300)
    got = []
    for tag, pkg, mod, conv in (("port", telemetry, T, torch.from_numpy),
                                ("jax", JT, J, jnp.asarray)):
        pkg.configure(tmp_path / tag)
        tctx = pkg.mint("ls_solve")

        def call():
            with pkg.activate([tctx]):
                return mod.linalg.approximate_least_squares(
                    conv(A), conv(b), mod.SketchContext(seed=5),
                    mod.linalg.LeastSquaresParams(sketch_type=stype),
                    fault_plan=mod.resilient.FaultPlan(bad_sketch_at=0), return_info=True)

        _, info = call() if tag == "port" else _jax_side(monkeypatch, call)
        events = _read(pkg)
        trace = [e["kind"] for e in tctx.events if e["kind"] != "plan"]
        got.append((_kinds(events), _counters(pkg.snapshot()), trace,
                    [a["action"] for a in info["recovery"]["attempts"]]))
        # The run's last event but the port's own spans (``ls.solve``
        # closes after the run_summary it encloses).
        last = [e for e in events if e["name"] not in PORT_SPANS][-1]
        assert last["kind"] == "run_summary"
        assert set(last["attrs"]["info"]) == set(info)
        pkg.close()
        pkg.configure(None)
    assert got[0] == got[1]
    assert got[0][3][:2] == ["initial", "resketch"]
    assert got[0][2][:2] == ["policy", "guard"]


@pytest.mark.policy
def test_policy_counters_and_warm_start_match_jax(tmp_path, monkeypatch, rng):
    """``policy.decisions``, ``profile_misses``/``hits``, the routes and
    ``profile_writes`` count as the JAX package counts them over the same
    calls (a store per package), and the warm start is a ``policy`` /
    ``warm_start`` event with ``policy.warm_plans``."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    monkeypatch.setenv("SKYLARK_POLICY", "1")
    A = rng.standard_normal((400, 6))
    b = rng.standard_normal(400)
    got = []
    for tag, pkg, mod, conv in (("port", telemetry, T, torch.from_numpy),
                                ("jax", JT, J, jnp.asarray)):
        mod.policy.configure(tmp_path / f"store_{tag}")
        mod.policy.reset()
        pkg.configure(tmp_path / tag)
        try:
            def calls():
                for seed in range(4):
                    mod.linalg.approximate_least_squares(conv(A), conv(b),
                                                         mod.SketchContext(seed=seed))
                mod.policy.invalidate_cache()
                mod.linalg.approximate_least_squares(conv(A), conv(b), mod.SketchContext(seed=9),
                                                     route="exact")

            calls() if tag == "port" else _jax_side(monkeypatch, calls)
            snap = pkg.snapshot()
            got.append({k: v for k, v in snap["policy"].items()})
        finally:
            mod.policy.configure(None)
            mod.policy.reset()
            pkg.close()
            pkg.configure(None)
    assert got[0] == got[1]
    assert got[0]["decisions"] == 5 and got[0]["profile_misses"] >= 3
    assert got[0]["route.exact"] == 1
    # The warm start from a store that lists a plan.
    telemetry.reset()
    telemetry.configure(tmp_path / "warm")
    T.policy.configure(tmp_path / "store_warm")
    T.policy.reset()
    try:
        T.linalg.approximate_least_squares(torch.from_numpy(A), torch.from_numpy(b),
                                           T.SketchContext(seed=1))
        plans.clear()
        summary = T.policy.warm_start(device="cpu")
    finally:
        T.policy.configure(None)
        T.policy.reset()
    (ws,) = [e for e in _read(telemetry) if (e["kind"], e["name"]) == ("policy", "warm_start")]
    assert ws["attrs"]["plans_replayed"] == summary["plans_replayed"] > 0
    assert telemetry.snapshot()["counters"]["policy.warm_plans"] == summary["plans_replayed"]


# -- telemetry off ≡ on ------------------------------------------------------------


def _strip(info):
    """``info`` without its wall-clock seconds."""
    if isinstance(info, dict):
        return {k: _strip(v) for k, v in info.items() if k != "seconds"}
    if isinstance(info, list):
        return [_strip(v) for v in info]
    if isinstance(info, torch.Tensor):
        return info.tolist()
    return info


def _ls(stype):
    def run(A, b):
        return T.linalg.approximate_least_squares(
            A, b, T.SketchContext(seed=4), T.linalg.LeastSquaresParams(sketch_type=stype),
            return_info=True)

    return run


def _accelerated(solver):
    def run(A, b):
        return getattr(T.solvers, solver)(A, b, T.SketchContext(seed=4))

    return run


def _sparse_sjlt(A, b):
    As = A.to_sparse()

    def factory(start):
        for i in range(start, 4):
            yield As.index_select(0, torch.arange(75 * i, 75 * (i + 1))), b[75 * i:75 * (i + 1)]

    return T.linalg.streaming_least_squares(
        factory, 300, A.shape[1], T.SketchContext(seed=4),
        T.linalg.LeastSquaresParams(sketch_type="SJLT"), sparse=True,
        stream_params=StreamParams(placer=pinned_placer("cpu")))


@pytest.mark.parametrize("run", [
    pytest.param(lambda A, b: _port_run(), id="acceptance-jlt"),
    pytest.param(lambda A, b: _stream_cwt(), id="acceptance-cwt"),
    pytest.param(_ls("FJLT"), id="ls-fjlt"),
    pytest.param(_ls("CWT"), id="ls-cwt"),
    pytest.param(_accelerated("faster_least_squares"), id="blendenpik"),
    pytest.param(_accelerated("lsrn_least_squares"), id="lsrn"),
    pytest.param(_sparse_sjlt, id="sparse-sjlt-stream"),
])
def test_telemetry_off_and_on_are_bitwise(tmp_path, monkeypatch, rng, run):
    monkeypatch.setenv("SKYLARK_GUARD", "1")
    A = torch.from_numpy(rng.standard_normal((300, 6)))
    b = torch.from_numpy(rng.standard_normal(300))
    x_off, info_off = run(A, b)
    assert telemetry.REGISTRY.snapshot()["counters"] == {}
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.configure(tmp_path)
    x_on, info_on = run(A, b)
    assert torch.equal(x_off, x_on)
    assert _strip(info_off) == _strip(info_on)
    events = _read(telemetry)
    assert [e for e in events if e["name"] not in PORT_SPANS][-1]["kind"] == "run_summary"


def _stream_cwt():
    A, b = _problem()
    return T.linalg.streaming_least_squares(
        _batches(A, b, torch.from_numpy), N, D, T.SketchContext(seed=3),
        T.linalg.LeastSquaresParams(sketch_type="CWT"),
        stream_params=StreamParams(placer=pinned_placer("cpu")),
        fault_plan=T.resilient.FaultPlan(bad_sketch_at=1))


def test_traces_see_policy_guard_and_plan_events(monkeypatch, rng):
    """An active trace collects the layers' trace events: the policy
    decision, the guard's rungs and the plan cache's lookups."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    tctx = telemetry.mint("ls_solve")
    A = torch.from_numpy(rng.standard_normal((300, 5)))
    with telemetry.activate([tctx]):
        T.linalg.approximate_least_squares(A, A[:, 0], T.SketchContext(seed=1))
    kinds = [e["kind"] for e in tctx.events]
    assert kinds[0] == "policy" and "guard" in kinds and "plan" in kinds
    (guard_ev,) = [e for e in tctx.events if e["kind"] == "guard"]
    assert guard_ev["action"] == "initial" and guard_ev["rung"] == 0
    assert not telemetry.is_violating(tctx.events)
