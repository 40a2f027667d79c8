"""Port vs JAX package: the serving layer (``serve/``), on the CPU.

The same registries are built in both packages from the same seeds
(``SketchContext(seed=...)``) and the same numpy inputs, and the same
requests go through both servers.  The JAX side runs with its plans off
(its plan path needs an API the installed jax removed; the fixture
puts ``trace_state_clean`` back in ``jax.core`` for its rowwise feature
maps), ``SKYLARK_NO_SRHT_GEMM=1`` (the FJLT on the port's WHT route) and
``SKYLARK_POLICY=0``; the port runs its default, planned path, on
``device="cpu"``.

- Answers: ``ls_solve`` x̂ within 1e-10 (f64) and 1e-5 (f32) of the
  largest entry; ``predict`` (feature-map and kernel models) within
  1e-10; ``cond_est``'s report (σ_max within 1e-8; cond and σ_min within
  1e-2, the Lanczos rounding noise ``test_torch_cond_est.py`` documents
  once the extreme Ritz values have converged); ``ppr`` equal (host
  numpy in both); ``ase_embed`` rows and out-of-sample projections
  within 1e-8 up to each column's sign (f64: torch's default dtype is
  set to f64 as the JAX side runs under x64); ``update`` receipts equal.
- The port's own pins, bitwise: coalesced ≡ serial across the rung
  boundaries (1, 8, 9, 17, 32 requests), K workers ≡ 1 worker, and the
  lane ladder.
- Sheds and isolation: 112, 113, 117, the poisoned request isolated by
  code 108, unknown names (102), ``stop`` resolving stranded futures,
  and ``prime``.
- The wire format: ``protocol.encode`` byte-identical to the JAX
  module's, and a JAX ``Client`` against the port's ``serve_http``.
"""

import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import libskylark_tpu.plans.plan as jplan
from libskylark_tpu import plans as jplans
from libskylark_tpu import serve as jserve
from libskylark_tpu.core.context import SketchContext as JCtx
from libskylark_tpu.graph.graph import SimpleGraph as JGraph
from libskylark_tpu.ml.kernels import GaussianKernel as JGaussian
from libskylark_tpu.ml.model import FeatureMapModel as JFeatureMap
from libskylark_tpu.ml.model import KernelModel as JKernelModel
from libskylark_tpu.sketch.rft import GaussianRFT as JGaussianRFT
from libskylark_tpu.utils import exceptions as jex
from libskylark_tpu_torch import serve, telemetry
from libskylark_tpu_torch.core.context import SketchContext
from libskylark_tpu_torch.graph.graph import SimpleGraph
from libskylark_tpu_torch.ml.kernels import GaussianKernel
from libskylark_tpu_torch.ml.model import FeatureMapModel, KernelModel
from libskylark_tpu_torch.serve import batcher
from libskylark_tpu_torch.sketch.rft import GaussianRFT
from libskylark_tpu_torch.utils import exceptions as ex

pytestmark = pytest.mark.serve

M, N, D = 64, 5, 12
_rng = np.random.default_rng(1234)
A = _rng.standard_normal((M, N))
RHS = [_rng.standard_normal(M) for _ in range(32)]
XQ = [_rng.standard_normal(D) for _ in range(32)]
N_V = 40
EDGES = ([(v, (v + 1) % N_V) for v in range(N_V)]
         + [(v, (v + 7) % N_V) for v in range(0, N_V, 3)]
         + [(v, (v + 13) % N_V) for v in range(1, N_V, 4)])


@pytest.fixture(autouse=True)
def parity_env(monkeypatch):
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    # The JAX package's plans off (its plan path needs an API the
    # installed jax removed); the port keeps its default, planned path.
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _params(max_coalesce=16, **kw):
    kw.setdefault("warm_start", False)
    kw.setdefault("prime", False)
    return dict(max_coalesce=max_coalesce, **kw)


def _port(max_coalesce=16, seed=42, **kw):
    return serve.Server(serve.ServeParams(**_params(max_coalesce, **kw)), seed=seed,
                        device="cpu")


def _jax(max_coalesce=16, seed=42, **kw):
    return jserve.Server(jserve.ServeParams(**_params(max_coalesce, **kw)), seed=seed)


def _run(srv, requests, coalesce):
    """Serial: one call at a time.  Coalesced: everything queued before
    the worker starts, so the set arrives as one batch."""
    if coalesce:
        futures = [srv.submit(dict(r)) for r in requests]
        srv.start()
        out = [f.result(timeout=60) for f in futures]
    else:
        srv.start()
        out = [srv.call(dict(r)) for r in requests]
    srv.stop()
    return out


def _models(pkg):
    if pkg == "jax":
        S = JGaussianRFT(D, 32, JCtx(seed=5), sigma=1.2)
        fm = JFeatureMap([S], np.random.default_rng(7).standard_normal((32, 3)),
                         scale_maps=True)
        rng = np.random.default_rng(8)
        km = JKernelModel(JGaussian(D, sigma=1.1), rng.standard_normal((24, D)),
                          rng.standard_normal((24, 3)))
        return {"feature_map": fm, "kernel": km}
    S = GaussianRFT(D, 32, SketchContext(seed=5), sigma=1.2)
    fm = FeatureMapModel([S], np.random.default_rng(7).standard_normal((32, 3)),
                         scale_maps=True, device="cpu")
    rng = np.random.default_rng(8)
    km = KernelModel(GaussianKernel(D, sigma=1.1), rng.standard_normal((24, D)),
                     rng.standard_normal((24, 3)), device="cpu")
    return {"feature_map": fm, "kernel": km}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same_up_to_sign(a, b, tol):
    a, b = np.asarray(a, np.float64), np.atleast_2d(np.asarray(b, np.float64))
    a = np.atleast_2d(a)
    signs = np.sign((a * b).sum(axis=0))
    signs[signs == 0] = 1.0
    return _rel(a * signs, b) <= tol


# ---------------------------------------------------------------------------
# answers against the JAX package


@pytest.mark.parametrize("stype", ["FJLT", "CWT"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_ls_solve_matches_jax(stype, dtype, tol):
    js, ts = _jax(), _port()
    js.registry.register_system("sys", A.astype(dtype), context=JCtx(seed=9),
                                sketch_type=stype)
    ts.registry.register_system("sys", A.astype(dtype), context=SketchContext(seed=9),
                                sketch_type=stype)
    reqs = [serve.make_request("ls_solve", system="sys", b=b, id=i)
            for i, b in enumerate(RHS[:10])]
    jout, tout = _run(js, reqs, True), _run(ts, reqs, True)
    for j, t in zip(jout, tout):
        assert j["ok"] and t["ok"] and j["id"] == t["id"]
        assert t["result"].dtype == dtype
        assert _rel(t["result"], j["result"]) <= tol
        assert t["trace"]["bucket"] == j["trace"]["bucket"] == 16


@pytest.mark.parametrize("kind", ["feature_map", "kernel"])
def test_predict_matches_jax(kind):
    js, ts = _jax(), _port()
    js.registry.register_model("mdl", _models("jax")[kind])
    ts.registry.register_model("mdl", _models("port")[kind])
    reqs = [serve.make_request("predict", model="mdl", x=x) for x in XQ[:9]]
    reqs.append(serve.make_request("predict", model="mdl", x=np.stack(XQ[:3])))
    reqs.append(serve.make_request("predict", model="mdl", x=XQ[3], labels=True))
    jout, tout = _run(js, reqs, True), _run(ts, reqs, True)
    for j, t in zip(jout, tout):
        assert j["ok"] and t["ok"]
        assert np.shape(t["result"]) == np.shape(j["result"])
        if np.asarray(j["result"]).dtype.kind == "f":
            assert _rel(t["result"], j["result"]) <= 1e-10
        else:
            assert np.array_equal(t["result"], j["result"])


def test_cond_est_matches_jax():
    js, ts = _jax(), _port()
    js.registry.register_system("sys", A, context=JCtx(seed=9))
    ts.registry.register_system("sys", A, context=SketchContext(seed=9))
    reqs = [serve.make_request("cond_est", system="sys") for _ in range(3)]
    jout, tout = _run(js, reqs, True), _run(ts, reqs, True)
    j, t = jout[0]["result"], tout[0]["result"]
    assert all(r["ok"] for r in jout + tout)
    assert all(r["result"] == t for r in tout)  # the riders share one probe
    for key in ("system", "effective_rank", "n", "sketch_size", "epoch"):
        assert t[key] == j[key]
    assert abs(t["sigma_max"] - j["sigma_max"]) <= 1e-8 * j["sigma_max"]
    for key in ("cond", "sigma_min"):
        assert abs(t[key] - j[key]) <= 1e-2 * abs(j[key])


def _graph_servers():
    js, ts = _jax(), _port()
    js.registry.register_graph("g", JGraph(EDGES), k=2, context=JCtx(seed=5))
    ts.registry.register_graph("g", SimpleGraph(EDGES), k=2, context=SketchContext(seed=5))
    return js, ts


def test_ppr_matches_jax(f64_default):
    js, ts = _graph_servers()
    reqs = [serve.make_request("ppr", graph="g", seeds=[0, 1]),
            serve.make_request("ppr", graph="g", seeds=[1, 0]),
            serve.make_request("ppr", graph="g", seeds=[17], alpha=0.7, epsilon=1e-4)]
    jout, tout = _run(js, reqs, True), _run(ts, reqs, True)
    for j, t in zip(jout, tout):
        assert j["ok"] and t["ok"]
        assert t["result"] == j["result"]


def test_ase_embed_matches_jax(f64_default):
    js, ts = _graph_servers()
    reqs = [serve.make_request("ase_embed", graph="g", ids=[0, 5, 9]),
            serve.make_request("ase_embed", graph="g", ids=3),
            serve.make_request("ase_embed", graph="g", neighbors=[1, 2, 20])]
    jout, tout = _run(js, reqs, True), _run(ts, reqs, True)
    for j, t in zip(jout, tout):
        assert j["ok"] and t["ok"]
        assert np.shape(t["result"]) == np.shape(j["result"])
        assert _same_up_to_sign(t["result"], j["result"], 1e-8)


def test_update_matches_jax(f64_default):
    js, ts = _jax(), _port()
    for srv, ctx, G in ((js, JCtx, JGraph), (ts, SketchContext, SimpleGraph)):
        srv.registry.register_system("sys", A, context=ctx(seed=9), sketch_type="CWT",
                                     sketch_size=32, capacity=M + 8)
        srv.registry.register_graph("g", G(EDGES), k=2, context=ctx(seed=5))
    rows = np.random.default_rng(4).standard_normal((3, N))
    reqs = [serve.make_request("update", system="sys", append=rows.tolist()),
            serve.make_request("update", graph="g", edges=[[0, 20], [3, 30]]),
            serve.make_request("update", system="sys", drop=[2, 7]),
            serve.make_request("ls_solve", system="sys",
                               b=np.concatenate([RHS[0], [0.5, -1.0, 2.0]])),
            serve.make_request("ase_embed", graph="g", ids=[0, 20, 30])]
    jout, tout = _run(js, reqs, False), _run(ts, reqs, False)
    for j, t in zip(jout[:3], tout[:3]):
        assert j["ok"] and t["ok"] and t["result"] == j["result"]
    assert _rel(tout[3]["result"], jout[3]["result"]) <= 1e-10
    assert _same_up_to_sign(tout[4]["result"], jout[4]["result"], 1e-8)
    assert ts.registry.epoch == js.registry.epoch == 5


# ---------------------------------------------------------------------------
# the port's own pins: coalesced ≡ serial, K workers ≡ 1, the lane ladder


@pytest.mark.parametrize("stype", ["FJLT", "CWT"])
@pytest.mark.parametrize("n_req", [1, 8, 9, 17, 32])
def test_ls_coalesced_bitwise_equals_serial(stype, n_req):
    def server(mc):
        srv = _port(mc)
        srv.registry.register_system("sys", A.astype(np.float32), context=SketchContext(seed=9),
                                     sketch_type=stype)
        return srv

    reqs = [serve.make_request("ls_solve", system="sys", b=b) for b in RHS[:n_req]]
    serial = _run(server(1), reqs, coalesce=False)
    coal = _run(server(32), reqs, coalesce=True)
    assert all(r["ok"] for r in serial + coal)
    assert {r["trace"]["bucket"] for r in serial} == {8}
    assert {r["trace"]["batch_size"] for r in coal} == {n_req}
    assert {r["trace"]["bucket"] for r in coal} == {batcher._lane_bucket(n_req)}
    for s, c in zip(serial, coal):
        assert np.array_equal(s["result"], c["result"])


@pytest.mark.parametrize("kind", ["feature_map", "kernel"])
@pytest.mark.parametrize("n_req", [1, 9, 17, 32])
def test_predict_coalesced_bitwise_equals_serial(kind, n_req):
    def server(mc):
        srv = _port(mc)
        srv.registry.register_model("mdl", _models("port")[kind])
        return srv

    reqs = [serve.make_request("predict", model="mdl", x=x, dtype="float32")
            for x in XQ[:n_req]]
    serial = _run(server(1), reqs, coalesce=False)
    coal = _run(server(32), reqs, coalesce=True)
    assert all(r["ok"] for r in serial + coal)
    assert max(r["trace"]["batch_size"] for r in coal) == n_req
    for s, c in zip(serial, coal):
        assert np.array_equal(s["result"], c["result"])


def test_k_workers_bitwise_equal_one_worker():
    def server(workers, mc):
        srv = _port(mc, workers=workers)
        srv.registry.register_system("sys", A.astype(np.float32), context=SketchContext(seed=9))
        srv.registry.register_model("mdl", _models("port")["feature_map"])
        return srv

    reqs = ([serve.make_request("ls_solve", system="sys", b=b) for b in RHS[:24]]
            + [serve.make_request("predict", model="mdl", x=x) for x in XQ[:24]])
    serial = _run(server(1, 1), reqs, coalesce=False)
    srv = server(3, 8).start()
    assert len(srv._threads) == 3
    out = [None] * len(reqs)

    def client(i0):
        for i in range(i0, len(reqs), 6):
            out[i] = srv.call(dict(reqs[i]))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    srv.stop()
    assert not any(t.is_alive() for t in threads)
    for s, r in zip(serial, out):
        assert r["ok"] and np.array_equal(s["result"], r["result"])


def test_blocked_solve_is_per_column_bitwise():
    """Each column of the blocked ``_qr_solve`` is bitwise its own solve
    alone, at every position of its block and every batch width."""
    rng = np.random.default_rng(3)
    Q, R = torch.linalg.qr(torch.from_numpy(rng.standard_normal((256, 32))))
    Qt = Q.T.contiguous()
    SB = torch.from_numpy(rng.standard_normal((256, 32)))
    alone = [batcher._qr_solve(Qt, R, torch.cat([SB[:, j:j + 1], SB.new_zeros(256, 7)], 1))[:, 0]
             for j in range(32)]
    for kb in (8, 16, 24, 32):
        X = batcher._qr_solve(Qt, R, SB[:, :kb])
        assert all(torch.equal(X[:, j], alone[j]) for j in range(kb))


def test_lane_uniform_bucket_skips_remainder_rung():
    assert [batcher._lane_bucket(k) for k in (1, 8, 9, 12, 17, 25, 33)] == \
        [8, 8, 16, 16, 24, 32, 48]
    assert all(batcher._lane_bucket(k) % batcher.BLOCK == 0 for k in range(1, 200))
    import libskylark_tpu.serve.batcher as jbatcher

    assert all(batcher._lane_bucket(k) == jbatcher._lane_bucket(k) for k in range(1, 200))


# ---------------------------------------------------------------------------
# sheds and isolation


def _ls_port(**kw):
    srv = _port(**kw)
    srv.registry.register_system("sys", A, context=SketchContext(seed=9))
    return srv


def test_admission_shed_112_and_stop_resolves_stranded_futures():
    srv = _ls_port(max_queue=2)
    futs = [srv.submit(serve.make_request("ls_solve", system="sys", b=b)) for b in RHS[:3]]
    shed = futs[2].result(timeout=5)
    assert not shed["ok"] and shed["error"]["code"] == 112
    assert shed["error"]["queue_depth"] == 2 and shed["error"]["max_depth"] == 2
    srv.stop()  # the worker never started: the queued two resolve with errors
    for f in futs[:2]:
        r = f.result(timeout=5)
        assert not r["ok"] and r["error"]["code"] == 100
        assert "stopped" in r["error"]["message"]


def test_deadline_shed_113():
    srv = _ls_port()
    fut = srv.submit(serve.make_request("ls_solve", system="sys", b=RHS[0], deadline_ms=1))
    time.sleep(0.05)
    srv.start()
    r = fut.result(timeout=10)
    srv.stop()
    assert not r["ok"] and r["error"]["code"] == 113
    assert r["error"]["waited_ms"] >= 1
    assert any(e["kind"] == "deadline_shed" for e in r["trace"]["events"])


def test_quota_shed_117():
    srv = _ls_port(tenant_quota_rps=0.001, tenant_quota_burst=1).start()
    try:
        first = srv.call(op="ls_solve", system="sys", b=RHS[0], tenant="noisy")
        second = srv.call(op="ls_solve", system="sys", b=RHS[1], tenant="noisy")
        other = srv.call(op="ls_solve", system="sys", b=RHS[1], tenant="polite")
    finally:
        srv.stop()
    assert first["ok"] and other["ok"]
    assert not second["ok"] and second["error"]["code"] == 117
    assert second["error"]["tenant"] == "noisy" and second["error"]["retry_after_ms"] > 0


def test_poisoned_request_isolated_by_code_108():
    bad = RHS[2].copy()
    bad[5] = np.nan
    reqs = [serve.make_request("ls_solve", system="sys", b=b) for b in (RHS[0], RHS[1], bad,
                                                                      RHS[3])]
    coal = _run(_ls_port(max_coalesce=8), reqs, coalesce=True)
    serial = _run(_ls_port(max_coalesce=1), [reqs[i] for i in (0, 1, 3)], coalesce=False)
    assert not coal[2]["ok"] and coal[2]["error"]["code"] == 108
    assert any(e["kind"] == "fallback" for e in coal[2]["trace"]["events"])
    for c, s in zip([coal[i] for i in (0, 1, 3)], serial):
        assert c["ok"] and np.array_equal(c["result"], s["result"])


@pytest.mark.parametrize("request_", [
    {"op": "ls_solve", "system": "nope", "b": [0.0] * M},
    {"op": "predict", "model": "nope", "x": [0.0] * D},
    {"op": "ppr", "graph": "nope", "seeds": [0]},
    {"op": "teleport"},
    {"op": "ls_solve", "system": "sys", "b": [0.0] * (M - 1)},
], ids=["system", "model", "graph", "op", "shape"])
def test_unknown_names_are_code_102(request_):
    srv = _ls_port().start()
    try:
        r = srv.call(dict(request_))
    finally:
        srv.stop()
    assert not r["ok"] and r["error"]["code"] == 102
    assert isinstance(serve.exception_for(r["error"]), ex.InvalidParameters)


def test_prime_runs_every_lane_rung():
    srv = _port(17, prime=True)
    srv.registry.register_system("sys", A, context=SketchContext(seed=9))
    srv.registry.register_model("mdl", _models("port")["feature_map"])
    srv.start()
    try:
        assert srv.primed == ["system:sys:[8, 16, 24]", "model:mdl:[8, 16, 24]"]
        assert srv.call(op="ping")["result"] == "pong"
        assert srv.stats()["primed"] == srv.primed
    finally:
        srv.stop()


def test_port_server_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.Server(serve.ServeParams(warm_start=False, prime=False))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.Registry()


# ---------------------------------------------------------------------------
# the wire format


def _frames():
    arr = np.random.default_rng(2).standard_normal((2, 3))
    errs = [(jex.AdmissionError("full", queue_depth=3, max_depth=3),
             ex.AdmissionError("full", queue_depth=3, max_depth=3)),
            (jex.QuotaExceededError("q", tenant="t", rate=1.0, burst=2.0, retry_after_ms=7),
             ex.QuotaExceededError("q", tenant="t", rate=1.0, burst=2.0, retry_after_ms=7)),
            (jex.RegistryEpochError("e", requested=1, current=2, entity="sys"),
             ex.RegistryEpochError("e", requested=1, current=2, entity="sys")),
            (jex.JournalError("j", path="/x", record=3, reason="crc"),
             ex.JournalError("j", path="/x", record=3, reason="crc")),
            (jex.NumericalHealthError("n", stage="serve_ls_solve"),
             ex.NumericalHealthError("n", stage="serve_ls_solve")),
            (ValueError("foreign"), ValueError("foreign"))]
    frames = [
        (serve.make_request("ls_solve", id=7, system="sys", b=arr[0]),) * 2,
        (serve.ok_response("x", arr, {"events": [], "bucket": 8}),) * 2,
        (serve.ok_response(3, {"cond": np.float64(2.5), "rank": np.int64(4)}, {}),) * 2,
        (serve.ok_response(None, [arr[0], np.float32(1.5)], {"coalesced": True}),) * 2,
    ]
    frames += [(jserve.error_response(1, je, {"events": []}),
                serve.error_response(1, te, {"events": []})) for je, te in errs]
    return frames


def test_protocol_encode_is_byte_identical_to_jax():
    for jf, tf in _frames():
        assert serve.encode(tf) == jserve.encode(jf)
        assert serve.decode(serve.encode(tf)) == jserve.decode(jserve.encode(jf))
    for code in (102, 108, 109, 112, 113, 114, 116, 117, 118):
        te, je = serve.exception_for({"code": code}), jserve.exception_for({"code": code})
        assert type(te).__name__ == type(je).__name__ and te.code == je.code == code
    for req in ({"op": "ls_solve", "system": "s"}, {"op": "predict", "model": "m"},
                {"op": "predict", "model": "m", "dtype": "float32"},
                {"op": "update", "graph": "g"}, {"op": "ping"}):
        assert serve.placement_key(req) == jserve.placement_key(req)


def test_jax_client_against_port_http(monkeypatch):
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.reset()
    srv = _ls_port().start()
    httpd = serve.serve_http(srv)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        local = [srv.call(serve.make_request("ls_solve", system="sys", b=b)) for b in RHS[:4]]
        jc = jserve.Client(url=url, timeout=30)
        one = jc.ls_solve("sys", RHS[0].tolist(), check=True)
        many = jc.call_many([serve.make_request("ls_solve", system="sys", b=b.tolist())
                             for b in RHS[:4]])
        tc = serve.Client(url=url, timeout=30)
        health = tc.healthz()
        metrics = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
        stats = jc.stats()
        jc.close()
        tc.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        telemetry.reset()
        serve.server._LATENCIES.clear()
    assert np.array_equal(np.asarray(one), local[0]["result"])
    for r, loc in zip(many, local):
        assert r["ok"] and np.array_equal(np.asarray(r["result"]), loc["result"])
    assert health["ok"] and health["backend"] == "cpu" and health["device"] == "cpu"
    assert health["load"]["census"]["systems"] == ["sys"]
    assert "skylark_serve_requests" in metrics and "skylark_serve_ok" in metrics
    assert stats["counters"]["requests"] >= 9
