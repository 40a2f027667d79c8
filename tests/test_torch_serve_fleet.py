"""Port vs JAX package: the serving fleet (``serve/router.py``,
``serve/autoscale.py``, ``serve/dispatch.py``), on the CPU.

- Placement is a pure function of the frozen load reports: the port's
  ``choose_replica`` gives the JAX package's answer on the same reports.
- The dispatch gates (``supported``, ``worthwhile``, ``shard_devices``)
  are the JAX package's; where they pick two or more devices the sharded
  route raises ``UnsupportedError`` (104) naming ROADMAP Queue A item 9
  in the request's envelope, and ``SKYLARK_SERVE_SHARD=0`` serves it.
- 2 replicas behind a ``Router`` ≡ 1 worker serial, bitwise, in process
  and over HTTP (``HttpReplica`` against the port's ``serve_http``).
- Membership: the join fence (109, in process and as ``POST /join``'s
  409 envelope), heartbeat ejection with re-placement on the survivor
  and 114 once none is left, fleet saturation (112), and the
  autoscaler's spawn (prime before placeable) and LIFO drain to zero.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from libskylark_tpu import serve as jserve
from libskylark_tpu.serve import dispatch as jdispatch
from libskylark_tpu_torch import serve
from libskylark_tpu_torch.core.context import SketchContext
from libskylark_tpu_torch.ml.kernels import GaussianKernel
from libskylark_tpu_torch.ml.model import FeatureMapModel, KernelModel
from libskylark_tpu_torch.serve import dispatch
from libskylark_tpu_torch.sketch.rft import GaussianRFT
from libskylark_tpu_torch.utils import exceptions as ex

pytestmark = pytest.mark.fleet

M, N, D = 64, 5, 12
_rng = np.random.default_rng(77)
A = _rng.standard_normal((M, N)).astype(np.float32)
RHS = [_rng.standard_normal(M) for _ in range(24)]
XQ = [_rng.standard_normal(D) for _ in range(24)]


def _replica(max_coalesce=16, workers=1, **kw):
    """A full replica: the same seeds every time, so bitwise comparisons
    across replicas and servers mean something."""
    kw.setdefault("prime", False)
    srv = serve.Server(serve.ServeParams(max_coalesce=max_coalesce, workers=workers,
                                         warm_start=False, **kw),
                       seed=42, device="cpu")
    srv.registry.register_system("sys", A, context=SketchContext(seed=9))
    srv.registry.register_model("fm", FeatureMapModel(
        [GaussianRFT(D, 32, SketchContext(seed=5), sigma=1.2)],
        np.random.default_rng(7).standard_normal((32, 3)), scale_maps=True, device="cpu"))
    rng = np.random.default_rng(8)
    srv.registry.register_model("krr", KernelModel(
        GaussianKernel(D, sigma=1.1), rng.standard_normal((24, D)),
        rng.standard_normal((24, 3)), device="cpu"))
    return srv


def _requests():
    return ([serve.make_request("ls_solve", system="sys", b=b) for b in RHS]
            + [serve.make_request("predict", model=m, x=x) for m in ("fm", "krr")
               for x in XQ[:12]])


def _serial():
    srv = _replica(max_coalesce=1).start()
    out = [srv.call(dict(r)) for r in _requests()]
    srv.stop()
    assert all(r["ok"] for r in out)
    return out


def _report(depth, cap=8, tput=None, profile=None, cached=None):
    rep = {"queue_depth": depth, "max_queue": cap, "throughput": {}}
    if tput is not None:
        rep["throughput"]["ls:sys"] = {"rows_per_s": tput}
    if profile is not None:
        rep["profiles"] = {"any": {"rows_per_s": profile}}
    if cached is not None:
        rep["cache"] = {"keys": {"ls:sys": cached}}
    return rep


@pytest.mark.parametrize("members,affinity", [
    ({"b": (True, _report(3)), "a": (True, _report(3)), "c": (True, _report(1))}, {}),
    ({"b": (True, _report(1, profile=500.0)), "a": (True, _report(1, tput=100.0)),
      "c": (True, _report(1))}, {}),
    ({"y": (True, _report(2)), "x": (True, _report(2)), "z": (True, _report(2))}, {}),
    ({"a": (True, _report(0)), "c": (True, _report(1))}, {"ls:sys": "c"}),
    ({"a": (True, _report(0)), "c": (True, _report(8))}, {"ls:sys": "c"}),
    ({"a": (True, _report(0)), "c": (False, _report(1))}, {"ls:sys": "c"}),
    ({"a": (True, _report(0)), "b": (True, _report(4, cached=3))}, {}),
    ({"a": (True, _report(8)), "b": (True, _report(8))}, {}),
    ({}, {}),
], ids=["depth", "throughput", "name", "affinity", "saturated", "unplaceable", "cache",
        "all-saturated", "empty"])
def test_choose_replica_matches_jax(members, affinity):
    frozen = {n: {"placeable": p, "report": r} for n, (p, r) in members.items()}
    got = serve.choose_replica("ls:sys", frozen, dict(affinity))
    assert got == jserve.choose_replica("ls:sys", frozen, dict(affinity))
    assert got == serve.choose_replica("ls:sys", dict(reversed(list(frozen.items()))),
                                       dict(affinity))


def test_shard_gates_match_jax(monkeypatch):
    for kb in (8, 16, 24, 32, 48, 64):
        for d in range(0, 9):
            assert dispatch.supported(kb, d) == jdispatch.supported(kb, d)
    for flops in (1.0, 2.9e7, 3e7, 1e12):
        assert dispatch.worthwhile(flops) == jdispatch.worthwhile(flops)
    # a CPU batch has one device: never sharded
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "1")
    assert dispatch.shard_devices(32, 1e12, torch.device("cpu")) is None
    fake = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(dispatch, "_local_devices", lambda device: fake)
    assert dispatch.shard_devices(32, 1.0) == fake  # forced: the largest split
    assert dispatch.shard_devices(8, 1e12) is None  # 8 / 2 leaves the sub-ladder
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "")
    assert dispatch.shard_devices(32, 1.0) is None  # auto: under the floor
    assert dispatch.shard_devices(16, 1e12) == fake[:2]
    monkeypatch.setenv("SKYLARK_SERVE_SHARD_MIN_FLOPS", "10")
    assert dispatch.shard_devices(16, 100.0) == fake[:2]
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "0")
    assert dispatch.shard_devices(32, 1e12) is None


@pytest.fixture
def one_thread():
    """On a loaded host MKL may run a GEMM on fewer threads than torch
    asks for, and its bits follow the thread count: a bitwise pin of two
    separate runs holds on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("op", ["ls", "fm", "krr"])
def test_sharded_route_raises_naming_item_9(monkeypatch, one_thread, op):
    """Item 9c is ported: past the gates (two devices, forced) each
    program runs split over them, its first batch probed, and every
    answer is bitwise the single-device route's (``SKYLARK_SERVE_SHARD=0``)."""
    monkeypatch.setattr(dispatch, "_local_devices",
                        lambda device: [device, device])
    reqs = [r for r in _requests() if r.get("system", r.get("model")) == op.replace("ls", "sys")]
    outs = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("SKYLARK_SERVE_SHARD", mode)
        dispatch.clear_cache()
        srv = _replica()
        futs = [srv.submit(dict(r)) for r in reqs[:12]]
        srv.start()
        outs[mode] = [f.result(timeout=60) for f in futs]
        srv.stop()
        assert all(r["ok"] for r in outs[mode])
    dispatch.clear_cache()
    for a, b in zip(outs["1"], outs["0"]):
        assert np.array_equal(np.asarray(a["result"]), np.asarray(b["result"]))
    # 12 requests pad to 16 = 2 x 8 columns: the gates pick 2 devices
    probes = [e for r in outs["1"] for e in r["trace"]["events"] if e["kind"] == "sharded_probe"]
    assert probes and all(e["match"] and e["devices"] == 2 for e in probes)
    assert not any("shard" in e["kind"] for r in outs["0"] for e in r["trace"]["events"])


def test_two_replica_routed_bitwise_equals_single_worker_serial():
    serial = _serial()
    r1, r2 = _replica().start(), _replica().start()
    router = serve.Router()
    router.join("r1", server=r1)
    router.join("r2", server=r2)
    router.drain("r1")  # the ls key to r2 first, then both open again
    futs = [router.submit(dict(r)) for r in _requests()[:24]]
    with router._lock:
        router._members["r1"].placeable = True
        router._members["r1"].draining = False
        router._affinity.clear()
        router._members["r2"].report = dict(router._members["r2"].report, queue_depth=5)
    futs += [router.submit(dict(r)) for r in _requests()[24:]]
    out = [f.result(timeout=60) for f in futs]
    router.stop()
    r1.stop()
    r2.stop()
    assert {r["trace"]["replica"] for r in out} == {"r1", "r2"}
    for s, r in zip(serial, out):
        assert r["ok"] and np.array_equal(s["result"], r["result"])


def test_http_replica_routed_bitwise_equals_serial():
    serial = _serial()
    back = _replica().start()
    httpd = serve.serve_http(back)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    router = serve.Router()
    try:
        rec = router.join("remote", url=f"http://127.0.0.1:{httpd.server_address[1]}",
                          timeout=30)
        assert rec["placeable"] and rec["epoch"] == 1
        out = [router.call(dict(r)) for r in _requests()[:6]]
    finally:
        router.stop()
        httpd.shutdown()
        httpd.server_close()
        back.stop()
    for s, r in zip(serial, out):
        assert r["ok"] and r["trace"]["replica"] == "remote"
        assert np.array_equal(np.asarray(r["result"], np.float32), s["result"])


def test_join_signature_mismatch_code_109():
    r1 = _replica().start()
    router = serve.Router()
    router.join("r1", server=r1)
    odd = serve.Server(serve.ServeParams(warm_start=False, prime=False), seed=42,
                       device="cpu")
    odd.registry.register_system("other", A, context=SketchContext(seed=9))
    odd.start()
    with pytest.raises(ex.WorldMismatchError) as info:
        router.join("odd", server=odd)
    assert info.value.code == 109
    assert set(router.fleet_report()["members"]) == {"r1"}
    # the same fence over HTTP: POST /join answers 409 with a 109 envelope
    odd_http = serve.serve_http(odd)
    front = serve.serve_http(router)
    threads = [threading.Thread(target=h.serve_forever, daemon=True) for h in (odd_http, front)]
    for t in threads:
        t.start()
    body = json.dumps({"name": "odd", "url": f"http://127.0.0.1:{odd_http.server_address[1]}"})
    req = urllib.request.Request(f"http://127.0.0.1:{front.server_address[1]}/join",
                                 data=body.encode(), headers={"Content-Type": "application/json"})
    try:
        with pytest.raises(urllib.error.HTTPError) as http_err:
            urllib.request.urlopen(req, timeout=30)
        assert http_err.value.code == 409
        assert json.loads(http_err.value.read())["error"]["code"] == 109
    finally:
        for h in (odd_http, front):
            h.shutdown()
            h.server_close()
        router.stop()
        odd.stop()
        r1.stop()


def test_heartbeat_eject_and_replacement_then_114():
    r1, r2 = _replica().start(), _replica().start()
    router = serve.Router(serve.RouterParams(heartbeat_timeout_s=5.0))
    router.join("r1", server=r1)
    router.join("r2", server=r2)
    first = router.call(op="ls_solve", system="sys", b=RHS[0])
    lost = first["trace"]["replica"]
    dead, survivor = (r1, r2) if lost == "r1" else (r2, r1)
    dead.stop()
    now = time.monotonic()
    assert router.poll_once(now=now)[lost] is False
    alive = router.poll_once(now=now + 10.0)
    assert set(alive) == {"r1", "r2"} - {lost} and router.fleet_report()["epoch"] == 3
    again = router.call(op="ls_solve", system="sys", b=RHS[0])
    assert again["ok"] and again["trace"]["replica"] != lost
    assert np.array_equal(again["result"], first["result"])
    survivor.stop()
    router.poll_once(now=now + 20.0)
    resp = router.call(op="ls_solve", system="sys", b=RHS[0])
    router.stop()
    assert not resp["ok"] and resp["error"]["code"] == 114
    with pytest.raises(ex.ReplicaLostError):
        serve.raise_for_error(resp)


def test_fleet_saturation_sheds_code_112():
    r1 = _replica().start()
    router = serve.Router()
    router.join("r1", server=r1)
    with router._lock:
        router._members["r1"].report = _report(8, cap=8)
    resp = router.call(op="ls_solve", system="sys", b=RHS[0])
    router.stop()
    r1.stop()
    assert not resp["ok"] and resp["error"]["code"] == 112


class FakeServer:
    """A load-report-only replica for the control loop."""

    def __init__(self, name, depth=0.0):
        self.name, self.depth = name, depth
        self.started = self.stopped = False

    def start(self):
        self.started = True
        return self

    def stop(self, timeout=None):
        self.stopped = True

    def submit(self, request):
        fut = Future()
        fut.set_result({"ok": True, "result": "pong", "trace": {"events": []}})
        return fut

    def load_report(self):
        return {"queue_depth": self.depth, "max_queue": 64,
                "worker_alive": self.started and not self.stopped, "throughput": {},
                "latency": {}, "primed": [], "census": {}, "signature": 1234}


def test_autoscaler_spawns_primed_and_drains_lifo_to_the_floor():
    router = serve.Router(serve.RouterParams(heartbeat_timeout_s=60.0))
    core = [FakeServer(f"core-{i}").start() for i in range(2)]
    for s in core:
        router.join(s.name, server=s)
    spawned = []

    def factory(name):
        spawned.append(FakeServer(name))
        return spawned[-1]

    scaler = serve.Autoscaler(router, factory, serve.AutoscaleParams(
        min_replicas=2, max_replicas=4, queue_high=4.0, queue_low=1.0, cooldown_ticks=1,
        idle_ticks=1))
    for s in core:
        s.depth = 10.0
    d = scaler.step()
    assert d["action"] == "scale_up" and spawned[0].started
    assert router.fleet_report()["members"]["auto-1"]["placeable"]
    assert scaler.step()["action"] == "cooldown"
    for s in core + spawned:
        s.depth = 0.0
    actions = [scaler.step()["action"] for _ in range(6)]
    assert "scale_down" in actions and spawned[0].stopped
    assert set(router.fleet_report()["members"]) == {"core-0", "core-1"}
    assert not any(s.stopped for s in core)
    assert scaler.report()["ledger"] and list(scaler.ledger)[-1]["action"] in ("hold", "cooldown")

    def broken(name):
        raise RuntimeError("no capacity")

    scaler.factory = broken
    for s in core:
        s.depth = 10.0
    assert scaler.step()["action"] == "scale_up_failed"
    router.stop()


def test_real_replica_scale_up_is_primed_before_placeable():
    """The autoscaler starts a real server (prime, then workers) before
    the router may place on it."""
    router = serve.Router()
    base = _replica(prime=True).start()
    router.join("base", server=base)
    made = []

    def factory(name):
        made.append(_replica(prime=True))
        return made[-1]

    scaler = serve.Autoscaler(router, factory, serve.AutoscaleParams(
        min_replicas=1, max_replicas=2, queue_high=-1.0))
    assert scaler.step()["action"] == "scale_up"
    assert made[0].primed and made[0]._threads
    assert router.fleet_report()["members"]["auto-1"]["placeable"]
    router.stop()
    for s in [base] + made:
        s.stop()
