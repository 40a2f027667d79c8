"""The serve layer's sharded programs and the fleet's chaos drills
(ports of ``tests/test_fleet.py:190-251`` and
``tests/test_autoscale.py:226-380``).

Sharded dispatch: ``dispatch._local_devices`` is replaced by 2 and 4
entries of the CPU (the card's phase 3q uses entries of ``cuda:0``), and
``SKYLARK_SERVE_SHARD=1`` forces every splittable rung through the
sharded programs.  Every answer must be bitwise the serial (one request
per batch, never sharded) answer, every program must run its parity
probe, auto mode at test scale must build nothing, and a program whose
bits differ (a perturbed slot) must be tombstoned while the reference
bits are served.

Drills: a :class:`FleetFaultPlan` bound to the autoscaler fires at
exact control ticks: a slow heartbeat (stale but alive, never ejected),
a flapping replica (membership converges), a replica dying under load
(capacity restored, no caller sees a 114) and a join storm (every
joiner fenced and placeable; a mismatched registry refused with 109).
The replicas are real port servers on the CPU.
"""

import numpy as np
import pytest
import torch

from libskylark_tpu_torch import serve, telemetry
from libskylark_tpu_torch.core.context import SketchContext
from libskylark_tpu_torch.parallel import mesh as tmesh
from libskylark_tpu_torch.resilient import FleetFaultPlan
from libskylark_tpu_torch.serve import dispatch
from libskylark_tpu_torch.utils import exceptions as ex
from test_torch_serve_fleet import A, RHS, FakeServer, _replica, _requests, _serial

pytestmark = pytest.mark.fleet


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The bitwise pins run on one thread: on a loaded host MKL may run a
    GEMM on fewer threads than torch asks for, and its bits follow the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "1")
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.REGISTRY.reset()
    dispatch.clear_cache()
    yield
    dispatch.clear_cache()
    telemetry.REGISTRY.reset()


def _run(*rounds):
    """The answers of each round of requests, the rounds one after another
    on one replica (its sketches and models, the programs' anchors, are
    shared by the rounds)."""
    srv = _replica(max_coalesce=16)
    out = []
    for r, reqs in enumerate(rounds):
        futs = [srv.submit(dict(q)) for q in reqs]
        if r == 0:
            srv.start()
        out.append([f.result(timeout=120) for f in futs])
    srv.stop()
    return out[0] if len(rounds) == 1 else out


def _ls(rhs):
    return [serve.make_request("ls_solve", system="sys", b=b) for b in rhs]


# Two rounds of 16 distinct right-hand sides (a repeated request would be
# answered from the response cache).
ROUNDS = [list(np.random.default_rng(78 + r).standard_normal((16, A.shape[0])))
          for r in range(2)]


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_dispatch_bitwise_and_probed(monkeypatch, forced, ndev):
    """Forced sharding changes no bits: the first batch of each program
    runs both routes and serves the reference; every program (ls, the
    feature-map predict, the kernel predict) is probed and verified."""
    monkeypatch.setattr(dispatch, "_local_devices", lambda device: [device] * ndev)
    serial = _serial()  # one request a batch: rung 8, never sharded
    routed = _run(_requests())
    counters = telemetry.REGISTRY.snapshot()["counters"]
    assert all(r["ok"] for r in routed)
    for s, c in zip(serial, routed):
        assert np.array_equal(np.asarray(s["result"]), np.asarray(c["result"]))
    probes = {(e["op"], e["match"]) for r in routed for e in r["trace"]["events"]
              if e["kind"] == "sharded_probe"}
    assert probes == {("ls", True), ("predict", True), ("kernel", True)}
    assert counters.get("serve.sharded_verified", 0) == 3
    assert not counters.get("serve.sharded_rejected", 0)


def test_verified_program_serves_later_batches_sharded(monkeypatch, forced):
    monkeypatch.setattr(dispatch, "_local_devices", lambda device: [device] * 2)
    first, second = _run(_ls(ROUNDS[0]), _ls(ROUNDS[1]))
    kinds = [e["kind"] for r in second for e in r["trace"]["events"] if "shard" in e["kind"]]
    assert kinds and set(kinds) == {"sharded"}  # the program was kept: no probe
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "0")
    plain = _run(_ls(ROUNDS[0]), _ls(ROUNDS[1]))
    for want, got in zip(plain[0] + plain[1], first + second):
        assert np.array_equal(np.asarray(want["result"]), np.asarray(got["result"]))
    assert telemetry.REGISTRY.snapshot()["counters"]["serve.sharded_dispatch"] >= 1


def test_a_program_whose_bits_differ_is_tombstoned(monkeypatch, forced):
    """A slot whose bits differ (one entry of its block changed on its way
    to the slot) fails the probe: the program is tombstoned, the
    reference bits are served, and later batches never run it again."""
    monkeypatch.setattr(dispatch, "_local_devices", lambda device: [device] * 2)
    orig = tmesh.shard

    def nudged(x, mesh, *spec):
        out = orig(x, mesh, *spec)
        if mesh.axis_names == ("serve_batch",):
            t = out.shards[-1].clone()
            t.view(-1)[0] += 1.0
            out.shards[-1] = t
        return out

    monkeypatch.setattr(tmesh, "shard", nudged)
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "0")
    plain = _run(_ls(ROUNDS[0]), _ls(ROUNDS[1]))
    monkeypatch.setenv("SKYLARK_SERVE_SHARD", "1")
    first, second = _run(_ls(ROUNDS[0]), _ls(ROUNDS[1]))
    counters = telemetry.REGISTRY.snapshot()["counters"]
    assert counters.get("serve.sharded_rejected") == 1
    assert not counters.get("serve.sharded_verified", 0)
    probes = [e for r in first for e in r["trace"]["events"] if e["kind"] == "sharded_probe"]
    assert probes and not any(e["match"] for e in probes)
    assert not any("shard" in e["kind"] for r in second for e in r["trace"]["events"])
    for want, got in zip(plain[0] + plain[1], first + second):
        assert np.array_equal(np.asarray(want["result"]), np.asarray(got["result"]))


def test_shard_auto_mode_stays_single_device_at_small_scale(monkeypatch):
    """Unset: the amortization gate keeps test-scale batches on the
    single-device path — no probes, no programs."""
    monkeypatch.delenv("SKYLARK_SERVE_SHARD", raising=False)
    monkeypatch.delenv("SKYLARK_SERVE_SHARD_MIN_FLOPS", raising=False)
    monkeypatch.setattr(dispatch, "_local_devices", lambda device: [device] * 2)
    dispatch.clear_cache()
    results = _run(_ls(RHS[:10]))
    assert all(r["ok"] for r in results)
    assert not dispatch._PROGRAMS
    assert not any("shard" in e["kind"] for r in results for e in r["trace"]["events"])


# -- the autoscaler's chaos drills ---------------------------------------------------


class FlakyServer(FakeServer):
    """A load-report-only replica whose next report fetches can fail."""

    fail_reports = 0

    def load_report(self):
        if self.fail_reports > 0:
            self.fail_reports -= 1
            raise OSError("report fetch timed out")
        return super().load_report()


def _fake_fleet(params, fault_plan=None, cores=2, timeout_s=60.0):
    router = serve.Router(serve.RouterParams(heartbeat_timeout_s=timeout_s))
    core = [FlakyServer(f"core-{i}").start() for i in range(cores)]
    for s in core:
        router.join(s.name, server=s)
    scaler = serve.Autoscaler(router, lambda name: FlakyServer(name), params,
                              fault_plan=fault_plan)
    return router, core, scaler


def _params(**kw):
    base = dict(min_replicas=2, max_replicas=4, queue_high=4.0, queue_low=1.0,
                cooldown_ticks=2, idle_ticks=2, drain_timeout_s=30.0)
    base.update(kw)
    return serve.AutoscaleParams(**base)


def test_slow_heartbeat_is_stale_but_alive_never_ejected():
    plan = FleetFaultPlan(slow_heartbeat_at=2, slow_heartbeat_s=1.0)
    router, core, scaler = _fake_fleet(_params(), fault_plan=plan)
    plan.bind_fleet(slow_report=lambda s: setattr(core[0], "fail_reports", 1))
    scaler.step()
    d = scaler.step()  # the fault fires; core-0's fetch fails this sweep
    assert d["placeable"] == 2
    member = router.fleet_report()["members"]["core-0"]
    assert member["placeable"]
    assert member["report"]["report_age_s"] >= 0.0
    scaler.step()  # the next sweep recovers the live report
    assert "report_age_s" not in router.fleet_report()["members"]["core-0"]["report"]
    router.stop()


def test_flapping_replica_membership_converges():
    plan = FleetFaultPlan(flap_at=2, flap_times=2)
    router, core, scaler = _fake_fleet(_params(min_replicas=1, idle_ticks=10**6),
                                       fault_plan=plan, timeout_s=0.0)
    flappers = []

    def spawn():
        s = FlakyServer(f"flap-{len(flappers)}").start()
        flappers.append(s)
        router.join(s.name, server=s)

    plan.bind_fleet(kill=lambda: core[1].stop(), spawn=spawn)
    transitions = []
    for _ in range(6):
        scaler.step()
        transitions.append(len(router.fleet_report()["members"]))
    fleet = router.fleet_report()
    router.stop()
    # tick 2 killed core-1 (ejected by the sweep), tick 3 spawned a
    # replacement; membership converged and stayed converged
    assert transitions[-1] == 2 and transitions[-1] == transitions[-2]
    assert "core-1" not in fleet["members"]
    assert fleet["members"]["flap-0"]["placeable"]


def _real_replica():
    srv = serve.Server(serve.ServeParams(max_coalesce=8, warm_start=False, prime=False),
                       seed=42, device="cpu")
    srv.registry.register_system("sys", A, context=SketchContext(seed=9))
    return srv


def test_die_under_load_drill_restores_capacity_no_visible_114(monkeypatch):
    """A replica dies abruptly under traffic at tick 2: the router fails
    its work over, the sweep ejects it, the autoscaler restores two
    placeable replicas, and every caller's answer is ok."""
    monkeypatch.setenv("SKYLARK_TELEMETRY", "1")
    telemetry.REGISTRY.reset()
    r1, r2 = _real_replica().start(), _real_replica().start()
    router = serve.Router(serve.RouterParams(heartbeat_timeout_s=0.0))
    router.join("r1", server=r1)
    router.join("r2", server=r2)
    plan = FleetFaultPlan(die_under_load_at=2)
    plan.bind_fleet(kill=lambda: r2.stop(0.5))
    scaler = serve.Autoscaler(
        router, lambda name: _real_replica(),
        serve.AutoscaleParams(min_replicas=1, max_replicas=2, queue_high=1e9,
                              queue_low=-1.0, p99_high_ms=1e-4, cooldown_ticks=0,
                              idle_ticks=10**6),
        fault_plan=plan)
    responses = []
    for _ in range(5):
        responses += [router.call(op="ls_solve", system="sys", b=b) for b in RHS[:2]]
        scaler.step()
    fleet = router.fleet_report()
    snap = telemetry.snapshot()
    router.stop()
    r1.stop()
    for srv in scaler._owned.values():
        srv.stop()
    telemetry.REGISTRY.reset()
    assert all(r["ok"] for r in responses)  # no 114, no error of any kind
    placeable = [n for n, m in fleet["members"].items() if m["placeable"]]
    assert len(placeable) == 2 and "r2" not in fleet["members"]
    assert any(n.startswith("auto-") for n in placeable)
    assert snap["router"]["ejects"] >= 1
    assert snap["autoscale"]["scale_ups"] >= 1


def test_join_storm_every_joiner_fenced_and_placeable():
    r1 = _real_replica().start()
    router = serve.Router()
    router.join("r1", server=r1)
    joined = []

    def spawn():
        srv = _real_replica().start()
        joined.append(srv)
        router.join(f"storm-{len(joined)}", server=srv)

    plan = FleetFaultPlan(join_storm_at=1, join_storm_size=3)
    plan.bind_fleet(spawn=spawn)
    scaler = serve.Autoscaler(router, lambda name: _real_replica(),
                              serve.AutoscaleParams(min_replicas=1, max_replicas=8,
                                                    idle_ticks=10**6),
                              fault_plan=plan)
    scaler.step()
    fleet = router.fleet_report()
    assert len(fleet["members"]) == 4
    assert all(m["placeable"] for m in fleet["members"].values())
    results = [router.call(op="ls_solve", system="sys", b=b) for b in RHS[:4]]
    assert all(r["ok"] for r in results)
    odd = serve.Server(serve.ServeParams(warm_start=False, prime=False), seed=42,
                       device="cpu")
    odd.registry.register_system("other", A, context=SketchContext(seed=9))
    odd.start()
    with pytest.raises(ex.WorldMismatchError):
        router.join("odd", server=odd)
    router.stop()
    odd.stop()
    r1.stop()
    for srv in joined:
        srv.stop()
