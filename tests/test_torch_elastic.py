"""Port vs JAX package: the elastic layer in one process
(``streaming/elastic.py``, ``streaming/repartition.py``,
``parallel/collectives.py``, the host faults of ``resilient/faults.py``).

- ``RowPartition``: the JAX arithmetic, signatures and messages.
- World = 1 (no process group) of every ``partition=`` route is bitwise
  the port's single-process route, and within the streaming tolerances
  of the JAX package's route (f64: 1e-12 for the sketches, 1e-10 for the
  solves; the graph sketch bitwise).
- Simulated ranks folded through ``elastic_run_stream`` and merged by
  hand, their ledgers and manifests, single-rank kill and resume
  bitwise, the 109 guards (manifest, world resolution), the epoch fence
  and the watchdog's 110/111 (JAX ``test_elastic.py``, ``test_chaos.py``).
- The files are the JAX package's: the manifest written by either
  package is the same bytes, and the repartition planner of each
  package, run on a root written by the other, writes byte-identical
  ``plan-0001.json`` and ``epoch.json``.
- Shrink 4 → 2 and grow 2 → 4 over simulated ranks (exact data) are
  bitwise the in-core sketch.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
import libskylark_tpu.plans.plan as jplan
from libskylark_tpu import streaming as jst
from libskylark_tpu.graph import stream as jgs
from libskylark_tpu.parallel import CollectiveWatchdog as JWatchdog
from libskylark_tpu.streaming import repartition as jrep
from libskylark_tpu_torch import streaming as tst
from libskylark_tpu_torch.graph import stream as tgs
from libskylark_tpu_torch.parallel import CollectiveWatchdog, cross_host_psum
from libskylark_tpu_torch.resilient import (FaultPlan, HostFaultPlan, SimulatedPreemption,
                                            corrupt_manifest, tear_ledger_tail)
from libskylark_tpu_torch.sketch.base import Dimension
from libskylark_tpu_torch.streaming import (ElasticParams, HostLedger, RowPartition,
                                            elastic_run_stream, host_dir, pinned_placer,
                                            read_progress)
from libskylark_tpu_torch.streaming import repartition as trep
from libskylark_tpu_torch.streaming.elastic import MANIFEST_NAME, PROGRESS_NAME
from libskylark_tpu_torch.utils.exceptions import (CollectiveTimeoutError, InvalidParameters,
                                                   StaleEpochError, WorldMismatchError)

pytestmark = pytest.mark.streaming

N, M, S_OUT = 60, 5, 16
BATCH = 7  # 9 batches, the last ragged
KIND = "distributed_streaming_sketch"
SKETCH_TOL, SOLVE_TOL = 1e-12, 1e-10


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    for knob in ("SKYLARK_GUARD", "SKYLARK_COLLECTIVE_TIMEOUT_S", "SKYLARK_NO_FUSED_CHUNKS"):
        monkeypatch.delenv(knob, raising=False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


def _rel(port, ref) -> float:
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def factory_of(*arrays, batch=BATCH, to=torch.from_numpy):
    def factory(start):
        for lo in range(start * batch, arrays[0].shape[0], batch):
            sl = tuple(to(a[lo:lo + batch]) for a in arrays)
            yield sl[0] if len(sl) == 1 else sl

    return factory


def cpu_elastic(**kw):
    return ElasticParams(placer=pinned_placer("cpu"), prefetch=0, **kw)


def _pair(kind, seed=21, n=N):
    Sj = J.sketch.create_sketch(kind, n, S_OUT, J.SketchContext(seed=seed))
    return Sj, T.sketch.from_json(Sj.to_json())


# -- RowPartition ----------------------------------------------------------------


@pytest.mark.parametrize("nrows,batch_rows,world", [(60, 7, 1), (60, 7, 2), (60, 7, 4),
                                                    (60, 7, 9), (60, 7, 16), (64, 8, 3),
                                                    (1, 1, 1), (5, 100, 2)])
def test_row_partition_arithmetic_is_jax(nrows, batch_rows, world):
    pj, pt = jst.RowPartition(nrows, batch_rows, world), RowPartition(nrows, batch_rows, world)
    assert pt.num_batches == pj.num_batches
    assert [pt.batch_range(r) for r in range(world)] == [pj.batch_range(r) for r in range(world)]
    assert [pt.row_range(r) for r in range(world)] == [pj.row_range(r) for r in range(world)]
    assert pt.to_json() == pj.to_json() and pt.signature() == pj.signature()
    assert RowPartition.from_json(json.loads(json.dumps(pt.to_json()))) == pt


@pytest.mark.parametrize("call", [
    lambda P: P(0, 7, 1), lambda P: P(60, -1, 1), lambda P: P(60, 7, 0),
    lambda P: P(60, 7, 2).batch_range(2), lambda P: P(60, 7, 2).validate_world(0, 4),
    lambda P: P(60, 7, 2).validate_world(3, 2)])
def test_row_partition_messages_are_jax(call):
    with pytest.raises(Exception) as ej:
        call(jst.RowPartition)
    with pytest.raises(Exception) as et:
        call(RowPartition)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)
    assert et.value.code == ej.value.code and et.value.code in (102, 109)


# -- world = 1 parity of every partition= route -----------------------------------


@pytest.mark.parametrize("kind", ["JLT", "CWT", "SJLT"])
def test_sketch_partition_world_one(rng, kind):
    A = rng.standard_normal((N, M))
    Sj, St = _pair(kind)
    part = RowPartition(N, BATCH, 1)
    plain = tst.sketch(factory_of(A), St, ncols=M, dtype=torch.float64,
                       params=tst.StreamParams(placer=pinned_placer("cpu")))
    got = tst.sketch(factory_of(A), St, ncols=M, dtype=torch.float64, partition=part,
                     params=cpu_elastic())
    assert torch.equal(got, plain)
    want = jst.sketch(factory_of(A, to=jnp.asarray), Sj, ncols=M,
                      partition=jst.RowPartition(N, BATCH, 1))
    assert _rel(got, want) <= SKETCH_TOL


@pytest.mark.parametrize("kind", ["JLT", "CWT"])
def test_least_squares_partition_world_one(rng, kind):
    A, b = rng.standard_normal((N, M)), rng.standard_normal(N)
    Sj, St = _pair(kind)
    part = RowPartition(N, BATCH, 1)
    plain, _ = tst.sketch_least_squares(factory_of(A, b), St, ncols=M, dtype=torch.float64,
                                        params=tst.StreamParams(placer=pinned_placer("cpu")))
    got, info = tst.sketch_least_squares(factory_of(A, b), St, ncols=M, dtype=torch.float64,
                                         partition=part, params=cpu_elastic())
    assert torch.equal(got, plain)
    assert (info["rows"], info["batches"], info["local_batches"]) == (N, 9, 9)
    assert (info["world_size"], info["rank"], info["replay"]) == (1, 0, None)
    want, jinfo = jst.sketch_least_squares(factory_of(A, b, to=jnp.asarray), Sj, ncols=M,
                                           partition=jst.RowPartition(N, BATCH, 1))
    assert _rel(got, want) <= SOLVE_TOL
    assert [a["action"] for a in info["recovery"]["attempts"]] == \
        [a["action"] for a in jinfo["recovery"]["attempts"]]


def test_streaming_least_squares_partition_world_one(rng):
    A, b = rng.standard_normal((N, M)), rng.standard_normal(N)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ctx = T.SketchContext(seed=3)
        plain, _ = T.linalg.streaming_least_squares(
            factory_of(A, b), N, M, ctx, stream_params=tst.StreamParams(
                placer=pinned_placer("cpu")))
        got, info = T.linalg.streaming_least_squares(
            factory_of(A, b), N, M, T.SketchContext(seed=3), stream_params=cpu_elastic(),
            partition=RowPartition(N, BATCH, 1))
    finally:
        torch.set_default_dtype(old)
    assert torch.equal(got, plain) and info["policy"]["route"] == "sketch"
    want, _ = J.linalg.streaming_least_squares(
        factory_of(A, b, to=jnp.asarray), N, M, J.SketchContext(seed=3),
        partition=jst.RowPartition(N, BATCH, 1))
    assert _rel(got, want) <= SOLVE_TOL


def test_graph_partition_world_one(rng):
    edges = list(map(tuple, rng.integers(0, 64, (400, 2)).tolist()))
    Gj, Gt = J.graph.SimpleGraph(edges), T.graph.SimpleGraph(edges)
    Sj, St = (J.sketch.create_sketch("SJLT", Gt.n, 24, J.SketchContext(seed=1)), None)
    St = T.sketch.from_json(Sj.to_json())
    nedges = sum(1 for _ in jgs.graph_block_source(Gj, 1)(0))
    plain = tgs.streamed_adjacency_sketch(tgs.graph_block_source(Gt, 50), St, ncols=Gt.n,
                                          dtype=torch.float32,
                                          params=tst.StreamParams(placer=pinned_placer("cpu")))
    got = tgs.streamed_adjacency_sketch(tgs.graph_block_source(Gt, 50), St, ncols=Gt.n,
                                        dtype=torch.float32,
                                        partition=RowPartition(nedges, 50, 1),
                                        params=cpu_elastic())
    assert torch.equal(got, plain)
    want = jgs.streamed_adjacency_sketch(jgs.graph_block_source(Gj, 50), Sj, ncols=Gj.n,
                                         dtype=np.float32,
                                         partition=jst.RowPartition(nedges, 50, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    X, lam = tgs.streaming_ase(tgs.graph_block_source(Gt, 50), Gt.n, 2, T.SketchContext(seed=4),
                               dtype=torch.float32, partition=RowPartition(nedges, 50, 1),
                               stream_params=cpu_elastic())
    X0, lam0 = tgs.streaming_ase(tgs.graph_block_source(Gt, 50), Gt.n, 2,
                                 T.SketchContext(seed=4), dtype=torch.float32,
                                 stream_params=tst.StreamParams(placer=pinned_placer("cpu")))
    assert torch.equal(X, X0) and torch.equal(lam, lam0)


def test_partition_route_errors(rng):
    _, St = _pair("JLT")
    part = RowPartition(N, BATCH, 1)
    A = rng.standard_normal((N, M))
    with pytest.raises(ValueError, match="columnwise-only"):
        tst.sketch(factory_of(A), T.sketch.JLT(M, S_OUT, T.SketchContext(seed=2)), "rowwise",
                   partition=part)
    with pytest.raises(ValueError, match="ncols"):
        tst.sketch(factory_of(A), St, "columnwise", partition=part)
    # A simulated world of 2 in one process would return an unmerged
    # partial: refused (a card at world > 1 without a group too).
    with pytest.raises(InvalidParameters, match="live torch.distributed world of 2"):
        tst.sketch(factory_of(A), St, ncols=M, partition=RowPartition(N, BATCH, 2),
                   params=cpu_elastic())
    with pytest.raises(InvalidParameters, match="partition covers"):
        tst.sketch(factory_of(A), St, ncols=M, partition=RowPartition(N + 1, BATCH, 1),
                   params=cpu_elastic())


def test_cross_host_psum_is_identity_at_world_one(rng):
    tree = {"sa": torch.from_numpy(rng.standard_normal((3, 4))),
            "n": torch.arange(3)}  # not even the int leaf is looked at
    assert cross_host_psum(tree) is tree
    assert T.streaming.world_info() == (0, 1)


# -- simulated ranks ----------------------------------------------------------------


def rank_fold(A, S, part, rank, root, *, resume=False, fault_plan=None, kind=KIND,
              checkpoint_every=1):
    """One simulated rank's partial fold of columnwise S·A."""
    r0, _ = part.row_range(rank)
    init = {"sa": torch.zeros((S.s, A.shape[1]), dtype=torch.float64),
            "row": np.asarray(r0, np.int64)}

    def step(acc, block, index):
        row = int(acc["row"])
        return {"sa": tst.engine.accumulate_slice(S, acc["sa"], block, row),
                "row": np.asarray(row + block.shape[0], np.int64)}

    params = cpu_elastic(rank=rank, world_size=part.world_size,
                         checkpoint_dir=str(root) if root is not None else None,
                         checkpoint_every=checkpoint_every, resume=resume)
    return elastic_run_stream(factory_of(A), step, init, part, params, kind=kind,
                              fault_plan=fault_plan)


def jax_rank_fold(A, Sj, part, rank, root, *, fault_plan=None):
    """The same fold by the JAX package (its own root's files)."""
    r0, _ = part.row_range(rank)
    init = {"sa": jnp.zeros((Sj.s, A.shape[1]), jnp.float64), "row": np.asarray(r0, np.int64)}

    def step(acc, block, index):
        row = int(acc["row"])
        return {"sa": J.plans.accumulate_slice(Sj, acc["sa"], block, row),
                "row": np.asarray(row + block.shape[0], np.int64)}

    params = jst.ElasticParams(rank=rank, world_size=part.world_size, checkpoint_dir=str(root),
                               checkpoint_every=1, prefetch=0)
    return jst.elastic_run_stream(factory_of(A, to=jnp.asarray), step, init,
                                  jst.RowPartition(part.nrows, part.batch_rows,
                                                   part.world_size),
                                  params, kind=KIND, fault_plan=fault_plan)


def test_two_rank_merge_matches_in_core_apply(rng, tmp_path):
    A = rng.standard_normal((N, M))
    Sj, St = _pair("JLT", seed=31)
    part = RowPartition(N, BATCH, 2)
    partials = []
    for rank in range(2):
        acc, nbatches = rank_fold(A, St, part, rank, tmp_path)
        b0, b1 = part.batch_range(rank)
        assert nbatches == b1 - b0 and int(acc["row"]) == part.row_range(rank)[1]
        partials.append(acc["sa"])
    merged = St.finalize_slices(partials[0] + partials[1], Dimension.COLUMNWISE)
    assert _rel(merged, np.asarray(Sj.apply(jnp.asarray(A), "columnwise"))) <= SKETCH_TOL
    assert _rel(merged, St.apply(torch.from_numpy(A), "columnwise")) <= SKETCH_TOL


def test_ledgers_and_manifests_are_the_jax_files(rng, tmp_path):
    A = rng.standard_normal((N, M))
    Sj, St = _pair("JLT", seed=32)
    part = RowPartition(N, BATCH, 2)
    for rank in range(2):
        rank_fold(A, St, part, rank, tmp_path / "t")
        jax_rank_fold(A, Sj, part, rank, tmp_path / "j")
    for rank in range(2):
        hdir, jdir = host_dir(tmp_path / "t", rank), jst.host_dir(tmp_path / "j", rank)
        with open(os.path.join(hdir, MANIFEST_NAME), "rb") as f1, \
                open(os.path.join(jdir, MANIFEST_NAME), "rb") as f2:
            assert f1.read() == f2.read()
        recs, jrecs = (read_progress(os.path.join(d, PROGRESS_NAME)) for d in (hdir, jdir))
        strip = [(r["seq"], r["kind"], r["name"], r["attrs"]) for r in recs]
        assert strip == [(r["seq"], r["kind"], r["name"], r["attrs"]) for r in jrecs]
        b0, b1 = part.batch_range(rank)
        assert [r["attrs"]["batch"] for r in recs if r["name"] == "batch"] == list(range(b0, b1))
        assert all(set(r) == {"ts", "seq", "pid", "kind", "name", "attrs"} for r in recs)


def test_kill_one_rank_resume_is_bitwise(rng, tmp_path):
    A = rng.standard_normal((N, M))
    _, St = _pair("JLT", seed=33)
    part = RowPartition(N, BATCH, 2)
    want, _ = rank_fold(A, St, part, 1, tmp_path / "ref")
    root = tmp_path / "elastic"
    with pytest.raises(SimulatedPreemption):
        rank_fold(A, St, part, 1, root, fault_plan=FaultPlan(preempt_after_chunk=1))
    killed = read_progress(os.path.join(host_dir(root, 1), PROGRESS_NAME))
    got, nbatches = rank_fold(A, St, part, 1, root, resume=True)
    b0, b1 = part.batch_range(1)
    assert nbatches == b1 - b0 and torch.equal(got["sa"], want["sa"])
    recs = read_progress(os.path.join(host_dir(root, 1), PROGRESS_NAME))
    assert [r["attrs"]["batch"] for r in recs[len(killed):] if r["name"] == "batch"] == \
        list(range(b0 + 2, b1))


@pytest.mark.parametrize("other", [RowPartition(N, BATCH, 4), RowPartition(N, BATCH + 3, 2)])
def test_resume_under_another_partition_raises_109(rng, tmp_path, other):
    A = rng.standard_normal((N, M))
    _, St = _pair("JLT", seed=34)
    part = RowPartition(N, BATCH, 2)
    rank_fold(A, St, part, 0, tmp_path)
    with pytest.raises(WorldMismatchError) as ei:
        rank_fold(A, St, other, 0, tmp_path, resume=True)
    assert ei.value.code == 109
    assert ei.value.expected["signature"] == part.signature()
    assert ei.value.got["signature"] == other.signature()


def test_world_resolution_mismatch_raises_109_without_disk(rng):
    A = rng.standard_normal((N, M))
    with pytest.raises(WorldMismatchError) as ei:
        elastic_run_stream(factory_of(A), lambda a, b, i: a, {"row": np.asarray(0)},
                           RowPartition(N, BATCH, 2), cpu_elastic(rank=0, world_size=3))
    assert ei.value.code == 109


# -- ledgers, fences, the watchdog -------------------------------------------------------


def test_host_ledger_schema_seq_and_torn_tail(tmp_path):
    path = tmp_path / "progress.jsonl"
    led = HostLedger(path, rank=3, epoch=2)
    led.record("batch", batch=7, local=0)
    led.close()
    tear_ledger_tail(path)
    recs = read_progress(path)
    assert [r["seq"] for r in recs] == [1]
    assert recs[0]["attrs"] == {"rank": 3, "epoch": 2, "batch": 7, "local": 0}
    # The next incarnation continues past the last intact seq.
    led2 = HostLedger(path, rank=3, epoch=2)
    assert led2.record("done", batches=1) == 2
    led2.close()
    assert read_progress(tmp_path / "absent.jsonl") == []
    assert read_progress is T.telemetry.fleet.read_progress  # one copy
    assert trep.read_epoch is T.telemetry.fleet.read_epoch


def test_stale_writer_is_fenced_with_111(rng, tmp_path):
    A = rng.integers(-9, 10, (N, M)).astype(np.float64)
    _, St = _pair("CWT", seed=35)
    plan = HostFaultPlan(bump_epoch_at=2)
    with pytest.raises(StaleEpochError) as ei:
        rank_fold(A, St, RowPartition(N, BATCH, 2), 0, tmp_path, fault_plan=plan)
    assert ei.value.code == 111 and trep.read_epoch(tmp_path)["epoch"] == 1


def test_watchdog_names_stragglers_and_fences(tmp_path):
    from libskylark_tpu_torch.parallel.collectives import Pending

    class Never:
        def is_completed(self):
            return False

        def wait(self):
            raise AssertionError("a timed-out collective is never waited for")

    wd = CollectiveWatchdog(tmp_path, rank=0, world=3, epoch=0, deadline_s=0.3, poll_s=0.05)
    CollectiveWatchdog(tmp_path, rank=1, world=3).beat("psum")
    with pytest.raises(CollectiveTimeoutError) as ei:
        wd.guard("psum", lambda: Pending([Never()], lambda: None))
    assert ei.value.code == 110 and ei.value.stragglers == [2] and ei.value.phase == "psum"
    # The heartbeat files are the JAX package's.
    jwd = JWatchdog(tmp_path / "j", rank=0, world=3, epoch=0)
    jwd.beat("psum")
    ours = json.loads((tmp_path / "heartbeats" / "rank-00000.json").read_text())
    theirs = json.loads((tmp_path / "j" / "heartbeats" / "rank-00000.json").read_text())
    assert list(ours) == list(theirs) and ours["phase"] == theirs["phase"] == "psum"
    assert wd.peers() == {0: ours, 1: json.loads(
        (tmp_path / "heartbeats" / "rank-00001.json").read_text())}
    CollectiveWatchdog(tmp_path, rank=2, world=3, epoch=1).beat("psum")
    with pytest.raises(StaleEpochError):
        wd.guard("psum", lambda: Pending([Never()], lambda: None))
    inline = CollectiveWatchdog(tmp_path, rank=0, world=3)
    assert inline.deadline_s is None
    assert inline.guard("psum", lambda: Pending([], lambda: 42)) == 42


def test_watchdog_deadline_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYLARK_COLLECTIVE_TIMEOUT_S", "1.5")
    assert CollectiveWatchdog(tmp_path).deadline_s == 1.5


def test_collective_timeout_error_is_jax():
    import libskylark_tpu.utils.exceptions as JE

    e = T.utils.CollectiveTimeoutError("m", phase="psum", deadline_s=2.0, stragglers=[1])
    assert e.code == JE.CollectiveTimeoutError.code == 110
    assert (e.phase, e.deadline_s, e.stragglers) == ("psum", 2.0, [1])
    assert "CollectiveTimeoutError" in T.utils.__all__


# -- repartition: the JAX planner's plan bytes, both ways ---------------------------


def _damaged_world(root, fold, A, S):
    """A world of 4 that died: ranks 0 and 1 finished, rank 2 committed
    one batch, rank 3 never started; rank 1 then turned hostile."""
    part = RowPartition(N, BATCH, 4)
    fold(A, S, part, 0, root)
    fold(A, S, part, 1, root)
    with pytest.raises(Exception):
        fold(A, S, part, 2, root, fault_plan=FaultPlan(preempt_after_chunk=0))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("hostile", [False, True])
def test_plan_bytes_are_the_jax_planner_s(rng, tmp_path, writer, hostile):
    A = rng.integers(-9, 10, (N, M)).astype(np.float64)
    Sj, St = _pair("CWT", seed=36)
    root = tmp_path / "root"
    if writer == "port":
        _damaged_world(root, rank_fold, A, St)
    else:
        def jfold(A_, S_, part, rank, root_, fault_plan=None):
            jp = None if fault_plan is None else J.resilient.FaultPlan(preempt_after_chunk=0)
            return jax_rank_fold(A_, Sj, part, rank, root_, fault_plan=jp)

        _damaged_world(root, jfold, A, St)
    if hostile:
        corrupt_manifest(host_dir(root, 1))
    for new_world in (2, 3):
        tdir, jdir = tmp_path / f"t{new_world}", tmp_path / f"j{new_world}"
        shutil.copytree(root, tdir)
        shutil.copytree(root, jdir)
        scan_t = trep.scan_coverage(tdir, kind=KIND)
        scan_j = jrep.scan_coverage(jdir, kind=KIND)
        assert [r.to_json() for r in scan_t["refs"]] == [r.to_json() for r in scan_j["refs"]]
        assert scan_t["lost_hosts"] == scan_j["lost_hosts"]
        plan_t = trep.replan_resume(tdir, RowPartition(N, BATCH, new_world), kind=KIND)
        plan_j = jrep.replan_resume(jdir, jst.RowPartition(N, BATCH, new_world), kind=KIND)
        for name in ("plan-0001.json", "epoch.json"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
        assert plan_t.signature() == plan_j.signature()
        assert plan_t.completed == ([(0, 3), (5, 6)] if hostile else [(0, 6)])


def execute_all_ranks(plan, A, S, root):
    """Every rank's share of ``plan`` in this process, summed (the merge
    a real world would do)."""
    world = plan.partition.world_size

    def init_at(row0):
        return {"sa": torch.zeros((S.s, M), dtype=torch.float64),
                "row": np.asarray(row0, np.int64)}

    def step(acc, block, index):
        row = int(acc["row"])
        return {"sa": tst.engine.accumulate_slice(S, acc["sa"], block, row),
                "row": np.asarray(row + block.shape[0], np.int64)}

    total = info = None
    for rank in range(world):
        partial, info = trep.execute_rank_plan(
            plan, factory_of(A), params=cpu_elastic(rank=rank, world_size=world,
                                                    checkpoint_dir=str(root),
                                                    checkpoint_every=1),
            root=str(root), init_at=init_at, step_fn=step, kind=KIND)
        total = partial["sa"] if total is None else total + partial["sa"]
    return total, info


@pytest.mark.parametrize("old,new,completed", [(4, 2, [(0, 6)]), (2, 4, [(0, 6)])])
def test_shrink_and_grow_are_bitwise(rng, tmp_path, old, new, completed):
    A = rng.integers(-9, 10, (N, M)).astype(np.float64)
    _, St = _pair("CWT", seed=37)
    part = RowPartition(N, BATCH, old)
    if old == 4:  # ranks 0, 1 done; rank 2 one batch; rank 3 never started
        rank_fold(A, St, part, 0, tmp_path)
        rank_fold(A, St, part, 1, tmp_path)
        with pytest.raises(SimulatedPreemption):
            rank_fold(A, St, part, 2, tmp_path, fault_plan=FaultPlan(preempt_after_chunk=0))
    else:  # rank 0 done ([0, 5)); rank 1 one batch of [5, 9)
        rank_fold(A, St, part, 0, tmp_path)
        with pytest.raises(SimulatedPreemption):
            rank_fold(A, St, part, 1, tmp_path, fault_plan=FaultPlan(preempt_after_chunk=0))
    plan = trep.replan_resume(tmp_path, RowPartition(N, BATCH, new), kind=KIND)
    assert plan.completed == completed and plan.residual == [(6, 9)]
    total, info = execute_all_ranks(plan, A, St, tmp_path)
    assert torch.equal(total, St.apply(torch.from_numpy(A), "columnwise"))
    assert info["replayed"] == [[6, 9]] and info["to_world"] == new
    assert trep.read_epoch(tmp_path)["epoch"] == 1
    # An old-world writer is fenced at its next record.
    with pytest.raises(StaleEpochError):
        rank_fold(A, St, part, old - 1, tmp_path)


def test_resolve_resume_policies(rng, tmp_path):
    A = rng.integers(-9, 10, (N, M)).astype(np.float64)
    _, St = _pair("CWT", seed=38)
    part2 = RowPartition(N, BATCH, 2)
    rank_fold(A, St, part2, 0, tmp_path)
    strict = cpu_elastic(checkpoint_dir=str(tmp_path), resume=True)
    assert trep.resolve_resume(str(tmp_path), part2, kind=KIND, params=strict) == (0, None)
    rep = cpu_elastic(checkpoint_dir=str(tmp_path), resume=True, resume_policy="repartition")
    assert trep.resolve_resume(str(tmp_path), part2, kind=KIND, params=rep) == (0, None)
    epoch, plan = trep.resolve_resume(str(tmp_path), RowPartition(N, BATCH, 1), kind=KIND,
                                      params=rep)
    assert epoch == 1 and plan.epoch == 1
    again = trep.resolve_resume(str(tmp_path), RowPartition(N, BATCH, 1), kind=KIND,
                                params=rep)
    assert again[0] == 1 and again[1].signature() == plan.signature()  # idempotent
    with pytest.raises(WorldMismatchError):
        trep.resolve_resume(str(tmp_path), part2, kind="other", params=rep)
    with pytest.raises(InvalidParameters):
        cpu_elastic(resume_policy="bogus")
