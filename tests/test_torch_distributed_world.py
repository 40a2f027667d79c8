"""Real multi-process worlds of the port on the CPU: gloo process groups
of 2 and 3 ranks (``torch.distributed``, a file store under
``tmp_path``, so parallel test workers never race for a port), each
rank a ``python`` process running
``libskylark_tpu_torch.tools.elastic_drill`` (the battery below runs it
with checks of its own after the runs).

- The streaming LS merge of a world of 2 and of 3 on exact data
  (integers, CWT) is bitwise the port's single-process pass and within
  the streaming solves' 1e-10 of the JAX package's world = 1 result; the
  same battery holds ``timer_report(distributed=True)``, the fleet
  snapshot (merged counters are the sums of the ranks'),
  ``cross_host_psum`` and its refusal of integer leaves.
- Kill one rank (a real SIGKILL after its first committed chunk), resume
  the world: bitwise the uninterrupted run, and the killed rank re-folds
  only its uncheckpointed batches.
- Repartition: a world of 2 killed and resumed as a world of 1, and a
  world of 1 killed and resumed as a world of 2, each bitwise the
  uninterrupted run at the new size (exact data).
- A rank that sleeps past a 2 s collective deadline: its peer exits with
  110 naming it, well within the deadline plus start-up.
- Ranks whose partitions disagree fail the handshake with 109.

Every spawned world has a 60 s subprocess timeout and a 30 s group
timeout.  A world that fails reports, for every rank, its exit code,
its seconds, the last phase it marked (``DRILL-PHASE``: start-up, group,
run, checks) and the last 40 lines of its stderr, in the assertion and
in ``world-<name>.txt`` under the test's ``tmp_path``, naming which
stage failed: start-up, the 60 s shared deadline, the 30 s group
timeout or the battery's checks (the 1e-10 comparison with the JAX
package says so in its own message).
"""

from __future__ import annotations

import functools
import json
import operator
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
import libskylark_tpu.plans.plan as jplan
from libskylark_tpu_torch.streaming import pinned_placer
from libskylark_tpu_torch.tools import elastic_drill

pytestmark = pytest.mark.chaos

REPO = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 60
EXACT = {"scenario": "lsq", "exact": True, "sketch": "CWT", "nrows": 96, "ncols": 5,
         "batch_rows": 4, "s": 24}

_BATTERY = r"""
import functools, operator, sys
import torch, torch.distributed as dist
from libskylark_tpu_torch import telemetry
from libskylark_tpu_torch.parallel import cross_host_psum
from libskylark_tpu_torch.parallel.collectives import gather_objects
from libskylark_tpu_torch.tools import elastic_drill
from libskylark_tpu_torch.utils.timer import PhaseTimer, timer_report


def setup(rank):
    def checks():
        world = dist.get_world_size()
        t = PhaseTimer()
        t.totals["work"], t.counts["work"] = 0.25 * (rank + 1), 1
        rep = t.report(distributed=True)
        assert f"over {world} processes" in rep, rep
        cols = next(line for line in rep.splitlines() if line.startswith("work")).split()
        assert float(cols[1]) == 0.25 and float(cols[2]) == 0.25 * world, rep
        print("CHECK timer-report OK", flush=True)
        try:
            timer_report({f"only_on_rank_{rank}": 1.0}, distributed=True)
        except RuntimeError as e:
            assert "different" in str(e)
            print("CHECK timer-mismatch OK", flush=True)

        local = telemetry.snapshot()
        fleet = telemetry.snapshot(fleet=True)
        every = gather_objects(local["counters"])
        for key in local["counters"]:
            # The merge's left fold in rank order: Python's sum() adds
            # floats compensated (3.12) and can differ in the last bit
            # over three ranks (the seconds counters).
            want = functools.reduce(operator.add, (c[key] for c in every), 0)
            assert fleet["counters"][key] == want, (key, fleet["counters"][key], want)
        assert fleet["counters"]["elastic.runs"] == world, fleet["counters"]
        print("CHECK fleet OK", flush=True)

        summed = cross_host_psum({"a": torch.full((3,), float(rank + 1), dtype=torch.float64)})
        assert summed["a"].tolist() == [world * (world + 1) / 2] * 3
        try:
            cross_host_psum({"n": torch.arange(3)})
        except TypeError:
            print("CHECK psum OK", flush=True)
        return {}

    return checks


sys.exit(elastic_drill.main(sys.argv[1:], setup=setup))
"""


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    for knob in ("SKYLARK_GUARD", "SKYLARK_COLLECTIVE_TIMEOUT_S", "SKYLARK_TELEMETRY"):
        monkeypatch.delenv(knob, raising=False)


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["SKYLARK_POLICY"] = "0"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def spawn_world(world: int, tmp: Path, spec: dict, *, name: str, root: Path,
                battery: bool = False, specs=None, env=None):
    """Start a world of ``world`` gloo ranks on the CPU; returns the
    ``Popen``s (rank order) and the out directory."""
    out = tmp / f"out-{name}"
    init = f"file://{tmp / f'store-{name}'}"
    procs = []
    for r in range(world):
        rank_spec = json.dumps((specs or {}).get(r, spec))
        entry = ["-c", _BATTERY] if battery else ["-m", "libskylark_tpu_torch.tools.elastic_drill"]
        cmd = [sys.executable, *entry, "--rank", str(r), "--world", str(world), "--init", init,
               "--group-timeout", "30", "--root", str(root), "--out", str(out),
               "--spec", rank_spec]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=str(tmp), env=env or _env()))
    return procs, out


def finish(procs, timeout: float = WORLD_TIMEOUT_S, seconds=None) -> list:
    """``[(returncode, stdout, stderr)]`` of every rank; every process is
    gone when this returns.  A rank still running at the shared deadline
    is killed and says so at the end of its stderr.  ``seconds``, a list,
    gets each rank's seconds from this call to its exit."""
    t0 = time.monotonic()
    deadline = t0 + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n[killed at the {timeout:g} s shared deadline]"
            outs.append((p.returncode, out, err))
            if seconds is not None:
                seconds.append(time.monotonic() - t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _stage(rc: int, stdout: str, stderr: str) -> str:
    """Which stage of a rank's life failed, from its output."""
    phases = [line.split()[1] for line in stderr.splitlines() if line.startswith("DRILL-PHASE")]
    if "shared deadline]" in stderr:
        return f"the {WORLD_TIMEOUT_S} s shared deadline (last phase: {phases[-1:] or 'none'})"
    if "start" not in phases:
        return "start-up (imports)"
    if any(w in stderr for w in ("Timed out", "timed out", "DistStoreError", "Timeout")):
        return "the 30 s group timeout"
    if "group" not in phases:
        return "start-up (joining the group)"
    if "checks" in phases and "leave" not in phases:
        return "the battery's checks"
    return "the run" if rc else "none"


def diagnose(outs, seconds, path: Path) -> str:
    """Every rank's exit code, seconds, stage and last 40 lines of
    stderr; written to ``path`` and returned."""
    lines = []
    for r, ((rc, so, se), s) in enumerate(zip(outs, seconds)):
        lines.append(f"rank {r}: rc={rc}, {s:.1f} s, failed stage: {_stage(rc, so, se)}; "
                     f"DRILL-OK {'in' if 'DRILL-OK' in so else 'not in'} stdout")
        lines += [f"  | {line}" for line in se.splitlines()[-40:]]
    text = "\n".join(lines)
    path.write_text(text + "\n")
    return f"{text}\n(also in {path})"


def report(stdout: str) -> dict:
    """A rank's JSON report, the line after its ``DRILL-OK``."""
    return json.loads(stdout.split("DRILL-OK", 1)[1].strip().splitlines()[0])


def run_world(world, tmp, spec, *, name, root, **kw):
    """A world that must succeed: every rank exits 0 with ``DRILL-OK`` and
    the same result; returns (x of rank 0, [(rc, stdout, stderr)])."""
    procs, out = spawn_world(world, tmp, spec, name=name, root=root, **kw)
    seconds = []
    outs = finish(procs, seconds=seconds)
    if not all(rc == 0 and "DRILL-OK" in so for rc, so, _ in outs):
        raise AssertionError(f"world {name!r} of {world} failed:\n"
                             + diagnose(outs, seconds, tmp / f"world-{name}.txt"))
    assert len({report(so)["runs"][0]["sha"] for _, so, _ in outs}) == 1  # one x everywhere
    return torch.load(out / "x-0.pt"), outs


def kill_world(world, tmp, spec, *, name, root, victim):
    """A world whose ``victim`` SIGKILLs itself: wait for its death, then
    end the survivors (blocked in a collective with a dead peer)."""
    procs, _ = spawn_world(world, tmp, spec, name=name, root=root)
    t0 = time.monotonic()
    try:
        rc = procs[victim].wait(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None  # still running at the shared deadline
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [(p.returncode, *p.communicate()) for p in procs]
    if rc != -9:
        what = "was still running at the shared deadline" if rc is None else f"exited {rc}"
        raise AssertionError(
            f"the victim (rank {victim}) {what} instead of its SIGKILL:\n"
            + diagnose(outs, [time.monotonic() - t0] * world, tmp / f"world-{name}.txt"))


def reference(spec: dict):
    """The port's single-process pass over the same stream, in this
    process (world = 1)."""
    factory, S = elastic_drill.lsq_problem(spec, "cpu")
    sp = T.streaming.StreamParams(placer=pinned_placer("cpu"), prefetch=0)
    x, _ = T.streaming.sketch_least_squares(factory, S, ncols=spec["ncols"],
                                            dtype=torch.float64, params=sp)
    return x, factory


def _progress(root: Path, rank: int, epoch: int = 0) -> list:
    path = Path(T.streaming.host_dir(root, rank, epoch)) / "progress.jsonl"
    return T.streaming.read_progress(path)


@pytest.mark.parametrize("world", [2, 3])
def test_exact_merge_and_battery(tmp_path, world):
    x, outs = run_world(world, tmp_path, EXACT, name="w", root=tmp_path / "root",
                        battery=True, env=_env(SKYLARK_TELEMETRY=1))
    for r, (_, so, _) in enumerate(outs):
        for check in ("timer-report", "timer-mismatch", "fleet", "psum"):
            assert f"CHECK {check} OK" in so, f"rank {r}: {check}\n{so}"
    want, factory = reference(EXACT)
    assert torch.equal(x, want), "world merge not bitwise world = 1"  # exact data
    Sj = J.sketch.create_sketch("CWT", 96, 24, J.SketchContext(seed=EXACT.get("seed", 5) + 8))

    def jfactory(start):
        for A_b, b_b in factory(start):
            yield jnp.asarray(A_b.numpy()), jnp.asarray(b_b.numpy())

    xj, _ = J.streaming.sketch_least_squares(jfactory, Sj, ncols=5)
    xj = np.asarray(xj)
    diff = np.abs(x.numpy() - xj).max()
    assert diff <= 1e-10 * np.abs(xj).max(), f"1e-10 comparison with the JAX package: {diff}"


def test_kill_one_rank_resume_is_bitwise(tmp_path):
    spec = {"scenario": "lsq"}
    want, _ = run_world(2, tmp_path, spec, name="ref", root=tmp_path / "ref")
    root = tmp_path / "root"
    kill_world(2, tmp_path, {**spec, "kill_after_chunk": 0, "fault_rank": 1}, name="kill",
               root=root, victim=1)
    before = [b["attrs"]["batch"] for b in _progress(root, 1) if b["name"] == "batch"]
    assert before and not [b for b in _progress(root, 1) if b["name"] == "done"]
    got, outs = run_world(2, tmp_path, {**spec, "resume": True}, name="resume", root=root)
    assert torch.equal(got, want)
    b0, b1 = T.streaming.RowPartition(96, 4, 2).batch_range(1)
    after = [b["attrs"]["batch"] for b in _progress(root, 1) if b["name"] == "batch"]
    # chunk 0 (batch b0) was committed: the resume re-folds b0 + 1 on
    assert after[len(before):] == list(range(b0 + 1, b1))


def test_shrink_two_to_one_is_bitwise(tmp_path):
    root = tmp_path / "root"
    kill_world(2, tmp_path, {**EXACT, "kill_after_chunk": 1, "fault_rank": 1}, name="kill",
               root=root, victim=1)
    # World 1 is this process: the repartitioned resume at world = 1.
    factory, S = elastic_drill.lsq_problem(EXACT, "cpu")
    part = T.streaming.RowPartition(96, 4, 1)
    params = T.streaming.ElasticParams(placer=pinned_placer("cpu"), prefetch=0,
                                       checkpoint_dir=str(root), checkpoint_every=1,
                                       resume=True, resume_policy="repartition")
    x, info = T.streaming.distributed_sketch_least_squares(
        factory, S, ncols=5, partition=part, dtype=torch.float64, params=params)
    want, _ = reference(EXACT)
    assert torch.equal(x, want)
    rep = info["replay"]
    assert rep["from_world"] == 2 and rep["to_world"] == 1 and rep["epoch"] == 1
    assert rep["completed_batches"] > 0 and rep["replayed_batches"] < 24


def test_grow_one_to_two_is_bitwise(tmp_path):
    root = tmp_path / "root"
    factory, S = elastic_drill.lsq_problem(EXACT, "cpu")
    params = T.streaming.ElasticParams(placer=pinned_placer("cpu"), prefetch=0,
                                       checkpoint_dir=str(root), checkpoint_every=1)
    with pytest.raises(T.resilient.SimulatedPreemption):
        T.streaming.distributed_sketch_least_squares(
            factory, S, ncols=5, partition=T.streaming.RowPartition(96, 4, 1),
            dtype=torch.float64, params=params,
            fault_plan=T.resilient.FaultPlan(preempt_after_chunk=9))
    want, _ = run_world(2, tmp_path, EXACT, name="ref", root=tmp_path / "ref")
    got, outs = run_world(2, tmp_path, {**EXACT, "resume": True,
                                        "resume_policy": "repartition"},
                          name="grow", root=root)
    assert torch.equal(got, want)
    info = json.loads((tmp_path / "out-grow" / "info-0.json").read_text())
    assert info["replay"]["from_world"] == 1 and info["replay"]["to_world"] == 2
    assert info["replay"]["completed_batches"] == 10


def test_hung_rank_times_out_with_110(tmp_path):
    spec = {"scenario": "lsq", "collective_timeout": 2.0, "slow_at_batch": 3,
            "slow_seconds": 40.0, "fault_rank": 1}
    procs, _ = spawn_world(2, tmp_path, spec, name="hung", root=tmp_path / "root")
    t0 = time.monotonic()
    try:
        out0, err0 = procs[0].communicate(timeout=WORLD_TIMEOUT_S)
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode == 110, f"{out0}\n{err0[-3000:]}"
    assert "DRILL-TIMEOUT phase=psum stragglers=[1]" in out0, out0
    assert waited < 30  # start-up plus the 2 s deadline, not the 40 s stall


def test_handshake_mismatch_raises_109(tmp_path):
    # Rank 1 runs another batch size: the same world, another partition.
    procs, _ = spawn_world(2, tmp_path, {"scenario": "lsq"}, name="mm",
                           root=tmp_path / "root",
                           specs={1: {"scenario": "lsq", "batch_rows": 8}})
    outs = finish(procs)
    for r, (rc, so, se) in enumerate(outs):
        assert rc != 0 and "WorldMismatchError" in se and "elastic handshake failed" in se, \
            f"rank {r} rc={rc}\n{so}\n{se[-2000:]}"
