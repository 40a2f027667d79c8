"""Port vs JAX package: the distributed BlockADMM trainer
(``ml/distributed.py``).

- Partition validation raises where the JAX package's does.
- World = 1 (no process group) is bitwise the port's
  ``BlockADMMSolver.train`` (the same step function; streamed feature
  rows equal the in-core rowwise apply's), for regular and Fastfood
  maps, regression and hinge classification, and within
  ``test_torch_admm.py``'s 1e-9 of the JAX package's
  ``DistributedBlockADMMTrainer`` (f64).
- A run preempted mid-stream, and one preempted after an ADMM chunk,
  resume bitwise (one process).
- Gloo worlds of 2 and 3: every rank's W and objective trace within 1e-9
  of the same problem at world = 1 (only the consensus sum's order
  differs), and a rank SIGKILLed after an ADMM checkpoint chunk and the
  world resumed bitwise the uninterrupted world.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
import libskylark_tpu.plans.plan as jplan
from libskylark_tpu.ml import distributed as jdist
from libskylark_tpu_torch.ml import distributed as tdist
from libskylark_tpu_torch.resilient import FaultPlan, SimulatedPreemption
from libskylark_tpu_torch.streaming import ElasticParams, RowPartition, pinned_placer
from libskylark_tpu_torch.utils.exceptions import InvalidParameters
from libskylark_tpu_torch.tools import elastic_drill
from test_torch_distributed_world import kill_world, run_world

pytestmark = pytest.mark.train

N, D_IN, BATCH = 32, 4, 4
TOL = 1e-9


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    monkeypatch.delenv("SKYLARK_GUARD", raising=False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def make_data():
    rng = np.random.default_rng(7)
    return rng.standard_normal((N, D_IN)), np.array([1.0, -1.0] * (N // 2))


def maps(pkg, tag, seed=11, per_map=32):
    kern = pkg.ml.GaussianKernel(D_IN, 2.0)
    ctx = pkg.SketchContext(seed=seed)
    return [kern.create_rft(per_map, tag, ctx) for _ in range(2)]


def source_of(X, y, part, to=torch.from_numpy):
    def factory(start):
        for b in range(start, part.num_batches):
            lo, hi = b * part.batch_rows, min((b + 1) * part.batch_rows, part.nrows)
            yield to(X[lo:hi]), to(y[lo:hi])

    return factory


def params(pkg, **kw):
    return pkg.ml.ADMMParams(**{"rho": 1.0, "lam": 0.01, "maxiter": 8,
                                "data_partitions": 2, **kw})


def elastic(**kw):
    return ElasticParams(placer=pinned_placer("cpu"), prefetch=0, **kw)


@pytest.mark.parametrize("P,world,batch", [(2, 1, 4), (5, 1, 4), (1, 2, 4), (0, 1, 4),
                                           (4, 2, 8), (3, 3, 4)])
def test_partition_validation_is_jax(P, world, batch):
    try:
        want = jdist.validate_train_partition(J.streaming.RowPartition(N, batch, world), P)
    except Exception as e:  # noqa: BLE001 — the JAX package's verdict, whatever it is
        with pytest.raises(InvalidParameters) as ei:
            tdist.validate_train_partition(RowPartition(N, batch, world), P)
        assert str(ei.value) == str(e)
    else:
        assert tdist.validate_train_partition(RowPartition(N, batch, world), P) == want


@pytest.mark.parametrize("tag", ["regular", "fast"])
@pytest.mark.parametrize("loss,regression", [("squared", True), ("hinge", False)])
def test_world_one_is_bitwise_block_admm_and_jax(tag, loss, regression):
    X, y = make_data()
    ref = T.ml.BlockADMMSolver(loss, "l2", maps(T, tag), params(T)).train(
        torch.from_numpy(X), torch.from_numpy(y) if regression else y, regression=regression)
    part = RowPartition(N, BATCH, 1)
    classes = None if regression else [-1.0, 1.0]
    model, info = tdist.DistributedBlockADMMTrainer(loss, "l2", maps(T, tag), params(T),
                                                    elastic()).train(
        source_of(X, y, part), part, regression=regression, classes=classes)
    assert torch.equal(model.W, ref.W) and model.history == ref.history
    assert info["iters"] == 8 and info["world_size"] == 1 and info["precision"] == "float64"
    jmodel, jinfo = jdist.DistributedBlockADMMTrainer(
        loss, "l2", maps(J, tag), params(J), J.streaming.ElasticParams(prefetch=0)).train(
        source_of(X, y, J.streaming.RowPartition(N, BATCH, 1), to=np.asarray),
        J.streaming.RowPartition(N, BATCH, 1), regression=regression, classes=classes)
    jW = np.asarray(jmodel.W)
    assert np.abs(model.W.numpy() - jW).max() <= TOL * np.abs(jW).max()
    assert np.abs(np.asarray(model.history) - np.asarray(jmodel.history)).max() <= \
        TOL * np.abs(np.asarray(jmodel.history)).max()
    assert abs(info["consensus_residual"] - jinfo["consensus_residual"]) <= \
        TOL * max(1.0, jinfo["consensus_residual"])


@pytest.mark.parametrize("where", ["stream", "train"])
def test_preempted_and_resumed_is_bitwise(tmp_path, where):
    X, y = make_data()
    part = RowPartition(N, BATCH, 1)

    def train(root, **kw):
        trainer = tdist.DistributedBlockADMMTrainer(
            "squared", "l2", maps(T, "fast"), params(T),
            elastic(checkpoint_dir=str(root), checkpoint_every=2, resume=kw.pop("resume", False)))
        return trainer.train(source_of(X, y, part), part, regression=True, **kw)

    want, _ = train(tmp_path / "ref")
    plan = FaultPlan(preempt_after_chunk=1)
    with pytest.raises(SimulatedPreemption):
        train(tmp_path / "root", **({"fault_plan": plan} if where == "stream"
                                    else {"train_fault_plan": plan}))
    got, info = train(tmp_path / "root", resume=True)
    assert torch.equal(got.W, want.W) and got.history == want.history


def held_to_world_one(tmp, spec, world, name, got):
    """Every rank's W (one hash on every rank, rank 0's saved) and
    objective trace against the drill's world = 1 run in this process
    (no group: ``BlockADMMSolver``'s own step), at TOL: only the
    consensus sum's order differs."""
    res = elastic_drill.run(spec, rank=0, device="cpu")
    want, hist = res["x"], np.asarray(res["info"]["history"])
    assert np.abs((got - want).numpy()).max() <= TOL * float(want.abs().max())
    for r in range(world):
        info = json.loads((tmp / f"out-{name}" / f"info-{r}.json").read_text())
        assert info["world_size"] == world and len(info["history"]) == hist.size
        assert np.abs(np.asarray(info["history"]) - hist).max() <= TOL * np.abs(hist).max()


@pytest.mark.parametrize("world,partitions,loss,tag", [(3, 6, "squared", "regular"),
                                                       (2, 2, "logistic", "fast")])
def test_world_merge_is_world_one(tmp_path, world, partitions, loss, tag):
    spec = {"scenario": "train", "nrows": 96, "batch_rows": 4, "tag": tag, "maxiter": 6,
            "partitions": partitions, "loss": loss}
    got, _ = run_world(world, tmp_path, spec, name="w", root=tmp_path / "root")
    held_to_world_one(tmp_path, spec, world, "w", got)


def test_two_rank_kill_after_admm_chunk_resume_is_bitwise(tmp_path):
    spec = {"scenario": "train", "nrows": 96, "batch_rows": 4, "tag": "fast", "maxiter": 6,
            "checkpoint_every": 2, "loss": "hinge"}
    want, outs = run_world(2, tmp_path, spec, name="ref", root=tmp_path / "ref")
    assert all('"rfut_rowwise": 0' in so for _, so, _ in outs)  # CPU: the plain twins
    held_to_world_one(tmp_path, spec, 2, "ref", want)
    root = tmp_path / "root"
    kill_world(2, tmp_path, {**spec, "train_kill_after_chunk": 1, "fault_rank": 1},
               name="kill", root=root, victim=1)
    got, _ = run_world(2, tmp_path, {**spec, "resume": True}, name="resume", root=root)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all()) and got.shape == (32, 2)
