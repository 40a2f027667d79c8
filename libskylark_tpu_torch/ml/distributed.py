"""Elastic multi-process BlockADMM kernel-machine training (port of
``libskylark_tpu/ml/distributed.py``).

≙ the reference's MPI training topology (``ml/BlockADMM.hpp:374-590``
maps data partitions to ranks and reduces ``Wbar`` every iteration) on
the port's substrates: each rank of a ``torch.distributed`` world
streams its row partition of the training set through
:func:`~libskylark_tpu_torch.streaming.elastic.elastic_run_stream` (the
manifest, handshake and epoch-fence contract, codes 109/110/111),
materializes its feature blocks batch by batch through
:func:`~libskylark_tpu_torch.plans.apply_rowwise_bucketed`, runs the
iteration of :class:`~.admm.BlockADMMSolver` over its own partitions
under the resilient ``init_state/step_chunk/extract_result`` contract,
and sums the consensus over the ranks ONCE per iteration with
:func:`~libskylark_tpu_torch.parallel.cross_host_psum`.

Bitwise contracts (``tests/test_torch_distributed_train.py``):

- **world = 1 ≡ ``BlockADMMSolver.train``**: the streamed rowwise
  feature rows are the in-process rowwise apply's rows (row-independent
  maps: the Fastfood kernels and the elementwise epilogues), and with no
  collective to cross the iteration is the SAME step function
  (``admm._admm_step``), captured as one CUDA graph where
  ``BlockADMMSolver`` captures it.
- **kill/resume**: commits happen only after a chunk's last consensus
  sum completed on EVERY rank, so all ranks hold the same chunk
  boundary; a SIGKILLed and resumed run replays from it and reproduces
  the uninterrupted model bitwise (same blocks, order, operations, and
  the backend's fixed summation order for one world).
- **consensus decomposition**: the global leaves (``Wbar``, ``W``,
  ``mu``, ``obj``) are computed identically on every rank from the
  summed ``Σ_partitions Wi``; per-partition leaves stay on their rank.
  At world > 1 the step runs eagerly (a collective cannot sit inside a
  captured graph), so bits are not promised across world sizes.

The policy decides the precision rung (bf16 or fp8 operand rounding of
the feature blocks, full-precision accumulation, kind ``"train"``);
attempt 0 is guard-certified, and a bad certificate on ANY rank
escalates EVERY rank back to full precision (a world verdict by a second
sum), recorded in ``info["recovery"]`` and observed into the profile
store.  ``resume_policy="repartition"`` rides
:func:`~libskylark_tpu_torch.streaming.repartition.resolve_resume`:
feature buffers are row slots (positional, not sums), so a world change
re-streams the NEW share at the bumped epoch.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from .. import guard, plans, policy, telemetry
from ..core.precision import round_to_e4m3
from ..core.random import _const
from ..parallel.collectives import cross_host_psum
from ..resilient.chunked import ChunkedSolver, stepper
from ..resilient.runner import ResilientParams, ResilientRunner
from ..solvers.prox import get_loss, get_regularizer
from ..streaming.drivers import _result_dtype
from ..streaming.elastic import (ElasticParams, RowPartition, _make_watchdog,
                                 _require_real_world, _resolve_world, elastic_run_stream,
                                 host_dir)
from ..streaming.engine import stream_device
from ..streaming.repartition import resolve_resume
from ..utils.exceptions import InvalidParameters
from ..utils.timer import PhaseTimer
from .admm import ADMMParams, _admm_step, _factor, _targets
from .model import FeatureMapModel

__all__ = [
    "KIND",
    "DistributedBlockADMMTrainer",
    "prepare_rank_admm",
    "rank_chunked_solver",
    "stream_feature_blocks",
    "validate_train_partition",
]

KIND = "distributed_block_admm"


def validate_train_partition(partition: RowPartition, data_partitions: int) -> int:
    """Check that every rank's row range covers WHOLE ADMM data
    partitions; returns the rows per partition ``ni``.  A partition split
    across ranks would have no owner for its per-partition leaves: pick
    ``batch_rows`` and world sizes whose row-range boundaries land on
    multiples of ``nrows / data_partitions``."""
    P = int(data_partitions)
    n = int(partition.nrows)
    if P < 1:
        raise InvalidParameters(f"data_partitions must be >= 1, got {P}")
    if n % P:
        raise InvalidParameters(f"n={n} not divisible by data_partitions={P}")
    ni = n // P
    for r in range(partition.world_size):
        r0, r1 = partition.row_range(r)
        if r1 <= r0:
            raise InvalidParameters(f"rank {r} owns no rows ([{r0}, {r1})); every rank needs "
                                    "at least one data partition")
        if r0 % ni or r1 % ni:
            raise InvalidParameters(
                f"rank {r} rows [{r0}, {r1}) don't align with the {P}-partition boundaries "
                f"(every {ni} rows); choose batch_rows so partition boundaries land on batch "
                "boundaries")
    return ni


def stream_feature_blocks(source, maps: Sequence, partition: RowPartition,
                          params: ElasticParams | None = None, *, dtype=None, targets: int = 1,
                          scale_maps: bool = False, kind: str = KIND, fault_plan=None,
                          report=None, epoch: int = 0):
    """This rank's feature-block pass: its row window streamed through
    :func:`elastic_run_stream`, every feature map applied to each batch
    by :func:`~libskylark_tpu_torch.plans.apply_rowwise_bucketed` (one
    plan per bucket), the rows written into row-slot buffers at the
    batch's local offset.  The writes are in place (the buffers are the
    pass's whole output, so a copy per batch would move them all every
    batch); a guard replay of a chunk re-writes the same slots.

    Returns ``(Z_rows, Y_rows, local_batches)``: ``Z_rows[j]`` the
    ``(ni_local, s_j)`` rowwise feature block of map ``j``, ``Y_rows``
    the ``(ni_local, targets)`` target rows.
    """
    params = params or ElasticParams()
    rank, world = _resolve_world(params)
    partition.validate_world(rank, world)
    r0, r1 = partition.row_range(rank)
    ni = r1 - r0
    dt, dev = _result_dtype(dtype), stream_device(params)
    t = int(targets)
    d = int(maps[0].n) if maps else None

    def init_at(row0: int):
        return {"rows": np.asarray(row0, np.int64),
                "y": torch.zeros((ni, t), dtype=dt, device=dev),
                "z": [torch.zeros((ni, int(S.s)), dtype=dt, device=dev) for S in maps]}

    def step(acc, batch, index):
        X_b, y_b = batch
        if X_b.layout == torch.sparse_coo:
            X_b = X_b.to_dense()
        k = int(X_b.shape[0])
        off = int(acc["rows"]) - r0
        for S, buf in zip(maps, acc["z"]):
            Z = plans.apply_rowwise_bucketed(S, X_b, true_rows=k)
            if scale_maps:
                Z = Z * _const(math.sqrt(S.s / d), Z.dtype, Z.device)
            buf.narrow(0, off, k).copy_(Z)
        yb = torch.as_tensor(y_b).to(device=dev, dtype=dt).reshape(k, t)
        acc["y"].narrow(0, off, k).copy_(yb)
        return {"rows": np.asarray(off + r0 + k, np.int64), "y": acc["y"], "z": acc["z"]}

    acc, nbatches = elastic_run_stream(source, step, init_at(r0), partition, params, kind=kind,
                                       fault_plan=fault_plan, report=report, epoch=epoch)
    rows = int(acc["rows"])
    if rows != r1:
        raise ValueError(f"rank {rank} folded rows [{r0}, {rows}) but its partition share is "
                         f"[{r0}, {r1}); the source and partition disagree")
    return list(acc["z"]), acc["y"], int(nbatches)


@dataclass
class _RankPrepared:
    """What a rank's training loop needs that is NOT checkpointed state:
    rebuilt deterministically from the streamed blocks on resume."""

    Zs: list
    Cinvs: list
    Yp: Any
    timer: PhaseTimer
    loss: Any
    reg: Any
    d: int
    classes: Any
    dtype: Any
    P_local: int
    P_total: int
    D: int
    k: int


def _round(Z, compute_dtype):
    """Feature operands rounded through the policy's low dtype and back
    (operand compression, full-precision accumulation)."""
    if compute_dtype == "float8_e4m3fn":
        return round_to_e4m3(Z).to(Z.dtype)
    return Z.to(getattr(torch, str(compute_dtype))).to(Z.dtype)


def prepare_rank_admm(loss, regularizer, maps: Sequence, admm: ADMMParams,
                      partition: RowPartition, rank: int, Z_rows: Sequence, Y_rows, *,
                      classes=None, regression: bool = False,
                      compute_dtype=None) -> _RankPrepared:
    """This rank's partitioned blocks (P_local, ni, s_j), cached
    (Z·Zᵀ + I)⁻¹ factors and partitioned targets.  ``compute_dtype`` (the
    policy's precision rung) rounds the feature blocks through the low
    dtype before factoring; None keeps the full-precision path bitwise."""
    loss = get_loss(loss) if isinstance(loss, str) else loss
    reg = get_regularizer(regularizer) if isinstance(regularizer, str) else regularizer
    P_total = int(admm.data_partitions)
    ni_p = validate_train_partition(partition, P_total)
    r0, r1 = partition.row_range(int(rank))
    P_local = (r1 - r0) // ni_p
    dtype, dev = Z_rows[0].dtype, Z_rows[0].device

    timer = PhaseTimer()
    with timer.phase("transform") as ph:
        # (ni_local, s_j) rows → (P_local, ni, s_j): the in-process
        # trainer's partitioned layout, as a view.
        Zs = [Z.reshape(P_local, ni_p, Z.shape[1]) for Z in Z_rows]
        if compute_dtype is not None:
            Zs = [_round(Z, compute_dtype) for Z in Zs]
        ph.result = Zs
    if regression:
        Y = Y_rows
    else:
        if classes is None and partition.world_size > 1:
            raise InvalidParameters("distributed classification needs the GLOBAL class set "
                                    "passed explicitly (each rank only sees its own labels)")
        Y = Y_rows[:, 0]
    Yp, k, classes = _targets(loss, Y, classes, regression, P_local, ni_p, dtype, dev)
    Cinvs = _factor(Zs, timer)
    return _RankPrepared(Zs=Zs, Cinvs=Cinvs, Yp=Yp, timer=timer, loss=loss, reg=reg,
                         d=int(maps[0].n), classes=classes, dtype=dtype, P_local=P_local,
                         P_total=P_total, D=int(sum(int(S.s) for S in maps)), k=int(k))


def rank_chunked_solver(prep: _RankPrepared, maps: Sequence, admm: ADMMParams, *,
                        merge=None) -> ChunkedSolver:
    """This rank's training loop as a ``ChunkedSolver`` over
    ``BlockADMMSolver``'s state, its per-partition leaves sized to the
    rank's share.  ``merge=None`` (world = 1) runs the single-process
    step itself, captured as a CUDA graph where ``BlockADMMSolver``
    captures it, so the world = 1 trainer is bitwise ``train``.  A
    callable ``merge`` (the distributed trainer passes the watchdogged
    ``cross_host_psum``) sums the consensus inside each eager step."""
    maxiter = int(admm.maxiter)
    state0, step, graphed = _admm_step(prep.loss, prep.reg, maps, admm, prep.Zs, prep.Cinvs,
                                       prep.Yp, prep.k, prep.P_total, merge=merge)
    advance = stepper(step, graphed)

    def step_chunk(st, num_iters: int):
        k = min(int(num_iters), maxiter - int(st["it"]))
        out = advance(st, k)
        if k and telemetry.enabled():
            telemetry.inc("train.iterations", k)
            telemetry.inc("train.consensus", k)
        # A graph's static state is overwritten by its next replay.
        return {key: v.clone() for key, v in out.items()} if graphed and out is not st else out

    def extract_result(st):
        it = int(st["it"])
        model = FeatureMapModel(list(maps), st["Wbar"].clone(), scale_maps=admm.scale_maps,
                                input_dim=prep.d, classes=prep.classes)
        model.history = st["objs"][:it].tolist()
        model.val_history = []
        model.timers = prep.timer
        model.iterations = it
        # ‖W − Wbar‖_F: both leaves are global, so every rank agrees.
        model.consensus_residual = float(torch.linalg.vector_norm(st["W"] - st["Wbar"]))
        return model

    return ChunkedSolver(
        init_state=lambda: {key: v.clone() for key, v in state0.items()},
        step_chunk=step_chunk,
        extract_result=extract_result,
        is_done=lambda st: int(st["it"]) >= maxiter,
        iteration=lambda st: int(st["it"]),
        kind=KIND,
    )


class DistributedBlockADMMTrainer:
    """Multi-process elastic BlockADMM trainer (≙ the reference's MPI
    ``skylark_ml`` training topology).

    Every rank of the ``torch.distributed`` world calls :meth:`train`
    with the same arguments; each streams its own row partition, trains
    in lockstep (one consensus sum per iteration) and returns the same
    model.  Simulated-rank tests compose :func:`stream_feature_blocks`,
    :func:`prepare_rank_admm` and :func:`rank_chunked_solver` and merge
    by hand.
    """

    def __init__(self, loss: str, regularizer: str, feature_maps: Sequence,
                 params: ADMMParams | None = None, elastic: ElasticParams | None = None):
        self.loss = get_loss(loss)
        self.regularizer = get_regularizer(regularizer)
        self.maps = list(feature_maps)
        if not self.maps:
            raise InvalidParameters("DistributedBlockADMMTrainer needs at least one feature map")
        self.params = params or ADMMParams()
        self.elastic = elastic or ElasticParams()

    def train(self, source, partition: RowPartition, *, classes=None, regression: bool = False,
              dtype=None, targets: int | None = None, fault_plan=None, train_fault_plan=None,
              compute_dtype=None, registry=None, register_as: str | None = None,
              epoch: int = 0):
        """Train over the partitioned stream; returns ``(model, info)``.

        ``source`` is the GLOBAL batch factory (``f(start_batch) ->
        iterator`` of ``(X_batch, y_batch)``) every rank receives;
        ``fault_plan`` rides the streaming pass, ``train_fault_plan`` the
        iteration runner (they count different chunks).
        ``registry``/``register_as`` put the trained model into a serve
        registry at the end.
        """
        p, ep = self.params, self.elastic
        kind = KIND
        validate_train_partition(partition, p.data_partitions)
        _require_real_world(partition)
        rank, world = _resolve_world(ep)
        partition.validate_world(rank, world)
        dt = _result_dtype(dtype)
        t = int(targets or 1)
        D = int(sum(int(S.s) for S in self.maps))
        guarded = guard.enabled()
        report = (guard.RecoveryReport(stage=kind) if guarded
                  else guard.RecoveryReport.disabled(kind))
        if telemetry.enabled():
            telemetry.inc("train.runs")

        # The "train" kind decides only the precision rung; an empty or
        # immature store keeps the full-precision default bitwise.
        k_policy = len(classes) if classes is not None else t
        decision = policy.consult("train", m=partition.nrows, n=D, targets=k_policy, dtype=dt,
                                  device=stream_device(ep), sketch_size=D, guard_on=guarded)
        cd = compute_dtype if compute_dtype is not None else decision.compute_dtype

        replay = None
        if getattr(ep, "resume_policy", "strict") == "repartition":
            epoch, plan = resolve_resume(ep.checkpoint_dir, partition, kind=kind, params=ep)
            if plan is not None:
                # Feature buffers are row slots, not sums: a world change
                # re-streams the NEW share at the bumped epoch; within it
                # the stream and the ADMM state keep their checkpoints.
                replay = plan.replay_info()
                if telemetry.enabled():
                    telemetry.inc("train.repartitions")
        watchdog = (_make_watchdog(ep, ep.checkpoint_dir, rank, world, epoch)
                    if ep.checkpoint_dir else None)

        with telemetry.span("train.stream", kind=kind, rank=rank):
            Z_rows, Y_rows, nbatches = stream_feature_blocks(
                source, self.maps, partition, ep, dtype=dt, targets=t,
                scale_maps=p.scale_maps, kind=kind, fault_plan=fault_plan, report=report,
                epoch=epoch)

        def prep_at(rung):
            with telemetry.span("train.factor", kind=kind, rung=str(rung)):
                return prepare_rank_admm(self.loss, self.regularizer, self.maps, p, partition,
                                         rank, Z_rows, Y_rows, classes=classes,
                                         regression=regression, compute_dtype=rung)

        prep = prep_at(cd)
        escalated = False
        if guarded:
            # Attempt 0's certificate is a WORLD decision: the bad flags
            # and chunk replay counts sum over the ranks, so every rank
            # takes the same rung even when only one saw the failure.
            ok = guard.tree_all_finite(prep.Cinvs) and guard.tree_all_finite(prep.Zs)
            local_replays = sum(1 for a in report.attempts if a.action == "replay")
            votes = cross_host_psum(
                torch.tensor([0.0 if ok else 1.0, float(local_replays)], dtype=torch.float64,
                             device=prep.Zs[0].device),
                watchdog=watchdog, phase="verdict")
            world_bad, world_replays = (int(v) for v in votes.tolist())
            report.record("initial", verdict=guard.OK if not world_bad else guard.FALLBACK,
                          detail=f"factor finiteness at rung {cd or str(dt).removeprefix('torch.')}")
            report.record("world", detail=f"psum verdict over {world} rank(s): bad_certs="
                                          f"{world_bad}, chunk_replays={world_replays}")
            if world_bad:
                if cd is None:
                    raise guard.NumericalHealthError(
                        "non-finite Cholesky factors at full precision", stage=kind,
                        report=report)
                report.record("escalate", verdict=guard.FALLBACK,
                              detail=f"{cd} factors non-finite; full-precision rebuild "
                                     "(world verdict)")
                report.recovered = True
                decision.escalated = True
                escalated = True
                cd = None
                prep = prep_at(None)
                if telemetry.enabled():
                    telemetry.inc("train.escalations")

        chunked = rank_chunked_solver(
            prep, self.maps, p,
            merge=(None if world == 1 else
                   lambda tree: cross_host_psum(tree, watchdog=watchdog, phase="consensus")))
        rp = ResilientParams(
            checkpoint_dir=(os.path.join(host_dir(ep.checkpoint_dir, rank, epoch), "train")
                            if ep.checkpoint_dir else None),
            checkpoint_every=ep.checkpoint_every, keep_last=ep.keep_last, resume=ep.resume,
            expect_epoch=int(epoch) if ep.checkpoint_dir else None)
        runner = ResilientRunner(
            chunked, rp,
            metadata={"elastic": {"rank": rank, "world": world, "epoch": int(epoch),
                                  "signature": int(partition.signature())}},
            fault_plan=train_fault_plan)
        with telemetry.span("train.iterate", kind=kind):
            model = runner.run()

        rung = str(cd) if cd else str(dt).removeprefix("torch.")
        info = {
            "rows": int(partition.nrows),
            "batches": int(partition.num_batches),
            "local_batches": int(nbatches),
            "world_size": int(partition.world_size),
            "rank": int(rank),
            "data_partitions": int(p.data_partitions),
            "features": D,
            "blocks": len(self.maps),
            "iters": int(model.iterations),
            "objective": model.history[-1] if model.history else None,
            "consensus_residual": model.consensus_residual,
            "precision": rung,
            "escalated": escalated,
            "resume_policy": getattr(ep, "resume_policy", "strict"),
            "epoch": int(epoch),
            "recovery": report.to_dict(),
            "replay": replay,
            "policy": decision.to_dict(),
            "registered": register_as,
        }
        model.info = info
        notes = {}
        if decision.compute_dtype == "bfloat16":
            notes["bf16"] = "fail" if escalated else "ok"
        elif decision.compute_dtype == "float8_e4m3fn":
            notes["fp8"] = "fail" if escalated else "ok"
        policy.observe(decision, info, default_size=D, batches=nbatches, **notes)
        if registry is not None and register_as:
            # Every rank holds the same bits: registering locally is
            # world-consistent.
            registry.register_model(register_as, model)
            if telemetry.enabled():
                telemetry.inc("train.registered")
        telemetry.run_summary(kind, info)
        return model, info
