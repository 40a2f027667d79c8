"""Elastic multi-process streaming: preemption-safe out-of-core sketching
over a ``torch.distributed`` world (port of
``libskylark_tpu/streaming/elastic.py``).

The stream itself is sharded and a rank's loss is a local replay:

- :class:`RowPartition` gives each rank a deterministic, contiguous batch
  range of the global stream, from ``(nrows, batch_rows, world_size)``
  alone, so every process and every restart computes the same split.
- Each rank folds its range through the single-process
  :func:`~.engine.run_stream` engine with the accumulator's row cursor
  started at the rank's global row offset: its partial sketch uses the
  counter windows an unsharded pass realizes for those rows
  (columnwise ``S·A`` is a sum of window applies, ``apply_slice``).
- Partials merge with one cross-process sum
  (:func:`~libskylark_tpu_torch.parallel.cross_host_psum`), then
  ``finalize_slices`` runs on the merged sum.

The port runs one process per card: the caller initializes the
``torch.distributed`` process group (the ``--distributed`` drivers do so
from the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
environment ``torchrun`` sets) and sets the rank's device; the group's
backend (NCCL, or gloo for CPU worlds and several ranks on one card) is
the group's own.  :func:`world_info` reads the group, ``(0, 1)`` without
one.

Robustness: each rank owns ``host-<rank:05d>/`` under the shared
checkpoint root, with its ``CheckpointStore`` slots, a ``manifest.json``
(world size, row partition, epoch, kind) and a ``progress.jsonl`` ledger
in the telemetry run-ledger schema (``{ts, seq, pid, kind, name,
attrs}``), all in the JAX package's formats.  SIGKILL one rank, restart
the world with ``resume=True``: every rank reloads its newest
checkpoint, the killed rank re-folds only its uncheckpointed batches and
the merged result is bitwise the uninterrupted run's.  A resume under
another world size or partition is caught by the manifest check and a
pre-fold handshake (an all-gather of ``(world, partition signature,
epoch, kind)``) and raises
:class:`~libskylark_tpu_torch.utils.exceptions.WorldMismatchError` (109);
with ``resume_policy="repartition"`` the drivers hand the root to
:mod:`.repartition` instead, which adopts the durable partials and
re-folds the rest under a bumped epoch that fences stale writers out
(:class:`~libskylark_tpu_torch.utils.exceptions.StaleEpochError`, 111).
Collectives are deadline-bounded by
:class:`~libskylark_tpu_torch.parallel.CollectiveWatchdog` when
``collective_timeout_s`` (or ``SKYLARK_COLLECTIVE_TIMEOUT_S``) is set.
"""

from __future__ import annotations

import copy
import json
import os
import time
import zlib
from dataclasses import dataclass
from itertools import islice

import numpy as np
import torch

from .. import guard, telemetry
from ..parallel.collectives import (CollectiveWatchdog, cross_host_psum, gather_vectors,
                                    world_info)
from ..telemetry.fleet import PROGRESS_NAME, read_progress
from ..utils.exceptions import InvalidParameters, StaleEpochError, WorldMismatchError
from .engine import StreamParams, as_block_factory, run_stream, stream_device

__all__ = [
    "RowPartition",
    "ElasticParams",
    "HostLedger",
    "read_progress",
    "world_info",
    "host_dir",
    "elastic_run_stream",
    "distributed_sketch",
    "distributed_sketch_least_squares",
]

MANIFEST_NAME = "manifest.json"
_MANIFEST_VERSION = 1


@dataclass(frozen=True)
class RowPartition:
    """Deterministic contiguous split of a batched row stream over ranks.

    The global stream is ``num_batches = ceil(nrows / batch_rows)``
    batches of ``batch_rows`` rows (the last one ragged).  Rank ``r`` owns
    batches ``[batch_range(r))``, balanced contiguous ranges with the
    first ``num_batches % world_size`` ranks taking one extra, and so
    rows ``[row_range(r))``.  Pure arithmetic on ``(nrows, batch_rows,
    world_size)``: restarted ranks re-address the same counter windows.
    """

    nrows: int
    batch_rows: int
    world_size: int

    def __post_init__(self):
        for name in ("nrows", "batch_rows", "world_size"):
            v = getattr(self, name)
            if int(v) != v or int(v) < 1:
                raise InvalidParameters(f"RowPartition.{name} must be a positive int, got {v!r}")
            object.__setattr__(self, name, int(v))

    @property
    def num_batches(self) -> int:
        return -(-self.nrows // self.batch_rows)

    def batch_range(self, rank: int) -> tuple[int, int]:
        """Global batch indices ``[start, end)`` owned by ``rank``."""
        if not 0 <= rank < self.world_size:
            raise InvalidParameters(f"rank {rank} outside world of {self.world_size}")
        base, extra = divmod(self.num_batches, self.world_size)
        start = rank * base + min(rank, extra)
        return start, start + base + (1 if rank < extra else 0)

    def row_range(self, rank: int) -> tuple[int, int]:
        """Global row indices ``[start, end)`` owned by ``rank``."""
        b0, b1 = self.batch_range(rank)
        return b0 * self.batch_rows, min(b1 * self.batch_rows, self.nrows)

    def to_json(self) -> dict:
        return {"nrows": self.nrows, "batch_rows": self.batch_rows,
                "world_size": self.world_size}

    @classmethod
    def from_json(cls, d: dict) -> "RowPartition":
        return cls(nrows=d["nrows"], batch_rows=d["batch_rows"], world_size=d["world_size"])

    def signature(self) -> int:
        """CRC32 of the canonical JSON: the partition's identity in
        manifests and the handshake."""
        return zlib.crc32(json.dumps(self.to_json(), sort_keys=True).encode())

    def validate_world(self, rank: int, world_size: int) -> None:
        """Fail fast (109) when the resolved world disagrees with this
        partition: the resume-under-another-world guard."""
        if world_size != self.world_size:
            raise WorldMismatchError(
                f"stream partitioned for world size {self.world_size} but this process "
                f"resolves a world of {world_size}; repartition (and restart from scratch) "
                "instead of merging mismatched partials",
                expected=self.world_size, got=world_size)
        if not 0 <= rank < world_size:
            raise WorldMismatchError(f"rank {rank} outside world of {world_size}",
                                     expected=f"0 <= rank < {world_size}", got=rank)


class ElasticParams(StreamParams):
    """:class:`~.engine.StreamParams` plus the world overrides of an
    elastic pass.

    ``rank``/``world_size`` default to the live world (:func:`world_info`);
    tests override them to fold a simulated rank, manifest, ledger and
    partition checks included, inside one process.  ``checkpoint_dir``
    is the SHARED root; each rank keeps ``host-<rank:05d>/`` under it.
    ``resume_policy``: ``"strict"`` fails a resume under another world
    with 109, ``"repartition"`` adopts the old world's durable partials
    (:mod:`.repartition`).  ``collective_timeout_s`` bounds the handshake
    and merge collectives (110 on expiry; None waits, and
    ``SKYLARK_COLLECTIVE_TIMEOUT_S`` applies when set).
    """

    def __init__(self, *, rank: int | None = None, world_size: int | None = None,
                 resume_policy: str = "strict", collective_timeout_s: float | None = None,
                 **kw):
        super().__init__(**kw)
        self.rank = rank
        self.world_size = world_size
        if resume_policy not in ("strict", "repartition"):
            raise InvalidParameters(
                f"resume_policy must be 'strict' or 'repartition', got {resume_policy!r}")
        self.resume_policy = resume_policy
        self.collective_timeout_s = collective_timeout_s


def _resolve_world(params) -> tuple[int, int]:
    live_rank, live_world = world_info()
    rank = getattr(params, "rank", None)
    world = getattr(params, "world_size", None)
    return (live_rank if rank is None else int(rank),
            live_world if world is None else int(world))


def host_dir(root, rank: int, epoch: int = 0) -> str:
    """A rank's state directory under the shared root: ``host-<rank>/``
    at epoch 0 (the pre-repartition layout), under ``epoch-<e:04d>/``
    after a repartition, so a new world never overwrites the old
    world's durable partials while it merges them."""
    base = str(root)
    if int(epoch) > 0:
        base = os.path.join(base, f"epoch-{int(epoch):04d}")
    return os.path.join(base, f"host-{int(rank):05d}")


class HostLedger:
    """A rank's JSONL progress ledger, one record per FOLDED batch, in the
    telemetry run-ledger schema (``kind="elastic"``).  Each record is
    flushed: after a SIGKILL the file shows which batches this
    incarnation folded (at most one torn trailing line, which
    :func:`read_progress` skips).  ``seq`` continues from the existing
    file.  ``fence`` (a zero-argument callable, the epoch fence) runs
    before every record, so a writer of a superseded world dies with
    :class:`~libskylark_tpu_torch.utils.exceptions.StaleEpochError` at its
    next record."""

    def __init__(self, path, *, rank: int, epoch: int = 0, fence=None):
        self.path = str(path)
        self.rank = int(rank)
        self.epoch = int(epoch)
        self.fence = fence
        self._seq = 0
        for rec in read_progress(self.path):
            self._seq = max(self._seq, int(rec.get("seq", 0)))
        self._fh = open(self.path, "a", encoding="utf-8")

    def record(self, name: str, **attrs) -> int:
        if self.fence is not None:
            self.fence()
        self._seq += 1
        rec = {"ts": round(time.time(), 6), "seq": self._seq, "pid": os.getpid(),
               "kind": "elastic", "name": name,
               "attrs": {"rank": self.rank, "epoch": self.epoch, **attrs}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        return self._seq

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


def _manifest_payload(partition, rank, kind, epoch) -> dict:
    return {"skylark_object_type": "elastic_manifest", "format_version": _MANIFEST_VERSION,
            "kind": str(kind), "epoch": int(epoch), "rank": int(rank),
            "partition": partition.to_json(), "signature": partition.signature()}


def _check_manifest(hdir, partition, rank, kind, epoch, resume) -> None:
    """Verify (on resume), then (re)write, the rank's manifest: state
    under ``hdir`` was written for one ``(partition, rank, kind)``, and a
    resume under any other raises 109 before a stale slot is loaded."""
    os.makedirs(hdir, exist_ok=True)
    path = os.path.join(hdir, MANIFEST_NAME)
    want = _manifest_payload(partition, rank, kind, epoch)
    keys = ("kind", "rank", "partition", "signature")
    if resume and os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as fh:
                have = json.load(fh)
        except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WorldMismatchError(
                f"unreadable elastic manifest {path}: {e}; the host directory cannot be "
                "certified against this partition", expected=want, got=None)
        for key in keys:
            if have.get(key) != want[key]:
                raise WorldMismatchError(
                    f"elastic resume mismatch: checkpoint state in {hdir} was written for "
                    f"{key}={have.get(key)!r}, this run wants {key}={want[key]!r} (world size "
                    "or row partition changed; restart from scratch)",
                    expected={k: have.get(k) for k in keys}, got={k: want[k] for k in keys})
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(want, fh)
    os.replace(tmp, path)


def _epoch_fence(root, epoch: int):
    """A zero-argument callable raising 111 once the shared root's epoch
    marker moved past ``epoch`` (the world repartitioned without this
    process); the ledger runs it before every record, which precedes
    every commit."""
    from .repartition import read_epoch

    root, epoch = str(root), int(epoch)

    def fence():
        est = read_epoch(root)
        if est is not None and int(est.get("epoch", 0)) > epoch:
            if telemetry.enabled():
                telemetry.inc("elastic.fenced")
                telemetry.event("elastic", "fenced",
                                {"epoch": epoch, "root_epoch": int(est["epoch"])})
            raise StaleEpochError(
                f"this writer runs at elastic epoch {epoch} but the shared root advanced to "
                f"epoch {est.get('epoch')}: the world repartitioned past this process; its "
                "partials are superseded and must not be written",
                expected=epoch, got=int(est.get("epoch", 0)))

    return fence


def _make_watchdog(params, root, rank, world, epoch):
    """The collective watchdog of a real multi-process world (a single
    process has no peers to wait on, and writes no heartbeats)."""
    if world_info()[1] <= 1:
        return None
    return CollectiveWatchdog(root, rank=rank, world=world, epoch=epoch,
                              deadline_s=getattr(params, "collective_timeout_s", None))


def _handshake(partition, rank, world, kind, epoch, extra: int = 0, watchdog=None) -> None:
    """Every live process all-gathers ``(world, partition signature,
    epoch, kind crc, extra)`` and checks the others': a drifted rank
    (stale restart script, wrong epoch, other partition constants) is
    caught by every rank before any fold or merge, and the all-gather is
    the barrier that keeps a fast rank from merging before a slow one
    joined.  Single-process worlds skip it.  ``extra`` is one more
    world-deterministic word (the repartition plan's CRC); ``watchdog``
    bounds the gather (110)."""
    if world_info()[1] <= 1:
        return
    mine = np.asarray([int(world), int(partition.signature()), int(epoch),
                       zlib.crc32(str(kind).encode()), int(extra) & 0xFFFFFFFF], np.int64)
    # The gather is the barrier, so its wall time is this rank's wait for
    # its peers: the first to arrive waits longest.
    t_wait = time.monotonic() if telemetry.enabled() else None
    theirs = gather_vectors(mine, watchdog=watchdog, phase="handshake")
    if t_wait is not None:
        wait_ms = (time.monotonic() - t_wait) * 1e3
        telemetry.observe_phase("collective_wait", wait_ms)
        telemetry.set_gauge("collective.last_wait_ms", round(wait_ms, 4))
        telemetry.set_gauge("collective.rank", rank)
    for r in range(theirs.shape[0]):
        if not np.array_equal(theirs[r], mine):
            raise WorldMismatchError(
                f"elastic handshake failed: rank {rank} sees (world, partition, epoch, kind) = "
                f"{mine.tolist()} but process {r} announced {theirs[r].tolist()}; refusing to "
                "merge across mismatched worlds",
                expected=mine.tolist(), got=theirs[r].tolist())
    if telemetry.enabled():
        telemetry.event("elastic", "handshake",
                        {"rank": rank, "world": world, "epoch": int(epoch),
                         "signature": int(partition.signature()), "kind": kind})


def _local_params(params, hdir, expect_epoch: int | None = None) -> StreamParams:
    """This rank's view of the shared params: a copy with its checkpoints
    under the rank's host directory and its restores pinned to its
    epoch, every other knob as given.  The placer is kept: the default
    one stages on the port's default device, which a rank process sets
    to its own card."""
    local = copy.copy(params)
    local.checkpoint_dir, local.expect_epoch = hdir, expect_epoch
    return local


def elastic_run_stream(source, step_fn, init_acc, partition: RowPartition,
                       params: ElasticParams | StreamParams | None = None, *,
                       kind: str = "elastic_pass", metadata: dict | None = None,
                       fault_plan=None, report=None, epoch: int = 0):
    """This rank's share of a partitioned stream fold.

    ``source`` is the GLOBAL batch factory (``f(start_batch) ->
    iterator`` over all ``partition.num_batches`` batches, the same on
    every rank); the rank's window is a seek-and-bound
    (``factory(global_start)`` and ``islice``).  ``step_fn(acc, block,
    local_index)`` sees LOCAL batch indices (checkpoints and fault plans
    are local to the rank); global addressing is the accumulator's row
    cursor, which the caller starts at the rank's global row offset.

    Returns ``(acc, local_batches)``, the UNMERGED partial.  Raises 109
    when the resolved world disagrees with ``partition``, when the
    manifest on disk was written for another partition, or when the
    handshake sees a drifted rank.
    """
    params = params or ElasticParams()
    rank, world = _resolve_world(params)
    partition.validate_world(rank, world)
    start_b, end_b = partition.batch_range(rank)
    nlocal = end_b - start_b
    global_factory = as_block_factory(source)

    def local_factory(local_start: int):
        if not 0 <= local_start <= nlocal:
            raise ValueError(f"local start batch {local_start} outside this rank's range of "
                             f"{nlocal} batches")
        return islice(iter(global_factory(start_b + local_start)), nlocal - local_start)

    ledger = watchdog = None
    local_params = _local_params(params, None)
    if params.checkpoint_dir:
        root = params.checkpoint_dir
        fence = _epoch_fence(root, epoch)
        fence()  # a stale incarnation dies before touching any state
        hdir = host_dir(root, rank, epoch)
        _check_manifest(hdir, partition, rank, kind, epoch, params.resume)
        local_params = _local_params(params, hdir, expect_epoch=epoch)
        ledger = HostLedger(os.path.join(hdir, PROGRESS_NAME), rank=rank, epoch=epoch,
                            fence=fence)
        watchdog = _make_watchdog(params, root, rank, world, epoch)
        if fault_plan is not None and hasattr(fault_plan, "bind_host"):
            fault_plan.bind_host(hdir=hdir, root=str(root), epoch=epoch)

    host_hooks = fault_plan is not None and hasattr(fault_plan, "before_batch")
    step = step_fn
    if ledger is not None or host_hooks:
        last = {"b": -1}

        def step(acc, block, b):
            if host_hooks:
                fault_plan.before_batch(b)
            out = step_fn(acc, block, b)
            # Ledgered at fold time, once per index: a guard replay
            # re-folds the same indices and must not count them twice.
            if ledger is not None and b > last["b"]:
                ledger.record("batch", batch=int(start_b + b), local=int(b))
                last["b"] = b
            return out

    _handshake(partition, rank, world, kind, epoch, watchdog=watchdog)
    if telemetry.enabled():
        r0, r1 = partition.row_range(rank)
        telemetry.inc("elastic.runs")
        telemetry.event("elastic", "partition", {
            "kind": kind, "rank": rank, "world": world, "epoch": int(epoch),
            "batches": [start_b, end_b], "rows": [r0, r1],
            "signature": int(partition.signature())})
    meta = dict(metadata or {})
    meta.update(elastic={"rank": rank, "world": world, "epoch": int(epoch),
                         "signature": int(partition.signature())})
    try:
        acc, nbatches = run_stream(local_factory, step, init_acc, local_params, kind=kind,
                                   metadata=meta, fault_plan=fault_plan, report=report)
    finally:
        params.prefetch_stats = local_params.prefetch_stats
    if ledger is not None:
        ledger.record("done", batches=int(nbatches))
        ledger.close()
    return acc, nbatches


def _require_real_world(partition) -> None:
    """The distributed drivers MERGE across processes, so a simulated
    world (one process, ``world_size`` > 1) would return an unmerged
    partial as if it were global; simulated-rank tests fold through
    :func:`elastic_run_stream` and merge by hand.  A card asked for at
    world > 1 without an initialized group raises here too."""
    live = world_info()[1]
    if partition.world_size != live:
        raise InvalidParameters(
            f"distributed drivers need a live torch.distributed world of "
            f"{partition.world_size} processes (found {live}); for simulated ranks use "
            "elastic_run_stream and merge partials explicitly")


def _check_rows(rank, r0, r1, rows) -> None:
    if rows != r1:
        raise ValueError(f"rank {rank} folded rows [{r0}, {rows}) but its partition share is "
                         f"[{r0}, {r1}); the source and partition disagree")


def _resolve(params, partition, kind, epoch):
    """``(epoch, plan, watchdog)`` of a distributed driver's run: the
    repartition policy resolves the epoch and plan from the root."""
    plan = None
    if getattr(params, "resume_policy", "strict") == "repartition":
        from .repartition import resolve_resume

        epoch, plan = resolve_resume(params.checkpoint_dir, partition, kind=kind, params=params)
    rank, world = _resolve_world(params)
    watchdog = (_make_watchdog(params, params.checkpoint_dir, rank, world, epoch)
                if params.checkpoint_dir else None)
    return epoch, plan, watchdog


def distributed_sketch(source, S, *, ncols: int, partition: RowPartition, dtype=None,
                       params: ElasticParams | None = None, fault_plan=None, epoch: int = 0):
    """Distributed one-pass columnwise ``S·A`` over a partitioned stream.

    Every process calls this with the same arguments; each folds its
    share (global row offsets address the counter windows), the partials
    merge with one sum and the merged sum is finalized.  Returns the
    full (s, ncols) sketch, identical on every process.
    """
    from ..sketch.base import Dimension
    from .drivers import _result_dtype, _unwrap
    from .engine import accumulate_slice

    if partition.nrows != S.n:
        raise InvalidParameters(f"partition covers {partition.nrows} rows but the sketch "
                                f"domain is {S.n}")
    _require_real_world(partition)
    params = params or ElasticParams()
    rank, world = _resolve_world(params)
    partition.validate_world(rank, world)
    r0, r1 = partition.row_range(rank)
    dt, dev = _result_dtype(dtype), stream_device(params)
    kind = "distributed_streaming_sketch"

    def init_at(row0: int):
        return {"sa": torch.zeros((S.s, int(ncols)), dtype=dt, device=dev),
                "row": np.asarray(row0, np.int64)}

    def step(acc, block, index):
        row = int(acc["row"])
        block, k = _unwrap(block)
        return {"sa": accumulate_slice(S, acc["sa"], block, row, fused=params.fused_chunks,
                                       true_rows=k),
                "row": np.asarray(row + k, np.int64)}

    report = guard.RecoveryReport(stage=kind)
    epoch, plan, watchdog = _resolve(params, partition, kind, epoch)
    if plan is not None:
        from .repartition import execute_rank_plan

        partial, _ = execute_rank_plan(plan, source, params=params, root=params.checkpoint_dir,
                                       init_at=init_at, step_fn=step, kind=kind,
                                       fault_plan=fault_plan, report=report)
        partial = {"sa": partial["sa"]}
    else:
        acc, _ = elastic_run_stream(source, step, init_at(r0), partition, params, kind=kind,
                                    fault_plan=fault_plan, report=report, epoch=epoch)
        _check_rows(rank, r0, r1, int(acc["row"]))
        partial = {"sa": acc["sa"]}
    merged = cross_host_psum(partial, watchdog=watchdog)
    out = S.finalize_slices(merged["sa"], Dimension.COLUMNWISE)
    if guard.enabled():
        guard.check_finite(out, "distributed_streaming_sketch", report=report)
    return out


def distributed_sketch_least_squares(source, S, *, ncols: int, partition: RowPartition,
                                     targets: int = 1, alg: str = "qr", dtype=None,
                                     params: ElasticParams | None = None, fault_plan=None,
                                     epoch: int = 0, policy_decision: dict | None = None):
    """Distributed streaming sketch-and-solve least squares.

    One partitioned pass accumulates per-rank partials of ``(S·A,
    S·b)``, one sum merges them, and every rank solves the identical
    small (s, n) problem: ``x`` is the same on every rank with no
    broadcast.  Guard verdicts are WORLD decisions: each rank certifies
    the merged ``S·A``, the bad-certificate flags and chunk replay counts
    sum over the world, and a bad certificate on ANY rank sends EVERY
    rank to the SVD small solve.

    Returns ``(x, info)``; ``info`` holds only world-deterministic fields
    (global ``rows``/``batches``, the rank's ``local_batches``,
    ``world_size``, ``rank``, ``recovery``, ``replay``), so a killed and
    resumed run reproduces the uninterrupted ``(x, info)``.
    """
    from ..linalg.least_squares import exact_least_squares
    from ..sketch.base import Dimension
    from .drivers import _result_dtype
    from .engine import accumulate_slice

    if partition.nrows != S.n:
        raise InvalidParameters(f"partition covers {partition.nrows} rows but the sketch "
                                f"domain is {S.n}")
    _require_real_world(partition)
    params = params or ElasticParams()
    rank, world = _resolve_world(params)
    partition.validate_world(rank, world)
    r0, r1 = partition.row_range(rank)
    dt, dev = _result_dtype(dtype), stream_device(params)
    kind = "distributed_streaming_lsq"

    def init_at(row0: int):
        return {"sa": torch.zeros((S.s, int(ncols)), dtype=dt, device=dev),
                "sb": torch.zeros((S.s, int(targets)), dtype=dt, device=dev),
                "row": np.asarray(row0, np.int64)}

    def step(acc, batch, index):
        A_b, b_b = batch
        row = int(acc["row"])
        b2 = b_b[:, None] if b_b.ndim == 1 else b_b
        return {"sa": accumulate_slice(S, acc["sa"], A_b, row, fused=params.fused_chunks),
                "sb": accumulate_slice(S, acc["sb"], b2, row, fused=params.fused_chunks),
                "row": np.asarray(row + A_b.shape[0], np.int64)}

    guarded = guard.enabled()
    report = (guard.RecoveryReport(stage=kind) if guarded
              else guard.RecoveryReport.disabled(kind))
    replay = None
    epoch, plan, watchdog = _resolve(params, partition, kind, epoch)
    if plan is not None:
        from .repartition import execute_rank_plan

        partial, replay = execute_rank_plan(plan, source, params=params,
                                            root=params.checkpoint_dir, init_at=init_at,
                                            step_fn=step, kind=kind, fault_plan=fault_plan,
                                            report=report)
        nbatches = replay["replayed_batches"]
        partial = {"sa": partial["sa"], "sb": partial["sb"]}
    else:
        acc, nbatches = elastic_run_stream(source, step, init_at(r0), partition, params,
                                           kind=kind, fault_plan=fault_plan, report=report,
                                           epoch=epoch)
        _check_rows(rank, r0, r1, int(acc["row"]))
        partial = {"sa": acc["sa"], "sb": acc["sb"]}
    merged = cross_host_psum(partial, watchdog=watchdog)
    SA = S.finalize_slices(merged["sa"], Dimension.COLUMNWISE)
    SB = S.finalize_slices(merged["sb"], Dimension.COLUMNWISE)
    if guarded:
        # A one-pass stream has no resketch rung (the data is gone): a
        # failed certificate degrades the SMALL solve, by world verdict.
        cert = guard.certify_sketch(SA, stage="distributed_streaming_lsq")
        local_replays = sum(1 for a in report.attempts if a.action == "replay")
        votes = cross_host_psum(
            torch.tensor([0.0 if cert.ok else 1.0, float(local_replays)], dtype=torch.float64,
                         device=SA.device),
            watchdog=watchdog, phase="verdict")
        world_bad, world_replays = (int(v) for v in votes.tolist())
        report.record("initial", verdict=cert.verdict, detail=cert.detail, cond=cert.cond,
                      sketch_size=int(SA.shape[0]))
        report.record("world", detail=f"psum verdict over {world} rank(s): bad_certs="
                                      f"{world_bad}, chunk_replays={world_replays}")
        if world_bad:
            alg = "svd"
            report.record("fallback", verdict=guard.FALLBACK,
                          detail="svd pseudoinverse small solve (world verdict)")
            report.recovered = True
    X = exact_least_squares(SA, SB, alg=alg)
    if guarded:
        guard.check_finite(X, "distributed_streaming_lsq", report=report)
    x = X[:, 0] if targets == 1 else X
    info = {
        "rows": int(partition.nrows),
        "batches": int(partition.num_batches),
        "local_batches": int(nbatches),
        "world_size": int(partition.world_size),
        "rank": int(rank),
        "recovery": report.to_dict(),
        # None on the normal path; a repartitioned resume's plan-global
        # accounting (the same on every rank) otherwise.
        "replay": replay,
    }
    if policy_decision is not None:
        info["policy"] = policy_decision
    telemetry.run_summary(kind, info)
    return x, info
