"""Repartition-on-resume: remap ledgered elastic progress onto a new world
(port of ``libskylark_tpu/streaming/repartition.py``).

Columnwise ``S·A`` is a pure sum of counter-addressed window applies, so
a partial-sketch checkpoint covering global batches ``[s, e)`` is valid
under ANY partition: a new world adopts the old world's durable partials
and re-folds only what was never committed (``resume_policy=
"repartition"``):

1. :func:`replan_resume` scans the shared root without communication:
   every ``host-*/`` manifest of the current epoch (or the persisted plan
   of an already repartitioned epoch) is read, kind and signature
   coherence checked, and each host's newest CRC-valid slot becomes a
   coverage ref, a global batch range backed by a durable file.  A host
   whose manifest is unreadable or whose slots are corrupt contributes
   nothing (its batches re-fold); a readable manifest of another kind, or
   a mix of partitions, raises 109.
2. The residual, the complement of the refs' union in
   ``[0, num_batches)``, and the refs are assigned to the new world by a
   deterministic greedy rule (refs round-robin in start order; residual
   ranges cut to a per-rank quota, each piece to the least-loaded rank,
   ties to the lowest): every rank computes the same plan.
3. The plan and the root's ``epoch.json`` are written as canonical bytes
   (every rank writes the same content, so racing ``os.replace`` is
   benign) and the epoch bumps: stale writers of the old world die at
   their next ledger record (111).
4. :func:`execute_rank_plan` runs one rank's share: merge its refs
   (exact-slot loads, CRC and epoch checked), re-fold its residual
   segments through the checkpointable ``run_stream`` (each under
   ``epoch-<e>/host-<rank>/seg-*``, so a kill during recovery resumes the
   recovery), and hand back the float partial for the usual merge.

The merged result equals the uninterrupted new-world run's sum of the
same window applies up to the reassociation of the merge: bitwise where
the summands are exact (integer data under a ±1 CountSketch).  All files
are in the JAX package's formats, and the plan bytes are the JAX
planner's on the same root.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from itertools import islice

import numpy as np
import torch

from .. import telemetry
from ..telemetry.fleet import EPOCH_NAME, read_epoch
from ..utils.checkpoint import CheckpointStore, load_solver_state
from ..utils.exceptions import (CheckpointError, InvalidParameters, StaleEpochError,
                                WorldMismatchError)
from .engine import as_block_factory, run_stream

__all__ = [
    "EPOCH_NAME",
    "PlanRef",
    "RankAssignment",
    "ResumePlan",
    "read_epoch",
    "write_epoch",
    "plan_path",
    "load_plan",
    "scan_coverage",
    "replan_resume",
    "resolve_resume",
    "execute_rank_plan",
    "merge_ranges",
    "complement_ranges",
]

_PLAN_VERSION = 1
_EPOCH_VERSION = 1


def _atomic_write_json(path: str, payload: dict) -> None:
    """Canonical-bytes atomic write (sorted keys, the JAX package's
    bytes): every rank of a repartitioning world writes the same content,
    so racing ``os.replace`` calls are benign."""
    data = json.dumps(payload, sort_keys=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def write_epoch(root, *, epoch: int, partition, kind: str) -> None:
    _atomic_write_json(os.path.join(str(root), EPOCH_NAME), {
        "skylark_object_type": "elastic_epoch",
        "format_version": _EPOCH_VERSION,
        "epoch": int(epoch),
        "kind": str(kind),
        "partition": partition.to_json(),
        "signature": int(partition.signature()),
    })


def current_epoch(root) -> int:
    est = read_epoch(root)
    return int(est["epoch"]) if est else 0


def plan_path(root, epoch: int) -> str:
    return os.path.join(str(root), f"plan-{int(epoch):04d}.json")


def merge_ranges(ranges) -> list[tuple[int, int]]:
    """Union of half-open int ranges, sorted and coalesced."""
    out: list[list[int]] = []
    for s, e in sorted((int(s), int(e)) for s, e in ranges if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def complement_ranges(ranges, total: int) -> list[tuple[int, int]]:
    """Complement of (merged) ``ranges`` within ``[0, total)``."""
    out = []
    pos = 0
    for s, e in merge_ranges(ranges):
        if s > pos:
            out.append((pos, s))
        pos = max(pos, e)
    if pos < total:
        out.append((pos, total))
    return out


@dataclass(frozen=True)
class PlanRef:
    """A durable partial-sketch checkpoint covering global batches
    ``[start, end)``: ``directory`` relative to the shared root, ``step``
    the exact slot (a plan is a frozen snapshot)."""

    directory: str
    step: int
    start: int
    end: int
    epoch: int

    def to_json(self) -> dict:
        return {"dir": self.directory, "step": int(self.step), "start": int(self.start),
                "end": int(self.end), "epoch": int(self.epoch)}

    @classmethod
    def from_json(cls, d: dict) -> "PlanRef":
        return cls(directory=d["dir"], step=int(d["step"]), start=int(d["start"]),
                   end=int(d["end"]), epoch=int(d["epoch"]))


@dataclass
class RankAssignment:
    refs: list = field(default_factory=list)
    segments: list = field(default_factory=list)  # [(start, end)) to re-fold

    def to_json(self) -> dict:
        return {"refs": [r.to_json() for r in self.refs],
                "segments": [[int(s), int(e)] for s, e in self.segments]}

    @classmethod
    def from_json(cls, d: dict) -> "RankAssignment":
        return cls(refs=[PlanRef.from_json(r) for r in d.get("refs", [])],
                   segments=[(int(s), int(e)) for s, e in d.get("segments", [])])


@dataclass
class ResumePlan:
    """The world-deterministic repartition plan: what every rank of the
    NEW world merges and re-folds, persisted as ``plan-<epoch>.json``."""

    kind: str
    source_epoch: int
    epoch: int
    partition: object  # RowPartition of the NEW world
    old_partition: dict | None
    assignments: dict  # rank -> RankAssignment
    completed: list  # merged [(s, e)) durable at plan time
    residual: list  # merged [(s, e)) to re-fold
    lost_hosts: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "skylark_object_type": "elastic_resume_plan",
            "format_version": _PLAN_VERSION,
            "kind": self.kind,
            "source_epoch": int(self.source_epoch),
            "epoch": int(self.epoch),
            "partition": self.partition.to_json(),
            "signature": int(self.partition.signature()),
            "old_partition": self.old_partition,
            "assignments": {str(r): a.to_json() for r, a in sorted(self.assignments.items())},
            "completed": [[int(s), int(e)] for s, e in self.completed],
            "residual": [[int(s), int(e)] for s, e in self.residual],
            "lost_hosts": [int(r) for r in self.lost_hosts],
        }

    @classmethod
    def from_json(cls, d: dict) -> "ResumePlan":
        from .elastic import RowPartition

        if d.get("skylark_object_type") != "elastic_resume_plan":
            raise CheckpointError(f"not an elastic resume plan: {d.get('skylark_object_type')!r}")
        return cls(
            kind=d["kind"], source_epoch=int(d["source_epoch"]), epoch=int(d["epoch"]),
            partition=RowPartition.from_json(d["partition"]),
            old_partition=d.get("old_partition"),
            assignments={int(r): RankAssignment.from_json(a)
                         for r, a in d.get("assignments", {}).items()},
            completed=[(int(s), int(e)) for s, e in d.get("completed", [])],
            residual=[(int(s), int(e)) for s, e in d.get("residual", [])],
            lost_hosts=[int(r) for r in d.get("lost_hosts", [])])

    def signature(self) -> int:
        """CRC32 of the canonical plan bytes, carried in the resume
        handshake so ranks that derived different plans fail fast."""
        return zlib.crc32(json.dumps(self.to_json(), sort_keys=True).encode())

    def replay_info(self) -> dict:
        """``info["replay"]``: pure plan arithmetic, the same on every rank."""
        return {
            "epoch": int(self.epoch),
            "source_epoch": int(self.source_epoch),
            "from_world": (int(self.old_partition["world_size"]) if self.old_partition
                           else None),
            "to_world": int(self.partition.world_size),
            "completed_batches": sum(e - s for s, e in self.completed),
            "replayed_batches": sum(e - s for s, e in self.residual),
            "replayed": [[int(s), int(e)] for s, e in self.residual],
            "merged_refs": sum(len(a.refs) for a in self.assignments.values()),
            "lost_hosts": [int(r) for r in self.lost_hosts],
        }


def load_plan(root, epoch: int) -> ResumePlan | None:
    try:
        with open(plan_path(root, epoch), encoding="utf-8") as fh:
            return ResumePlan.from_json(json.load(fh))
    except (OSError, UnicodeDecodeError, json.JSONDecodeError):
        return None


def _newest_valid_step(directory: str) -> tuple[int, int] | None:
    """``(step, epoch)`` of a store's newest CRC-valid slot, or None: a
    ref is valid when its bytes check out now, not when a file exists."""
    if not os.path.isdir(directory):
        return None
    try:
        loaded = CheckpointStore(directory).load_latest()
    except CheckpointError:
        return None
    if loaded is None:
        return None
    _, meta, step = loaded
    return int(step), CheckpointStore.slot_epoch(meta)


def _slot_valid(slot: str) -> bool:
    try:
        load_solver_state(slot)
    except CheckpointError:
        return False
    return True


def scan_coverage(root, *, kind: str) -> dict:
    """Scan the shared root's CURRENT epoch without communication.

    Returns ``{"epoch", "old_partition" (dict or None), "refs" (list of
    PlanRef, the durable coverage), "lost_hosts" (ranks whose state could
    not be certified)}``.  Raises 109 when readable state belongs to
    another ``kind`` or mixes partitions.
    """
    from .elastic import MANIFEST_NAME, RowPartition, host_dir

    root = str(root)
    epoch = current_epoch(root)
    refs: list[PlanRef] = []
    lost: list[int] = []

    if epoch > 0:
        plan = load_plan(root, epoch)
        if plan is None:
            raise WorldMismatchError(
                f"epoch marker at {root} names epoch {epoch} but {plan_path(root, epoch)} is "
                "missing/unreadable; the root's repartition history cannot be certified",
                expected=epoch, got=None)
        if plan.kind != str(kind):
            raise WorldMismatchError(
                f"checkpoint root {root} holds a {plan.kind!r} stream, refusing to "
                f"repartition it into a {kind!r} resume", expected=plan.kind, got=str(kind))
        for rank, asg in sorted(plan.assignments.items()):
            # Inherited refs, each checked again (a slot corrupted since
            # the last plan degrades its range to residual).
            for ref in asg.refs:
                if _slot_valid(os.path.join(root, ref.directory, f"ckpt-{ref.step:012d}")):
                    refs.append(ref)
                else:
                    lost.append(rank)
            # Segment stores: whatever the recovery durably folded.
            hdir = host_dir(root, rank, epoch)
            for s, e in asg.segments:
                seg = os.path.join(hdir, f"seg-{int(s):06d}")
                probe = _newest_valid_step(seg)
                if probe is None:
                    continue
                step, slot_epoch = probe
                if slot_epoch != epoch or step <= 0:
                    continue
                covered = min(step, e - s)
                refs.append(PlanRef(directory=os.path.relpath(seg, root), step=covered,
                                    start=s, end=s + covered, epoch=epoch))
        return {"epoch": epoch, "old_partition": plan.partition.to_json(), "refs": refs,
                "lost_hosts": sorted(set(lost))}

    # Epoch 0: bare host-<rank>/ directories written by plain elastic runs.
    old_partition = old_signature = None
    try:
        names = sorted(os.listdir(root))
    except OSError:
        names = []
    hosts = []
    for name in names:
        if not name.startswith("host-"):
            continue
        try:
            hosts.append((int(name.split("-", 1)[1]), os.path.join(root, name)))
        except ValueError:
            continue
    for rank, hdir in hosts:
        try:
            with open(os.path.join(hdir, MANIFEST_NAME), encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, UnicodeDecodeError, json.JSONDecodeError):
            lost.append(rank)  # a corrupt host certifies nothing: re-fold its range
            continue
        if manifest.get("kind") != str(kind):
            raise WorldMismatchError(
                f"host state {hdir} belongs to kind {manifest.get('kind')!r}, refusing to "
                f"repartition into a {kind!r} resume",
                expected=manifest.get("kind"), got=str(kind))
        if int(manifest.get("epoch", 0)) != 0:
            lost.append(rank)
            continue
        sig = manifest.get("signature")
        if old_signature is None:
            old_signature, old_partition = sig, manifest.get("partition")
        elif sig != old_signature:
            raise WorldMismatchError(
                f"host manifests under {root} mix partitions (signatures {old_signature} and "
                f"{sig}); the root cannot be repartitioned coherently",
                expected=old_signature, got=sig)
        probe = _newest_valid_step(hdir)
        if probe is None or probe[1] != 0 or probe[0] <= 0:
            lost.append(rank)
            continue
        try:
            start_b, end_b = RowPartition.from_json(manifest.get("partition") or {}
                                                    ).batch_range(rank)
        except (KeyError, TypeError, InvalidParameters):
            lost.append(rank)
            continue
        covered = min(probe[0], end_b - start_b)
        if covered > 0:
            refs.append(PlanRef(directory=os.path.relpath(hdir, root), step=covered,
                                start=start_b, end=start_b + covered, epoch=0))
    return {"epoch": 0, "old_partition": old_partition, "refs": refs,
            "lost_hosts": sorted(set(lost))}


def _assign(refs, residual, world: int) -> dict:
    """The deterministic greedy assignment: refs (cheap merges)
    round-robin in start order; residual ranges (real re-folds) cut to a
    per-rank quota, each piece to the least-loaded rank, ties to the
    lowest."""
    assignments = {r: RankAssignment() for r in range(world)}
    for i, ref in enumerate(sorted(refs, key=lambda r: (r.start, r.directory))):
        assignments[i % world].refs.append(ref)
    total = sum(e - s for s, e in residual)
    if total:
        quota = -(-total // world)
        load = [0] * world
        for s, e in residual:
            while s < e:
                piece = min(e - s, quota)
                rank = min(range(world), key=lambda r: (load[r], r))
                assignments[rank].segments.append((s, s + piece))
                load[rank] += piece
                s += piece
        for asg in assignments.values():
            asg.segments.sort()
    return assignments


def replan_resume(root, new_partition, *, kind: str) -> ResumePlan:
    """Compute and persist the plan that adopts the current epoch's
    durable coverage under ``new_partition``, then bump the root's epoch
    marker to fence stale writers.  Every rank calling this on the same
    root writes byte-identical ``plan-<epoch>.json`` and ``epoch.json``."""
    scan = scan_coverage(root, kind=kind)
    source_epoch = int(scan["epoch"])
    new_epoch = source_epoch + 1
    nb = new_partition.num_batches
    refs = [r for r in scan["refs"] if r.start < r.end]
    completed = merge_ranges((r.start, r.end) for r in refs)
    if any(e > nb for _, e in completed):
        top = max(e for _, e in completed)
        raise WorldMismatchError(
            f"durable coverage reaches batch {top} but the new partition has only {nb} "
            "batches; nrows/batch_rows changed, not just the world size — restart from "
            "scratch", expected=nb, got=top)
    residual = complement_ranges(completed, nb)
    plan = ResumePlan(kind=str(kind), source_epoch=source_epoch, epoch=new_epoch,
                      partition=new_partition, old_partition=scan["old_partition"],
                      assignments=_assign(refs, residual, new_partition.world_size),
                      completed=completed, residual=residual, lost_hosts=scan["lost_hosts"])
    _atomic_write_json(plan_path(root, new_epoch), plan.to_json())
    write_epoch(root, epoch=new_epoch, partition=new_partition, kind=kind)
    if telemetry.enabled():
        telemetry.inc("elastic.replans")
        telemetry.event("elastic", "replan", plan.replay_info())
    return plan


def resolve_resume(root, partition, *, kind: str, params) -> tuple:
    """This resume's ``(epoch, plan)``.

    ``resume_policy="strict"`` (default) pins ``(0, None)``: bare
    ``host-*/`` layout, manifest checks, 109 on any world change.
    ``"repartition"`` (with ``resume=True`` and a root): a fresh root
    gives ``(0, None)``; a disk partition equal to ours resumes at the
    disk epoch (re-running a persisted plan idempotently); another one
    replans at a bumped epoch (:func:`replan_resume`).
    """
    from .elastic import MANIFEST_NAME

    policy = getattr(params, "resume_policy", "strict") or "strict"
    if policy not in ("strict", "repartition"):
        raise InvalidParameters(
            f"resume_policy must be 'strict' or 'repartition', got {policy!r}")
    if policy == "strict" or not root or not getattr(params, "resume", False):
        return 0, None
    est = read_epoch(root)
    ours = int(partition.signature())
    if est is not None:
        if est.get("kind") != str(kind):
            raise WorldMismatchError(
                f"checkpoint root {root} holds a {est.get('kind')!r} stream, this resume is "
                f"{kind!r}", expected=est.get("kind"), got=str(kind))
        epoch = int(est["epoch"])
        if int(est.get("signature", -1)) == ours:
            return epoch, load_plan(root, epoch)  # idempotent re-execution or plain resume
        return epoch + 1, replan_resume(root, partition, kind=kind)
    # Epoch 0: repartition only when the manifests disagree with ours.
    scan_needed = False
    try:
        names = sorted(os.listdir(str(root)))
    except OSError:
        names = []
    for name in names:
        if not name.startswith("host-"):
            continue
        try:
            with open(os.path.join(str(root), name, MANIFEST_NAME), encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, UnicodeDecodeError, json.JSONDecodeError):
            scan_needed = True  # an uncertifiable host: replan around it
            continue
        if manifest.get("signature") != ours or manifest.get("kind") != str(kind):
            scan_needed = True
    if not scan_needed:
        return 0, None
    return 1, replan_resume(root, partition, kind=kind)


def _add_float_leaves(total: dict | None, acc: dict) -> dict:
    """Running sum of a driver accumulator's float leaves (the int row
    cursor is partition-relative and dropped)."""
    floats = {k: v for k, v in acc.items()
              if isinstance(v, torch.Tensor) and v.is_floating_point()}
    if total is None:
        return floats
    if set(total) != set(floats):
        raise CheckpointError(f"plan pieces disagree on accumulator leaves: {sorted(total)} "
                              f"vs {sorted(floats)}")
    return {k: total[k] + floats[k] for k in total}


def execute_rank_plan(plan: ResumePlan, source, *, params, root, init_at, step_fn, kind: str,
                      fault_plan=None, report=None):
    """Run THIS rank's share of ``plan``; returns ``(float_partial,
    replay_info)`` for the usual single ``cross_host_psum``.

    ``init_at(row0)`` builds the driver accumulator with its row cursor
    at global row ``row0``; ``step_fn`` is the driver's fold.  Residual
    segments run through the checkpointable ``run_stream`` with a store
    per segment under this rank's NEW-epoch directory, so a preemption
    during recovery resumes the recovery.
    """
    from ..telemetry.fleet import PROGRESS_NAME
    from .elastic import (HostLedger, _check_manifest, _epoch_fence, _handshake, _local_params,
                          _make_watchdog, _resolve_world, host_dir)

    rank, world = _resolve_world(params)
    plan.partition.validate_world(rank, world)
    batch_rows = plan.partition.batch_rows
    epoch = int(plan.epoch)
    root = str(root)
    hdir = host_dir(root, rank, epoch)
    _check_manifest(hdir, plan.partition, rank, kind, epoch, True)
    fence = _epoch_fence(root, epoch)
    ledger = HostLedger(os.path.join(hdir, PROGRESS_NAME), rank=rank, epoch=epoch, fence=fence)
    watchdog = _make_watchdog(params, root, rank, world, epoch)
    _handshake(plan.partition, rank, world, kind, epoch, extra=plan.signature(),
               watchdog=watchdog)
    if fault_plan is not None and hasattr(fault_plan, "bind_host"):
        fault_plan.bind_host(hdir=hdir, root=root, epoch=epoch)
    asg = plan.assignments.get(rank, RankAssignment())
    proto = {"batch": np.asarray(0, np.int64), "acc": init_at(0)}
    total = None

    for ref in asg.refs:
        slot = os.path.join(root, ref.directory, f"ckpt-{ref.step:012d}")
        state, meta = load_solver_state(slot, like=proto)
        slot_epoch = CheckpointStore.slot_epoch(meta)
        if slot_epoch != ref.epoch:
            raise StaleEpochError(
                f"plan ref {slot} was written at epoch {slot_epoch}, the plan recorded epoch "
                f"{ref.epoch}; the store was mutated since planning — replan",
                expected=ref.epoch, got=slot_epoch)
        folded = int(state["batch"])
        if folded != ref.end - ref.start:
            raise CheckpointError(
                f"plan ref {slot} holds {folded} folded batches but covers [{ref.start}, "
                f"{ref.end}); the store was mutated since planning — replan")
        total = _add_float_leaves(total, state["acc"])
        ledger.record("merge_ref", start=int(ref.start), end=int(ref.end),
                      source=ref.directory, source_epoch=int(ref.epoch))
        if telemetry.enabled():
            telemetry.inc("elastic.ref_merges")

    global_factory = as_block_factory(source)
    for s, e in asg.segments:
        local_params = _local_params(params, os.path.join(hdir, f"seg-{int(s):06d}"),
                                     expect_epoch=epoch)
        local_params.resume = True  # a killed recovery resumes itself

        def seg_factory(local_start: int, s=s, e=e):
            if not 0 <= local_start <= e - s:
                raise ValueError(f"segment start {local_start} outside [0, {e - s}]")
            return islice(iter(global_factory(s + local_start)), e - s - local_start)

        last = {"b": -1}

        def seg_step(acc, block, b, s=s, last=last):
            fence()
            if fault_plan is not None and hasattr(fault_plan, "before_batch"):
                fault_plan.before_batch(b)
            out = step_fn(acc, block, b)
            if b > last["b"]:
                ledger.record("batch", batch=int(s + b), local=int(b))
                last["b"] = b
            return out

        meta = {"elastic": {"rank": rank, "world": world, "epoch": epoch,
                            "signature": int(plan.partition.signature()),
                            "segment": [int(s), int(e)]}}
        acc, nb = run_stream(seg_factory, seg_step, init_at(s * batch_rows), local_params,
                             kind=kind, metadata=meta, fault_plan=fault_plan, report=report)
        if nb != e - s:
            raise ValueError(f"rank {rank} re-folded {nb} batches of segment [{s}, {e}); the "
                             "source and partition disagree")
        total = _add_float_leaves(total, acc)
        ledger.record("segment_done", start=int(s), end=int(e))

    if total is None:
        # A rank with nothing assigned still takes part in the merge: zeros.
        total = {k: torch.zeros_like(v) for k, v in _add_float_leaves(None, init_at(0)).items()}
    ledger.record("replayed", segments=[[int(s), int(e)] for s, e in asg.segments],
                  refs=len(asg.refs))
    ledger.close()
    info = plan.replay_info()
    if telemetry.enabled():
        telemetry.event("elastic", "repartition_done", info)
    return total, info
