"""Fault injection and retry for the resilient runner (port of the
single-process part of ``libskylark_tpu/resilient/faults.py``).

Three recoverable fault classes, each injectable deterministically so
that the recovery paths run in the tests:

- **Preemption**: the process dies at a chunk boundary, simulated by
  :class:`SimulatedPreemption` from the plan's :meth:`FaultPlan.after_commit`.
- **Checkpoint corruption**: :func:`corrupt_checkpoint` flips bytes of a
  committed file; recovery is the store's newest-valid fallback.
- **Transient IO errors**: ``OSError`` on the first attempts of a save;
  recovery is :func:`with_retries`' exponential backoff.

The numerical faults of the guard layer (``nan_at``, ``bad_sketch_at``)
are here too, and so is the serve journal's :class:`JournalFaultPlan`
(a real SIGKILL inside the journal's commit window), and the elastic
layer's host faults: :class:`HostFaultPlan` (rank death, stragglers, a
hostile host, a stale-epoch writer), :func:`corrupt_manifest` and
:func:`tear_ledger_tail`, and the serve fleet's :class:`FleetFaultPlan`
(replica death under load, a slow heartbeat, a join storm, a flapping
replica), bound to the autoscaler's ``fault_plan`` hook.  The drills run
on replicas in one process: on the CPU, or sharing one card.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch


__all__ = [
    "SimulatedPreemption",
    "FaultPlan",
    "HostFaultPlan",
    "FleetFaultPlan",
    "JournalFaultPlan",
    "corrupt_checkpoint",
    "corrupt_manifest",
    "tear_ledger_tail",
    "with_retries",
]

class SimulatedPreemption(RuntimeError):
    """Stands in for the process being killed: raised from a fault-plan
    hook, it unwinds the runner as a preemption would leave it —
    committed checkpoints on disk, nothing else."""


def corrupt_checkpoint(path, nbytes: int = 64, offset: int | None = None):
    """Flip ``nbytes`` bytes of a committed ``.npz`` checkpoint in place,
    by default in the middle of the file, so that a leaf CRC or the
    container itself fails validation."""
    size = os.path.getsize(path)
    if offset is None:
        offset = size // 2
    nbytes = min(nbytes, size - offset)
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))


def corrupt_manifest(host_directory) -> str:
    """Flip every byte of a host's elastic ``manifest.json`` in place (a
    corrupt-at-rest or hostile host): the repartition scanner must treat
    the host as uncertifiable, drop its coverage and re-fold its batches.
    Returns the manifest's path."""
    path = os.path.join(str(host_directory), "manifest.json")
    with open(path, "r+b") as f:
        data = f.read()
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in data))
    return path


def tear_ledger_tail(ledger_path) -> None:
    """Append a torn (half-written, unterminated) record to a host's
    ``progress.jsonl``, what a SIGKILL inside ``write`` leaves:
    ``read_progress`` must skip it and keep the intact prefix."""
    with open(str(ledger_path), "a", encoding="utf-8") as f:
        f.write('{"ts": 0.0, "seq": 99999, "kind": "elas')


def with_retries(fn, retries: int = 3, backoff: float = 0.05, exceptions=(OSError,),
                 sleep=time.sleep):
    """Call ``fn()`` with exponential backoff: up to ``retries`` more
    attempts after the first, sleeping ``backoff * 2**attempt`` between
    (``sleep`` is injectable so tests need not wait)."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions:
            if attempt >= retries:
                raise
            sleep(backoff * (2 ** attempt))
            attempt += 1


def _map_floats(tree, fn):
    """``fn`` on every floating tensor of a nest of dicts, lists and
    tuples; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_map_floats(v, fn) for v in tree)
    return tree


@dataclass
class FaultPlan:
    """Deterministic fault schedule keyed by chunk index (0-based, counted
    from the start of this process, so a resumed run has its own chunk 0).

    - ``preempt_after_chunk``: raise :class:`SimulatedPreemption` right
      after that chunk's checkpoint is committed.
    - ``io_errors_on_save``: ``{chunk: n}``, the first ``n`` save attempts
      of that chunk's checkpoint raise ``OSError``.
    - ``nan_after_chunk``: NaN-poison the state the runner hands to the
      next chunk (:meth:`poison`), to drive the divergence guard.

    Numerical faults for the guard layer, one-shot (the guard's replay
    of the same index sees clean data):

    - ``nan_at``: NaN-fill the batch at that index before the fold
      (streaming), or the sketched ``S·A`` of that ladder attempt.
    - ``bad_sketch_at``: Inf-fill the batch at that index (streaming), or
      collapse the rank of that attempt's ``S·A`` (in-core).
    """

    preempt_after_chunk: int | None = None
    io_errors_on_save: dict = field(default_factory=dict)
    nan_after_chunk: int | None = None
    nan_at: int | None = None
    bad_sketch_at: int | None = None
    _save_attempts: dict = field(default_factory=dict, repr=False)
    _consumed: set = field(default_factory=set, repr=False)

    def before_save(self, chunk: int) -> None:
        budget = self.io_errors_on_save.get(chunk, 0)
        seen = self._save_attempts.get(chunk, 0)
        self._save_attempts[chunk] = seen + 1
        if seen < budget:
            raise OSError(f"injected transient IO error (chunk {chunk}, attempt {seen})")

    def after_commit(self, chunk: int) -> None:
        if self.preempt_after_chunk is not None and chunk == self.preempt_after_chunk:
            raise SimulatedPreemption(f"injected preemption after chunk {chunk}")

    def poison(self, chunk: int, state):
        if self.nan_after_chunk is None or chunk != self.nan_after_chunk:
            return state
        return _map_floats(state, lambda t: torch.full_like(t, float("nan")))

    def _fire(self, kind: str, scheduled, index: int) -> bool:
        """One-shot trigger: True the first time ``index`` matches."""
        if scheduled is None or index != scheduled:
            return False
        key = (kind, index)
        if key in self._consumed:
            return False
        self._consumed.add(key)
        return True

    def corrupt_block(self, index: int, block):
        """Streaming injection point: corrupt the batch at ``index``
        (one-shot: the guard's replay of the same batch gets it clean)."""
        if self._fire("nan_block", self.nan_at, index):
            return _map_floats(block, lambda t: torch.full_like(t, float("nan")))
        if self._fire("bad_block", self.bad_sketch_at, index):
            return _map_floats(block, lambda t: torch.full_like(t, float("inf")))
        return block

    def corrupt_sketch(self, attempt: int, SA):
        """In-core injection point: corrupt the sketched ``S·A`` of ladder
        attempt ``attempt`` (one-shot per attempt index)."""
        if self._fire("nan_sketch", self.nan_at, attempt):
            return torch.full_like(SA, float("nan"))
        if self._fire("bad_sketch", self.bad_sketch_at, attempt):
            # Rank collapse, not NaN: the certificate has to catch it.
            if SA.shape[0] > 1:
                out = SA.clone()
                out[1:] = 0.0
                return out
            return SA * 0.0
        return SA


@dataclass
class JournalFaultPlan(FaultPlan):
    """Write-ahead-journal chaos schedule for the serve registry's
    durability layer, keyed by journal append index (0-based, counted
    from the ``Journal``'s construction in this process).
    ``serve.journal.Journal`` consults the plan at its two crash-window
    edges:

    - ``torn_journal_at``: write only the first half of append k's CRC
      frame (fsync'd) and SIGKILL.  Recovery truncates the torn tail and
      lands at append k-1's epoch.
    - ``die_after_journal_before_publish``: append k reaches the disk
      durably, then SIGKILL before the mutation publishes.  Recovery
      replays that record and lands at append k's epoch.

    Both are real ``SIGKILL``s, one-shot via :meth:`FaultPlan._fire`.
    """

    torn_journal_at: int | None = None
    die_after_journal_before_publish: int | None = None

    def kill(self) -> None:
        """Die now: a real SIGKILL, nothing runs after this."""
        import signal

        os.kill(os.getpid(), signal.SIGKILL)

    def torn_fires(self, index: int) -> bool:
        return self._fire("torn_journal", self.torn_journal_at, index)

    def die_after_fires(self, index: int) -> bool:
        return self._fire("die_after_journal", self.die_after_journal_before_publish, index)


@dataclass
class HostFaultPlan(FaultPlan):
    """Host-level chaos schedule of the elastic streaming layer: the
    failure modes of a machine, not of a computation.  The elastic engine
    binds the plan to the rank's state on disk (:meth:`bind_host`) and
    calls :meth:`before_batch` before folding each LOCAL batch:

    - ``die_at_batch``: rank death, a real SIGKILL just before folding
      local batch k (with ``torn_ledger=True`` a half-written ledger
      record first, a kill inside ``write``);
    - ``die_after_commit``: rank death right after chunk k's checkpoint
      commits;
    - ``slow_at_batch`` / ``slow_seconds``: a straggler, sleeping before
      local batch k (its peers meet their collective deadline, 110);
    - ``corrupt_manifest_at``: a hostile host, flipping its own
      ``manifest.json`` before local batch k (a later repartition must
      drop its coverage);
    - ``bump_epoch_at``: a stale-epoch writer, advancing the root's epoch
      marker before local batch k as if the rest of the world
      repartitioned; the rank's next ledger record raises 111.

    Every :class:`FaultPlan` knob composes with these.
    """

    die_at_batch: int | None = None
    die_after_commit: int | None = None
    torn_ledger: bool = False
    slow_at_batch: int | None = None
    slow_seconds: float = 0.0
    corrupt_manifest_at: int | None = None
    bump_epoch_at: int | None = None
    host_dir: str | None = None
    root: str | None = None
    epoch: int = 0
    sleep: object = time.sleep  # injectable for tests

    def bind_host(self, *, hdir: str, root: str, epoch: int = 0) -> None:
        """The rank's host directory, once the elastic engine knows it:
        the file-targeting faults aim there."""
        self.host_dir = str(hdir)
        self.root = str(root)
        self.epoch = int(epoch)

    def _suicide(self) -> None:
        import signal

        os.kill(os.getpid(), signal.SIGKILL)

    def _tear(self) -> None:
        if self.torn_ledger and self.host_dir:
            try:
                tear_ledger_tail(os.path.join(self.host_dir, "progress.jsonl"))
            except OSError:
                pass

    def before_batch(self, index: int) -> None:
        if self._fire("slow_batch", self.slow_at_batch, index):
            self.sleep(float(self.slow_seconds))
        if self._fire("corrupt_manifest", self.corrupt_manifest_at, index) and self.host_dir:
            try:
                corrupt_manifest(self.host_dir)
            except OSError:
                pass
        if self._fire("bump_epoch", self.bump_epoch_at, index) and self.root:
            from ..streaming.elastic import RowPartition
            from ..streaming.repartition import read_epoch, write_epoch

            est = read_epoch(self.root)
            cur = int(est["epoch"]) if est else int(self.epoch)
            write_epoch(self.root, epoch=cur + 1,
                        partition=RowPartition(nrows=1, batch_rows=1, world_size=1),
                        kind=(est or {}).get("kind", "chaos"))
        if self.die_at_batch is not None and index == self.die_at_batch:
            self._tear()
            self._suicide()

    def after_commit(self, chunk: int) -> None:
        if self.die_after_commit is not None and chunk == self.die_after_commit:
            self._tear()
            self._suicide()
        super().after_commit(chunk)


@dataclass
class FleetFaultPlan(HostFaultPlan):
    """Replica-level chaos schedule for the serve fleet: the failure
    modes of a *membership*, not a machine.  Keyed by autoscaler control
    tick (1-based, the :meth:`before_tick` argument), every fault fires
    exactly once at its scheduled tick, so a drill replays the same
    membership history on every run:

    - ``die_under_load_at``: **replica death under traffic**: the bound
      ``kill`` callback abruptly stops a busy replica's workers (no
      drain, no leave); the router's next heartbeat sweep must eject it
      and the surviving replicas absorb its keys.
    - ``slow_heartbeat_at`` / ``slow_heartbeat_s``: **stale but alive**:
      the bound ``slow_report`` callback makes one replica's
      ``load_report`` lag by ``slow_heartbeat_s``; the router must stamp
      ``report_age_s`` and keep placing on it, NOT eject it.
    - ``join_storm_at`` / ``join_storm_size``: **join storm**: the bound
      ``spawn`` callback runs ``join_storm_size`` times in one tick;
      every joiner must clear the registry-signature fence and prime
      before taking traffic.
    - ``flap_at`` / ``flap_times``: **flapping replica**: alternating
      kill/spawn ``flap_times`` times from ``flap_at`` (one transition
      per tick); membership must converge without shedding admitted
      work.

    :meth:`bind_fleet` binds the plan to a fleet: the callbacks own the
    how (which replica, how it dies), the plan owns the when.  Every
    :class:`HostFaultPlan` / :class:`FaultPlan` knob is inherited, so
    fleet chaos composes with host and numerical injection in one
    schedule.
    """

    die_under_load_at: int | None = None
    slow_heartbeat_at: int | None = None
    slow_heartbeat_s: float = 0.0
    join_storm_at: int | None = None
    join_storm_size: int = 2
    flap_at: int | None = None
    flap_times: int = 2
    _kill: object = field(default=None, repr=False)
    _spawn: object = field(default=None, repr=False)
    _slow_report: object = field(default=None, repr=False)
    _flaps_left: int = field(default=0, repr=False)
    _flap_next: str = field(default="kill", repr=False)

    def bind_fleet(self, *, kill=None, spawn=None, slow_report=None) -> None:
        """Attach the drill's actuators: ``kill()`` stops a busy replica
        abruptly, ``spawn()`` builds and joins a fresh one,
        ``slow_report(seconds)`` delays one replica's next report."""
        self._kill = kill
        self._spawn = spawn
        self._slow_report = slow_report

    def before_tick(self, tick: int) -> None:
        """Autoscaler hook: fire every fault scheduled for this control
        tick (each once, through the inherited ``_fire`` ledger)."""
        if self._fire("die_under_load", self.die_under_load_at, tick):
            if self._kill is not None:
                self._kill()
        if self._fire("slow_heartbeat", self.slow_heartbeat_at, tick):
            if self._slow_report is not None:
                self._slow_report(float(self.slow_heartbeat_s))
        if self._fire("join_storm", self.join_storm_at, tick):
            if self._spawn is not None:
                for _ in range(int(self.join_storm_size)):
                    self._spawn()
        if self.flap_at is not None and tick == self.flap_at:
            self._flaps_left = int(self.flap_times)
        if self._flaps_left > 0:
            self._flaps_left -= 1
            actor = self._kill if self._flap_next == "kill" else self._spawn
            self._flap_next = "spawn" if self._flap_next == "kill" else "kill"
            if actor is not None:
                actor()
