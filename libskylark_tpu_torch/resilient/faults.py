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
are here too.  The host and fleet faults (``HostFaultPlan``,
``FleetFaultPlan``, ``JournalFaultPlan``, ``corrupt_manifest``,
``tear_ledger_tail``) belong to the elastic and serving layers, which
wait for ROADMAP Queue A items 9 and 10; their names raise
``UnsupportedError`` naming the item.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

from ..utils.exceptions import deferred

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

_ITEM9 = "ROADMAP Queue A item 9: multi-device (elastic streaming, host faults)"
_ITEM10 = "ROADMAP Queue A item 10: serve/ (journal and fleet faults)"

HostFaultPlan = deferred("HostFaultPlan", _ITEM9)
FleetFaultPlan = deferred("FleetFaultPlan", _ITEM9)
JournalFaultPlan = deferred("JournalFaultPlan", _ITEM10)
corrupt_manifest = deferred("corrupt_manifest", _ITEM9)
tear_ledger_tail = deferred("tear_ledger_tail", _ITEM9)


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
