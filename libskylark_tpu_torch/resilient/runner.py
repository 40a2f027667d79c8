"""Host-level chunked driver with checkpoints between chunks (port of
``libskylark_tpu/resilient/runner.py``).

``ResilientRunner`` drives any :class:`~.chunked.ChunkedSolver` in
rounds of ``checkpoint_every`` iterations and commits a rotated,
CRC-guarded checkpoint after every round.  A preempted process restarts
with ``resume=True`` and loses at most one round; a corrupt newest
checkpoint falls back to the previous slot; transient IO errors are
retried with backoff; a non-finite state halts the run with the last
finite iterate attached.  With telemetry on, each chunk is a
``solver`` ledger event (its iteration and, where the state carries one,
its residual) and each checkpoint a ``checkpoint`` save or restore event
with the ``checkpoint.saves`` / ``restores`` / ``bytes`` counters.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch

from .. import telemetry
from ..core.params import Params
from ..guard.sentinels import tree_all_finite
from ..utils.checkpoint import CheckpointStore, place_like, tree_flatten, tree_unflatten
from ..utils.exceptions import CheckpointError, ConvergenceError
from .faults import with_retries

__all__ = ["ResilientParams", "ResilientRunner"]


def _residual_of(state):
    """Best-effort residual read at a chunk boundary: the chunked solver
    states that track one keep it under a conventional key (LSQR's
    ``phibar``, generic ``resid``/``rnorm``).  Returns a float (max over
    targets) or None — never raises, never reads the card for states
    that carry no residual."""
    if not isinstance(state, dict):
        return None
    for key in ("phibar", "resid", "rnorm", "residual"):
        if key in state:
            try:
                return float(torch.max(torch.abs(torch.as_tensor(state[key]))))
            except (TypeError, ValueError, RuntimeError):
                return None
    return None


@dataclass
class ResilientParams(Params):
    """Runtime knobs of a preemption-safe solve.

    ``checkpoint_every`` is the iterations per host round: the trade
    between preemption loss (at most one round) and the per-round sync
    and save.  ``keep_last`` sizes the rotation window that the
    corrupt-checkpoint fallback can reach back through.
    """

    checkpoint_dir: str | None = None
    checkpoint_every: int = 10
    keep_last: int = 3
    resume: bool = False
    io_retries: int = 3
    io_backoff: float = 0.05
    check_divergence: bool = True
    max_chunks: int | None = None  # backstop against non-terminating solvers
    # Pins restores to one elastic epoch (StaleEpochError otherwise).
    expect_epoch: int | None = None


class ResilientRunner:
    """Drive ``solver`` to completion with checkpoint/resume and guards.

    ``fault_plan`` (a :class:`~.faults.FaultPlan`) injects preemptions, IO
    errors and divergence for tests; ``sleep`` feeds the retry backoff.
    """

    def __init__(self, solver, params: ResilientParams | None = None,
                 metadata: dict | None = None, fault_plan=None, sleep=time.sleep):
        self.solver = solver
        self.params = params or ResilientParams()
        if self.params.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.params.checkpoint_every}")
        self.metadata = dict(metadata or {})
        self.fault_plan = fault_plan
        self.sleep = sleep
        self.store = (CheckpointStore(self.params.checkpoint_dir, self.params.keep_last)
                      if self.params.checkpoint_dir else None)

    def _resume_state(self, state):
        # Flat leaves first, so that "wrong solver" is diagnosed before
        # "wrong leaf count".
        loaded = self.store.load_latest(expect_epoch=self.params.expect_epoch)
        if loaded is None:
            return state
        leaves, meta, step = loaded
        kind = meta.get("solver_kind")
        want = getattr(self.solver, "kind", None)
        if kind is not None and want is not None and kind != want:
            raise CheckpointError(
                f"checkpoint in {self.params.checkpoint_dir} was written by solver kind "
                f"{kind!r}, refusing to resume {want!r}")
        proto, treedef = tree_flatten(state)
        if len(proto) != len(leaves):
            raise CheckpointError(f"checkpoint step {step} has {len(leaves)} leaves, "
                                  f"solver state has {len(proto)}")
        self.params.log(1, f"resumed from checkpoint step {step}")
        if telemetry.enabled():
            # crc_ok is True by construction here: load_latest only
            # returns slots whose per-leaf CRC32 validated.
            telemetry.event("checkpoint", "restore", {"step": step, "crc_ok": True, "kind": kind})
            telemetry.inc("checkpoint.restores")
        return tree_unflatten(treedef, [place_like(v, p) for v, p in zip(leaves, proto)])

    def _commit(self, state, chunk: int) -> None:
        meta = dict(self.metadata)
        meta["solver_kind"] = getattr(self.solver, "kind", "chunked_solver")
        step = int(self.solver.iteration(state))

        def attempt():
            if self.fault_plan is not None:
                self.fault_plan.before_save(chunk)
            return self.store.save(state, step=step, metadata=meta)

        t0 = time.perf_counter()
        path = with_retries(attempt, retries=self.params.io_retries,
                            backoff=self.params.io_backoff, sleep=self.sleep)
        self.params.log(2, f"checkpoint committed at iteration {step}")
        if telemetry.enabled():
            try:
                nbytes = os.path.getsize(path)
            except OSError:
                nbytes = None
            telemetry.event("checkpoint", "save", {
                "step": step, "chunk": chunk, "bytes": nbytes, "crc": "crc32-per-leaf",
                "seconds": round(time.perf_counter() - t0, 6)})
            telemetry.inc("checkpoint.saves")
            if nbytes:
                telemetry.inc("checkpoint.bytes", nbytes)

    def run(self):
        p = self.params
        solver = self.solver
        state = solver.init_state()
        if self.store is not None and p.resume:
            state = self._resume_state(state)
        chunk = 0
        while not solver.is_done(state):
            if p.max_chunks is not None and chunk >= p.max_chunks:
                break
            new_state = solver.step_chunk(state, p.checkpoint_every)
            if self.fault_plan is not None:
                new_state = self.fault_plan.poison(chunk, new_state)
            if p.check_divergence and not tree_all_finite(new_state):
                raise ConvergenceError(
                    f"solver diverged (non-finite iterate) in chunk {chunk} near iteration "
                    f"{int(solver.iteration(state))}",
                    result=solver.extract_result(state),
                    iteration=int(solver.iteration(state)))
            state = new_state
            if telemetry.enabled():
                attrs = {"chunk": chunk, "iteration": int(solver.iteration(state))}
                resid = _residual_of(state)
                if resid is not None:
                    attrs["resid"] = resid
                telemetry.event("solver", getattr(solver, "kind", "chunked_solver"), attrs)
            if self.store is not None:
                self._commit(state, chunk)
            if self.fault_plan is not None:
                self.fault_plan.after_commit(chunk)
            chunk += 1
        return solver.extract_result(state)
