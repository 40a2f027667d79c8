"""The exceptions this slice of the port raises, with the JAX package's
stable error codes (``libskylark_tpu/utils/exceptions.py``)."""

from __future__ import annotations

__all__ = ["SkylarkError", "AllocationError", "InvalidParameters", "SketchError",
           "UnsupportedError", "IOError_", "ConvergenceError", "CheckpointError",
           "NumericalHealthError", "WorldMismatchError", "StaleEpochError", "AdmissionError",
           "DeadlineExceededError", "ReplicaLostError", "RefinementError",
           "RegistryEpochError", "QuotaExceededError", "JournalError"]


class SkylarkError(Exception):
    """Base (≙ ``skylark_exception``, code 100)."""

    code = 100


class AllocationError(SkylarkError):
    code = 101


class InvalidParameters(SkylarkError, ValueError):
    code = 102


class SketchError(SkylarkError):
    code = 103


class UnsupportedError(SkylarkError, NotImplementedError):
    code = 104


class IOError_(SkylarkError, IOError):
    code = 105


class ConvergenceError(SkylarkError):
    """An iterative solve diverged (NaN/Inf iterates) or was halted by a
    guard.  ``result`` carries the best iterate observed before the halt,
    so callers can degrade gracefully instead of receiving garbage."""

    code = 106

    def __init__(self, msg, result=None, iteration=None):
        super().__init__(msg)
        self.result = result
        self.iteration = iteration


class CheckpointError(IOError_):
    """A checkpoint failed integrity validation (bad CRC, wrong object
    type, missing leaves, unreadable container).  Subclasses ``IOError_``
    so IO error handling keeps working."""

    code = 107


class NumericalHealthError(SkylarkError):
    """A numerical-health check fired and no recovery was left: the guard
    ladder (``guard.run_ladder``) ran out of rungs with no dense fallback,
    a finiteness sentinel (``guard.check_finite``) tripped, or a check
    fired under ``SKYLARK_GUARD=0`` where the guard would have fallen
    back.  ``stage`` names the pipeline stage whose probe tripped and
    ``report`` carries the ladder's ``RecoveryReport`` when there was
    one."""

    code = 108

    def __init__(self, msg, stage=None, report=None):
        super().__init__(msg)
        self.stage = stage
        self.report = report



class WorldMismatchError(SkylarkError):
    """An elastic distributed stream was resumed (or joined) under a
    world that disagrees with the one that wrote its state: different
    distributed world size, a different row partition, or ranks
    whose partition/epoch signatures disagree at the barrier handshake.
    Merging partial sketches across such a mismatch would silently
    combine stale or mis-addressed partials, so the engine fails fast
    instead.  ``expected``/``got`` carry the two sides of the mismatch
    (dicts or scalars, best-effort) for diagnostics."""

    code = 109

    def __init__(self, msg, expected=None, got=None):
        super().__init__(msg)
        self.expected = expected
        self.got = got

class CollectiveTimeoutError(SkylarkError):
    """A deadline-bounded collective (the elastic handshake, the
    cross-host psum) did not complete within its deadline: at least one
    peer never arrived (dead, hung, or stuck in device work).  Raised
    instead of hanging the world, so an orchestrator can kill the job and
    resume with ``resume_policy="repartition"``.  ``phase`` names the
    collective; ``deadline_s`` is the budget that expired; ``stragglers``
    lists the ranks whose heartbeats never reached the phase (empty when
    no heartbeat directory was configured)."""

    code = 110

    def __init__(self, msg, phase=None, deadline_s=None, stragglers=None):
        super().__init__(msg)
        self.phase = phase
        self.deadline_s = deadline_s
        self.stragglers = stragglers


class StaleEpochError(SkylarkError):
    """A checkpoint slot (or a peer) carries another elastic epoch than
    this process runs at: its state belongs to a superseded partition.
    Deliberately not a ``CheckpointError``, so the store's corrupt-slot
    fallback cannot swallow it and load an equally stale older slot.
    ``expected``/``got`` carry the two epochs."""

    code = 111

    def __init__(self, msg, expected=None, got=None):
        super().__init__(msg)
        self.expected = expected
        self.got = got



class AdmissionError(SkylarkError):
    """The serve layer's bounded request queue refused a request at
    admission: accepting it would exceed the configured queue depth.
    Load-shedding at the door keeps queue wait (and therefore tail
    latency) bounded under overload — the caller should back off and
    retry rather than pile on.  ``queue_depth``/``max_depth`` carry the
    observed and configured depths."""

    code = 112

    def __init__(self, msg, queue_depth=None, max_depth=None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.max_depth = max_depth


class DeadlineExceededError(SkylarkError):
    """A served request's deadline expired before its batch dispatched
    (or before admission completed).  Shedding at dispatch time — not
    after compute — means an expired request never burns device work its
    caller has already given up on.  ``deadline_ms`` is the budget the
    request carried; ``waited_ms`` how long it actually sat queued."""

    code = 113

    def __init__(self, msg, deadline_ms=None, waited_ms=None):
        super().__init__(msg)
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms


class ReplicaLostError(SkylarkError):
    """A serving replica disappeared from the fleet: its load-report
    heartbeat went stale past the router's timeout, its worker thread
    died, or a request in flight to it failed at the transport layer.
    The router ejects the replica from the membership table (bumping the
    fleet epoch so placement decisions are fenced, exactly like the
    elastic layer's :class:`StaleEpochError` discipline) and re-places
    the affected keys on the survivors; this error reaches a caller only
    when NO placeable replica remains.  ``replica`` names the lost
    member; ``last_heartbeat_s`` is the age of its last successful load
    report (best-effort, ``None`` when it never reported)."""

    code = 114

    def __init__(self, msg, replica=None, last_heartbeat_s=None):
        super().__init__(msg)
        self.replica = replica
        self.last_heartbeat_s = last_heartbeat_s

class RefinementError(SkylarkError):
    """Mixed-precision iterative refinement stagnated or diverged: the
    f64 residual gate was not reached before the stagnation/divergence
    detector fired.  Under the guard ladder this is a RESKETCH verdict
    (the ladder falls to a fresh sketch, a grown one, and the exact
    dense solve), so it reaches a caller only under ``SKYLARK_GUARD=0``.
    ``iters`` is the sweep budget, ``residual`` the certificate's cond
    estimate, and ``stage`` the pipeline stage (``"refine_ls"``)."""

    code = 115

    def __init__(self, msg, iters=None, residual=None, stage=None):
        super().__init__(msg)
        self.iters = iters
        self.residual = residual
        self.stage = stage



class RegistryEpochError(SkylarkError):
    """A served request pinned a registry version the entity no longer
    (or does not yet) serves: live registries mint a new epoch per
    update (edge fold, row append/downdate, model swap) and retire the
    superseded version once its in-flight batches drain.  Failing fast
    with the two epochs — instead of serving the CURRENT version to a
    caller that asked for a retired one — is what keeps the bitwise
    contract honest: a pinned caller either gets the exact bits of the
    version it named or a structured refusal, never silently-new bits.
    ``requested``/``current`` carry the two epochs; ``entity`` names
    the registered system/model/graph."""

    code = 116

    def __init__(self, msg, requested=None, current=None, entity=None):
        super().__init__(msg)
        self.requested = requested
        self.current = current
        self.entity = entity


class QuotaExceededError(SkylarkError):
    """A served request was shed at the door because its TENANT's
    token-bucket quota is exhausted — distinct from the global
    depth/deadline sheds (112/113), which protect the *server*: this
    code protects the *other tenants*.  A noisy tenant burning its
    bucket keeps shedding 117 while polite tenants' requests admit
    normally, so one caller's retry storm can no longer starve the
    shared queue.  ``tenant`` names the lane; ``rate``/``burst`` are
    the bucket's configured refill rate (requests/s) and capacity;
    ``retry_after_ms`` is how long until one token accrues — the
    structured backoff hint."""

    code = 117

    def __init__(self, msg, tenant=None, rate=None, burst=None,
                 retry_after_ms=None):
        super().__init__(msg)
        self.tenant = tenant
        self.rate = rate
        self.burst = burst
        self.retry_after_ms = retry_after_ms


class JournalError(IOError_):
    """The serve registry's write-ahead journal failed integrity
    validation or cannot express a mutation durably.  A torn FINAL line
    is *not* this error — a crash mid-append legitimately leaves one,
    so recovery truncates and counts it; this code fires on damage the
    crash model cannot explain: a CRC-bad or unparseable record with
    valid records AFTER it, an epoch gap between consecutive records,
    or a registered object (an exotic model class) that has no journal
    codec and therefore cannot survive a restart.  Subclasses
    ``IOError_`` like :class:`CheckpointError` so pre-existing IO error
    handling keeps working.  ``path`` names the journal file,
    ``record`` is the 1-based line number of the offending record, and
    ``reason`` is a short machine-readable tag (``"crc"``,
    ``"epoch-gap"``, ``"opaque-model"``, ...)."""

    code = 118

    def __init__(self, msg, path=None, record=None, reason=None):
        super().__init__(msg)
        self.path = path
        self.record = record
        self.reason = reason
