"""Bounded admission queue: depth-capped, tenant-laned, key-aware take
(port of ``libskylark_tpu/serve/admission.py``; host-only).

Admission control happens at the door (``offer``): a full queue rejects
with :class:`~libskylark_tpu_torch.utils.exceptions.AdmissionError` (code 112)
instead of queueing unboundedly — under overload the tail latency of
everything already admitted stays bounded, and shed requests carry a
structured error their caller can back off on.  The depth cap is GLOBAL
across lanes: per-tenant *rate* protection is the token-bucket quota
layer's job (code 117, enforced in the server before ``offer``).

Deadline shedding happens at *dispatch* (the server checks each taken
entry's absolute deadline before executing): an expired request never
burns device work, and its :class:`DeadlineExceededError` (code 113)
carries how long it actually waited.

``take_batch`` is the coalescing half, now scheduled as **deficit-
weighted round-robin over per-tenant lanes**: each tenant owns a FIFO
sub-queue; a lane earns ``quantum * weight`` credits when the scheduler
visits it at the head of the rotation, pays 1 credit per BATCH taken
(coalescing is deliberately unpunished — a fused batch is the cheap
outcome we want), and rotates to the tail when its deficit runs dry.
Within a tenant pick the coalescing identity is unchanged from the
legacy FIFO: the lane's head entry plus every same-key entry in that
lane, FIFO order preserved, up to ``max_coalesce``.  Cross-tenant
entries never coalesce into one batch — a batch is one tenant's work,
which is what makes per-tenant latency accounting honest.

When only ONE lane exists (every request on the default tenant — the
entire pre-QoS world) the scheduler short-circuits to that lane
directly, so single-tenant behaviour is the exact legacy head-of-line
FIFO: same order, same batches, same bits.

Counter reservations for fresh-sketch requests run inside ``offer``'s
lock (the ``on_admit`` callback), so the reservation order IS the
admission order — deterministic and replayable regardless of how
batches later form.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.exceptions import AdmissionError
from .qos import DEFAULT_TENANT, LaneConfig

__all__ = ["Entry", "AdmissionQueue"]


class Entry:
    """One admitted request riding the queue."""

    __slots__ = (
        "request", "future", "key", "op", "payload", "squeeze",
        "t_admit", "t_pop", "phases", "deadline", "sketch",
        "counter_base", "entity", "trace", "tctx", "tenant",
        "tenant_label", "cache_key", "cache_entity", "idem_key",
    )

    def __init__(self, request, future, key, op, payload=None):
        self.request = request
        self.future = future
        self.key = key
        self.op = op
        self.payload = payload
        self.squeeze = False
        self.t_admit = None
        # Phase-clock stamps: monotonic pop time (take_batch, telemetry
        # on only) and the phases dict the batcher assembles for traced
        # requests; both stay None on a disabled run.
        self.t_pop = None
        self.phases = None
        self.deadline = None
        self.sketch = None
        self.counter_base = None
        # The registry version object PINNED at validation: live-registry
        # updates publish NEW version objects, so an in-flight coalesced
        # batch executes against exactly the epoch it admitted under —
        # bitwise, regardless of folds landing while it queued.
        self.entity = None
        self.trace = {"events": []}
        # TraceContext minted at admission when telemetry is on; its
        # event list ALIASES trace["events"] so everything attached
        # mid-flight lands in the response envelope too.
        self.tctx = None
        # QoS lane key (qos.tenant_of at validation), and the BOUNDED
        # telemetry label for it (the server folds tenants beyond its
        # metric cap into "other" so an untrusted client cannot mint
        # unbounded counter names; lanes/quotas always use the raw key).
        self.tenant = DEFAULT_TENANT
        self.tenant_label = DEFAULT_TENANT
        # ResultCache key (placement_key, payload crc, pinned epoch) and
        # the entity name it invalidates under — None means uncacheable.
        self.cache_key = None
        self.cache_entity = None
        # Idempotency key for op:"update" requests — the dedup window
        # identity is (tenant, idem_key); None for every other op.
        self.idem_key = None


class AdmissionQueue:
    def __init__(self, max_depth: int, lanes: LaneConfig | None = None):
        self.max_depth = int(max_depth)
        self.lanes = lanes or LaneConfig()
        self._lanes: dict[str, deque[Entry]] = {}
        self._active: deque[str] = deque()  # DRR rotation order
        self._deficit: dict[str, float] = {}
        self._charged: set[str] = set()  # credited this head-visit
        self._depth = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return self._depth

    def depth_by_tenant(self) -> dict:
        with self._lock:
            return {t: len(q) for t, q in self._lanes.items() if q}

    def offer(self, entry: Entry, on_admit=None) -> None:
        """Admit or shed.  ``on_admit(entry)`` runs under the queue lock
        after the depth check passes — the admission-ordered side effect
        slot (fresh-sketch counter reservation)."""
        with self._cond:
            if self._closed:
                raise AdmissionError("serve queue is shut down")
            if self._depth >= self.max_depth:
                raise AdmissionError(
                    f"serve queue full ({self._depth}/{self.max_depth})",
                    queue_depth=self._depth,
                    max_depth=self.max_depth,
                )
            entry.t_admit = time.monotonic()
            if on_admit is not None:
                on_admit(entry)
            tenant = entry.tenant or DEFAULT_TENANT
            lane = self._lanes.get(tenant)
            if lane is None:
                lane = deque()
                self._lanes[tenant] = lane
                self._active.append(tenant)
                self._deficit[tenant] = 0.0
            lane.append(entry)
            self._depth += 1
            self._cond.notify()

    # -- DRR scheduling -----------------------------------------------------

    def _drop_lane_locked(self, tenant):
        self._lanes.pop(tenant, None)
        self._deficit.pop(tenant, None)
        self._charged.discard(tenant)
        try:
            self._active.remove(tenant)
        except ValueError:
            pass

    def _pick_lane_locked(self):
        """Return the tenant whose lane serves the next batch, or None.

        Lone-lane short circuit: with a single active lane DRR reduces
        to FIFO, so skip the credit bookkeeping entirely — the default-
        tenant world stays structurally identical to the legacy queue.
        """
        while self._active and not self._lanes.get(self._active[0]):
            self._drop_lane_locked(self._active[0])
        if not self._active:
            return None
        if len(self._active) == 1:
            return self._active[0]
        for _ in range(2 * len(self._active)):
            tenant = self._active[0]
            lane = self._lanes.get(tenant)
            if not lane:
                self._drop_lane_locked(tenant)
                continue
            if tenant not in self._charged:
                # Credit once per head-visit; cap so an idle-then-bursty
                # lane cannot bank unbounded credit.
                w = self.lanes.weight(tenant)
                quantum = self.lanes.quantum * w
                cap = max(2.0, 2.0 * quantum)
                self._deficit[tenant] = min(
                    cap, self._deficit.get(tenant, 0.0) + quantum)
                self._charged.add(tenant)
            if self._deficit[tenant] >= 1.0:
                return tenant
            # Out of credit: rotate to the tail, next lane gets credit.
            self._charged.discard(tenant)
            self._active.rotate(-1)
        return self._active[0]  # all lanes broke; serve head anyway

    def _settle_lane_locked(self, tenant):
        """Charge one batch to ``tenant`` and rotate if its credit ran
        dry (or its lane emptied)."""
        if len(self._active) <= 1:
            if not self._lanes.get(tenant):
                self._drop_lane_locked(tenant)
            return
        self._deficit[tenant] = self._deficit.get(tenant, 0.0) - 1.0
        if not self._lanes.get(tenant):
            self._drop_lane_locked(tenant)
        elif self._deficit[tenant] < 1.0:
            self._charged.discard(tenant)
            if self._active and self._active[0] == tenant:
                self._active.rotate(-1)

    def _take_same_key_locked(self, lane, batch, max_coalesce,
                              stamp: bool = False):
        key = batch[0].key
        keep = deque()
        while lane and len(batch) < max_coalesce:
            e = lane.popleft()
            if e.key == key:
                if stamp:
                    e.t_pop = time.monotonic()
                batch.append(e)
                # Freed at pop, not at take_batch return: entries in the
                # in-flight batch no longer hold queue depth, so a
                # coalesce-window linger near capacity cannot shed 112
                # for requests the drained queue has room for.
                self._depth -= 1
            else:
                keep.append(e)
        keep.extend(lane)
        lane.clear()
        lane.extend(keep)

    def take_batch(self, max_coalesce: int, window_s: float = 0.0):
        """Block for work; return one tenant's head entry + all same-key
        entries from that tenant's lane (up to ``max_coalesce``), or
        ``None`` once closed and drained.  ``window_s`` > 0 lingers
        briefly for same-key same-tenant arrivals when the batch is not
        yet full — latency traded for fuller batches.  Depth is released
        entry-by-entry as the batch forms, so lingering never holds
        admission capacity against ``offer``."""
        from .. import telemetry

        with self._cond:
            while True:
                tenant = self._pick_lane_locked()
                if tenant is not None:
                    break
                if self._closed:
                    return None
                self._cond.wait(timeout=0.1)
            # Phase-clock pop stamps (admit_wait ends / coalesce_linger
            # starts here) — gated so a disabled run allocates nothing.
            stamp = telemetry.enabled()
            lane = self._lanes[tenant]
            head = lane.popleft()
            if stamp:
                head.t_pop = time.monotonic()
            batch = [head]
            self._depth -= 1
            self._take_same_key_locked(lane, batch, max_coalesce, stamp)
            if window_s > 0:
                end = time.monotonic() + window_s
                while len(batch) < max_coalesce and not self._closed:
                    left = end - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                    lane = self._lanes.get(tenant)
                    if lane is None:
                        break
                    self._take_same_key_locked(lane, batch, max_coalesce,
                                               stamp)
            self._settle_lane_locked(tenant)
            return batch

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self):
        """Remove and return every queued entry (shutdown path),
        admission-ordered across lanes."""
        with self._cond:
            out = []
            for tenant in list(self._active):
                out.extend(self._lanes.get(tenant, ()))
            out.sort(key=lambda e: e.t_admit or 0.0)
            self._lanes.clear()
            self._active.clear()
            self._deficit.clear()
            self._charged.clear()
            self._depth = 0
            return out
