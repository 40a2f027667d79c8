"""Chaos-tested fleet autoscaler: spawn and drain replicas against load
(port of ``libskylark_tpu/serve/autoscale.py``; host-only).

The :class:`Autoscaler` is a control loop over the fleet's own
observability plane — the per-replica ``load_report()``s the router
already polls — that changes MEMBERSHIP instead of shedding: queue
depth (or p99) above target spawns a replica, a persistently idle
fleet drains one.  It builds entirely on the zero-downtime discipline
the fleet layer already enforces:

- **Scale-up rides the join fence.**  A spawned replica's
  ``Server.start`` primes the full plan ladder BEFORE its workers
  spawn, and ``Router.join`` marks it placeable only once its report
  shows a live worker — so a cold replica can never receive traffic it
  would stall on compiling, and a replica with a mismatched registry
  is refused outright (code 109).
- **Scale-down drains to zero.**  The victim is ``Router.drain``-ed
  (no NEW placements; in-flight and queued work finishes; heartbeats
  keep flowing) and only ``Router.remove``-d — a clean epoch-bumped
  ``leave``, never a code-114 eject — once its queue reads empty.  No
  caller ever sees a shed or a lost-replica error because the fleet
  got smaller on purpose.
- **Every decision is ledgered**: a bounded in-process decision log
  (:attr:`Autoscaler.ledger`), ``autoscale.*`` counters, and one
  telemetry trace event per decision, so a post-mortem can replay why
  the fleet was the size it was at any tick.

Faults are injected through a plan object with ``before_tick(tick)``
(:class:`~libskylark_tpu_torch.resilient.FleetFaultPlan`) bound to the
loop, which fires die-under-load /
slow-heartbeat / join-storm / flapping faults at exact ticks,
deterministically.

The loop is deterministic and test-drivable: ``interval_s=0`` (default)
means nothing runs in the background — callers step the loop themselves
with :meth:`step`, injecting their own clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from .. import telemetry

__all__ = ["AutoscaleParams", "Autoscaler"]


@dataclass
class AutoscaleParams:
    """Control-loop targets and limits.

    - ``min_replicas`` / ``max_replicas``: hard membership bounds; the
      loop never drains below the floor nor spawns past the ceiling.
    - ``queue_high``: mean placeable queue depth above which the loop
      scales up.
    - ``queue_low``: mean depth at or below which the fleet counts as
      idle (a scale-down candidate).
    - ``p99_high_ms``: optional latency target; reported p99 above it
      scales up even when queues look shallow (``None`` disables).
    - ``cooldown_ticks``: decision ticks to hold after any scale event
      — one replica's worth of effect must land before the next
      decision, or the loop oscillates.
    - ``idle_ticks``: consecutive idle ticks required before a drain
      starts; a single quiet tick between bursts must not shrink the
      fleet.
    - ``drain_timeout_s``: a draining replica that has not reached an
      empty queue within this window is removed anyway (its queue is
      shedding-bounded, so this only fires on a wedged replica).
    - ``interval_s``: background thread period; ``0`` = caller-stepped.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 8.0
    queue_low: float = 1.0
    p99_high_ms: float | None = None
    cooldown_ticks: int = 2
    idle_ticks: int = 3
    drain_timeout_s: float = 30.0
    interval_s: float = 0.0


class Autoscaler:
    """Membership control loop over a :class:`~.router.Router`.

    ``factory(name) -> Server`` builds a replica for scale-up; the
    autoscaler starts it (prime-before-placeable), joins it, and owns
    its lifecycle — a drained owned replica is ``stop()``-ed after it
    leaves the membership table.  Replicas the autoscaler did not spawn
    are drained/removed but never stopped (their owner does that).

    ``fault_plan`` (optional): an object with ``before_tick(tick)``,
    called at the top of every :meth:`step`, so chaos lands at
    deterministic ticks.
    """

    def __init__(self, router, factory, params: AutoscaleParams | None = None,
                 *, fault_plan=None, name_prefix: str = "auto"):
        self.router = router
        self.factory = factory
        self.params = params or AutoscaleParams()
        self.fault_plan = fault_plan
        self.name_prefix = name_prefix
        self.ledger: deque[dict] = deque(maxlen=256)
        self._owned: dict[str, object] = {}
        self._draining: dict[str, float] = {}  # name -> drain start (clock)
        self._tick = 0
        self._seq = 0
        self._cooldown = 0
        self._idle_streak = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def adopt(self, name: str, server) -> None:
        """Register an existing in-process replica as autoscaler-owned,
        so a later drain of it also stops its worker threads."""
        self._owned[name] = server

    def start(self) -> "Autoscaler":
        if self.params.interval_s > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="skylark-autoscale", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.params.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must survive
                telemetry.inc("autoscale.loop_errors")

    # -- the control loop ---------------------------------------------------

    def step(self, now: float | None = None) -> dict:
        """One decision tick: fire scheduled faults, sweep heartbeats,
        progress drains, then decide scale_up / scale_down / hold.
        Returns the ledgered decision record.  Deterministic under an
        injected ``now`` — the chaos drills replay exact schedules."""
        now = time.monotonic() if now is None else now
        self._tick += 1
        telemetry.inc("autoscale.ticks")
        if self.fault_plan is not None:
            self.fault_plan.before_tick(self._tick)
        self.router.poll_once(now)
        fleet = self.router.fleet_report()
        members = fleet["members"]
        self._progress_drains(members, now)
        placeable = {
            n: m for n, m in members.items() if m.get("placeable")
        }
        depths = [
            m["report"].get("queue_depth", 0) or 0
            for m in placeable.values()
        ]
        mean_depth = (sum(depths) / len(depths)) if depths else 0.0
        p99 = max(
            (
                (m["report"].get("latency") or {}).get("latency_p99_ms", 0.0)
                for m in placeable.values()
            ),
            default=0.0,
        )
        decision = {
            "tick": self._tick,
            "replicas": len(members),
            "placeable": len(placeable),
            "draining": len(self._draining),
            "mean_depth": round(mean_depth, 3),
            "p99_ms": round(p99, 3),
        }
        if self._cooldown > 0:
            self._cooldown -= 1
            decision["action"] = "cooldown"
            return self._ledger(decision)
        hot = mean_depth > self.params.queue_high or (
            self.params.p99_high_ms is not None
            and p99 > self.params.p99_high_ms
        )
        idle = mean_depth <= self.params.queue_low and not hot
        self._idle_streak = self._idle_streak + 1 if idle else 0
        # Capacity counts placeable members plus anything mid-join this
        # loop owns; draining members are already spoken for.
        live = len(placeable)
        if hot and live < self.params.max_replicas:
            decision.update(self._scale_up())
            self._cooldown = self.params.cooldown_ticks
            self._idle_streak = 0
        elif (
            idle
            and self._idle_streak >= self.params.idle_ticks
            and live > self.params.min_replicas
            and not self._draining
        ):
            decision.update(self._scale_down(placeable))
            self._cooldown = self.params.cooldown_ticks
            self._idle_streak = 0
        else:
            decision["action"] = "hold"
        return self._ledger(decision)

    def _progress_drains(self, members: dict, now: float) -> None:
        """Retire draining members whose queues reached zero (clean
        ``leave``), or whose drain window expired (wedged — removed
        anyway, ledgered as forced)."""
        for name in list(self._draining):
            member = members.get(name)
            started = self._draining[name]
            if member is None:  # ejected/removed behind our back
                self._draining.pop(name)
                self._finish_drain(name, "gone", members)
                continue
            depth = member["report"].get("queue_depth")
            drained = depth == 0
            expired = now - started > self.params.drain_timeout_s
            if drained or expired:
                self._draining.pop(name)
                self.router.remove(
                    name, reason="drained" if drained else "drain timeout"
                )
                self._finish_drain(
                    name, "drained" if drained else "forced", members
                )

    def _finish_drain(self, name: str, how: str, members: dict) -> None:
        telemetry.inc("autoscale.drains_done")
        telemetry.event(
            "autoscale", "drain_done", {"replica": name, "how": how}
        )
        srv = self._owned.pop(name, None)
        if srv is not None:
            try:
                srv.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def _scale_up(self) -> dict:
        self._seq += 1
        name = f"{self.name_prefix}-{self._seq}"
        telemetry.inc("autoscale.scale_ups")
        try:
            server = self.factory(name)
            # prime-before-placeable: start() captures the full plan
            # ladder BEFORE spawning workers; join() then fences the
            # registry signature and flips placeable only on a live
            # worker report — a cold or mismatched replica never takes
            # traffic.
            server.start()
            self.router.join(name, server=server)
        except Exception as e:  # noqa: BLE001 — a failed spawn is a decision, not a crash
            telemetry.inc("autoscale.spawn_failures")
            telemetry.error_event("autoscale.spawn", e, replica=name)
            try:
                server.stop()
            except Exception:  # noqa: BLE001
                pass
            return {"action": "scale_up_failed", "replica": name,
                    "error": f"{type(e).__name__}: {e}"[:200]}
        self._owned[name] = server
        telemetry.event("autoscale", "scale_up", {"replica": name})
        return {"action": "scale_up", "replica": name}

    def _scale_down(self, placeable: dict) -> dict:
        victim = self._pick_victim(placeable)
        if victim is None:
            return {"action": "hold"}
        self.router.drain(victim)
        self._draining[victim] = time.monotonic()
        telemetry.inc("autoscale.scale_downs")
        telemetry.event("autoscale", "scale_down", {"replica": victim})
        return {"action": "scale_down", "replica": victim}

    def _pick_victim(self, placeable: dict) -> str | None:
        """Deterministic: the newest autoscaler-spawned replica first
        (LIFO — the fleet returns to its hand-built core), else the
        lexicographically last placeable member."""
        owned = sorted(n for n in placeable if n in self._owned)
        if owned:
            return owned[-1]
        names = sorted(placeable)
        return names[-1] if names else None

    def _ledger(self, decision: dict) -> dict:
        self.ledger.append(decision)
        telemetry.event("autoscale", "decision", dict(decision))
        return decision

    # -- observability ------------------------------------------------------

    def report(self) -> dict:
        """The ``skylark-top`` panel payload: current shape, targets,
        and the ledger tail."""
        return {
            "tick": self._tick,
            "owned": sorted(self._owned),
            "draining": sorted(self._draining),
            "cooldown": self._cooldown,
            "idle_streak": self._idle_streak,
            "params": {
                "min_replicas": self.params.min_replicas,
                "max_replicas": self.params.max_replicas,
                "queue_high": self.params.queue_high,
                "queue_low": self.params.queue_low,
                "p99_high_ms": self.params.p99_high_ms,
            },
            "ledger": list(self.ledger)[-8:],
        }
