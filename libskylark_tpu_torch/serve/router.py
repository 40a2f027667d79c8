"""The fleet front door: profile-aware routing over serving replicas
(port of ``libskylark_tpu/serve/router.py``; host-only).

One :class:`Router` owns a membership table of replicas — in-process
:class:`~.server.Server` objects and/or remote HTTP servers — and
places each request on one of them.  Placement is a PURE function of
the request's :func:`~.protocol.placement_key` and the frozen load
reports (:func:`choose_replica` — deterministic, unit-testable with
hand-built reports):

1. **Key affinity first.**  Requests sharing a placement key coalesce
   into one fused dispatch only if they land on the same replica, so
   the router keeps a key→replica affinity map and honors it while the
   replica stays placeable and unsaturated.  Affinity is what makes a
   fleet of K replicas behave like K independent coalescers rather
   than one diluted one.
2. **Profile-aware spill.**  A new (or evicted) key goes to the
   unsaturated replica with the lowest live queue depth, ties broken
   by measured per-key throughput — the replica's own ``load_report``
   numbers first, the policy profile store's prior (which survives
   restarts) when the replica hasn't served the key yet — then by name
   for determinism.
3. **Shed at the door.**  When every placeable replica reports a full
   queue, the router sheds with the same code-112
   :class:`~..utils.exceptions.AdmissionError` envelope a single
   server's admission queue uses: one backoff discipline fleet-wide.

Membership rides the elastic layer's fencing discipline: every
replica carries a registry
*signature* (CRC32 of its canonical census) and the fleet admits a
joiner only on signature match — a code-109
:class:`~..utils.exceptions.WorldMismatchError` otherwise, because a
fleet that silently mixed registries would resolve one model name to
different models.  Every membership change bumps the fleet *epoch*
(placement decisions are stamped with it).  A replica whose heartbeat
goes stale past the timeout is ejected — code 114,
:class:`~..utils.exceptions.ReplicaLostError` — its affinity entries
dropped, and requests that were in flight to it are transparently
re-placed on the survivors; 114 reaches a caller only when no
placeable replica remains.

Zero-downtime join: :meth:`Router.join` marks a member placeable only
once its load report shows a live worker — and :meth:`Server.start`
primes the plan-cache ladder *before* spawning workers, so a joining
replica can never receive traffic it would stall on compiling.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

from .. import telemetry
from ..utils.exceptions import (
    AdmissionError,
    ReplicaLostError,
    WorldMismatchError,
)
from . import protocol

__all__ = [
    "HttpReplica",
    "InProcessReplica",
    "Router",
    "RouterParams",
    "choose_replica",
]


class InProcessReplica:
    """A same-process :class:`~.server.Server` as a fleet member."""

    def __init__(self, name: str, server):
        self.name = name
        self.server = server

    def submit(self, request: dict) -> Future:
        return self.server.submit(request)

    def load_report(self) -> dict:
        return self.server.load_report()


class HttpReplica:
    """A remote server (``serve_http`` front end) as a fleet member.

    ``submit`` runs the blocking HTTP call on the router's pool so the
    router thread never blocks on a slow replica; a transport-level
    failure surfaces as the future's exception, which the router's
    failover path converts into ejection + re-placement."""

    def __init__(self, name: str, url: str, *, timeout: float | None = None,
                 pool: ThreadPoolExecutor | None = None,
                 retries: int = 3, backoff: float = 0.05):
        import random

        from .client import Client

        self.name = name
        self.url = url.rstrip("/")
        # timeout=None defers to SKYLARK_HTTP_TIMEOUT_S (default 60s,
        # bounded): a hung replica's recv must raise so the failover /
        # ejection ladder (114) can run instead of wedging this thread.
        self._client = Client(url=url, timeout=timeout)
        self._pool = pool
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._sleep = time.sleep  # injectable: tests skip the real wait
        self._jitter = random.random  # likewise

    def submit(self, request: dict) -> Future:
        if self._pool is None:
            fut: Future = Future()
            try:
                fut.set_result(self._client.call(request))
            except Exception as e:  # noqa: BLE001 — transport loss
                fut.set_exception(e)
            return fut
        return self._pool.submit(self._client.call, request)

    def load_report(self) -> dict:
        """Fetch the replica's load report, retrying transient transport
        errors with jittered exponential backoff (the ``FsspecSource.
        open`` ladder): ONE dropped connection must not read as a dead
        heartbeat — ejection is for real silence, which the poll loop
        measures against ``heartbeat_timeout_s``, not for a flaky TCP
        accept."""
        attempt = 0
        while True:
            try:
                health = self._client.healthz()
                break
            except Exception as e:  # noqa: BLE001 — transport loss
                if isinstance(e, TimeoutError):
                    # A hung (not dead) replica: recv hit the bounded
                    # socket timeout.  Counted separately from generic
                    # retries — a fleet where these climb has replicas
                    # wedged in compute, not a flaky network.
                    telemetry.inc("router.report_timeouts")
                if attempt >= self.retries:
                    raise
                # Full jitter on the exponential step: a fleet's router
                # re-polling K replicas must not thunder in lockstep.
                delay = self.backoff * (2**attempt) * (0.5 + self._jitter())
                if telemetry.enabled():
                    telemetry.inc("router.report_retries")
                    telemetry.event(
                        "router", "report_retry",
                        {
                            "replica": self.name,
                            "attempt": attempt + 1,
                            "delay": round(delay, 4),
                            "error": f"{type(e).__name__}: {e}"[:200],
                        },
                    )
                self._sleep(delay)
                attempt += 1
        load = health.get("load")
        if not isinstance(load, dict):
            raise ReplicaLostError(
                f"replica {self.name} reports no load (old server?)",
                replica=self.name,
            )
        return load


@dataclass
class RouterParams:
    """Fleet knobs.

    - ``heartbeat_interval_s``: background load-report poll period;
      ``0`` (default) disables the thread — callers (and tests) drive
      :meth:`Router.poll_once` themselves, deterministically.
    - ``heartbeat_timeout_s``: a member whose last successful report is
      older than this is ejected (code 114).
    - ``max_failover``: in-flight re-placements one request may ride
      before the router gives up with :class:`ReplicaLostError`.
    """

    heartbeat_interval_s: float = 0.0
    heartbeat_timeout_s: float = 5.0
    max_failover: int = 2


@dataclass
class _Member:
    name: str
    replica: object
    report: dict = field(default_factory=dict)
    last_heartbeat: float = 0.0
    placeable: bool = False
    # Draining members stay in the fleet (their in-flight work finishes,
    # their reports keep flowing) but take no NEW placements; the
    # autoscaler removes them once their queue reads zero.  A drain is a
    # deliberate decision, never a fault — no 114 is minted for it.
    draining: bool = False


def _saturated(report: dict) -> bool:
    depth = report.get("queue_depth")
    cap = report.get("max_queue")
    return depth is not None and cap is not None and depth >= cap


def _key_throughput(report: dict, key: str) -> float:
    """The replica's expected speed on this key: its own measurement
    when it has served the key, else the policy profile store's prior
    (any entry — a host-speed proxy), else 0."""
    row = (report.get("throughput") or {}).get(key) or {}
    tput = row.get("rows_per_s")
    if tput:
        return float(tput)
    best = 0.0
    for entry in (report.get("profiles") or {}).values():
        v = entry.get("rows_per_s") if isinstance(entry, dict) else None
        if v:
            best = max(best, float(v))
    return best


def _cached_for_key(report: dict, key: str) -> int:
    """How many warm cached results this replica's load report claims
    for ``key`` — the fleet half of the result cache: reports without a
    cache block (older replicas, hand-built test reports) read as 0, so
    the preference only ever engages when a replica actually holds the
    key's results."""
    cache = report.get("cache")
    if not isinstance(cache, dict):
        return 0
    return int((cache.get("keys") or {}).get(key, 0))


def choose_replica(key: str, members: dict, affinity: dict) -> str | None:
    """Pure placement: replica name, or ``None`` when every placeable
    member is saturated (the caller sheds 112).

    ``members`` maps name → ``{"placeable": bool, "report": {...}}``
    (frozen — this function reads, never mutates); ``affinity`` maps
    placement key → the name that last served it.

    Order of preference after the affinity pin: a replica already
    holding cached results for this key (so a hot repeated request is a
    fleet-wide dict lookup — ONE dispatch total, not one per replica),
    then lowest queue depth, then measured throughput, then name.  The
    cache preference is binary (holds any vs none): hoarding MORE
    entries for a key must not outrank an idle replica's queue.
    """
    def open_(m) -> bool:
        return m["placeable"] and not _saturated(m["report"])

    pinned = affinity.get(key)
    if pinned is not None and pinned in members and open_(members[pinned]):
        return pinned
    candidates = [(n, m) for n, m in members.items() if open_(m)]
    if not candidates:
        return None
    return min(
        candidates,
        key=lambda nm: (
            -min(_cached_for_key(nm[1]["report"], key), 1),
            nm[1]["report"].get("queue_depth", 0),
            -_key_throughput(nm[1]["report"], key),
            nm[0],
        ),
    )[0]


class Router:
    def __init__(self, params: RouterParams | None = None):
        self.params = params or RouterParams()
        self._members: dict[str, _Member] = {}
        self._affinity: dict[str, str] = {}
        self._epoch = 0
        self._signature: int | None = None
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="skylark-router"
        )
        self._hb_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()

    # -- membership ---------------------------------------------------------

    def join(self, name: str, server=None, *, url: str | None = None,
             timeout: float | None = None) -> dict:
        """Admit a replica (in-process ``server=`` or remote ``url=``).

        Fetches its load report, fences its registry signature against
        the fleet's, bumps the epoch, and marks it placeable only if
        its worker loop is already alive (which, via ``Server.start``'s
        prime-then-spawn ordering, implies its plan ladder is warm).
        Returns the membership record; raises
        :class:`WorldMismatchError` (109) on signature mismatch."""
        if (server is None) == (url is None):
            raise ValueError("pass exactly one of server= or url=")
        replica = (
            InProcessReplica(name, server)
            if server is not None
            else HttpReplica(name, url, timeout=timeout, pool=self._pool)
        )
        report = replica.load_report()
        with self._lock:
            sig = report.get("signature")
            if self._members and self._signature != sig:
                exc = WorldMismatchError(
                    f"replica {name!r} registry signature {sig} does not "
                    f"match the fleet's {self._signature}; a fleet must "
                    "serve one registry",
                    expected=self._signature,
                    got=sig,
                )
                telemetry.error_event("router.join", exc, replica=name)
                raise exc
            if not self._members:
                self._signature = sig
            member = _Member(
                name, replica, report,
                last_heartbeat=time.monotonic(),
                placeable=bool(report.get("worker_alive")),
            )
            self._members[name] = member
            self._epoch += 1
            epoch = self._epoch
        telemetry.inc("router.joins")
        telemetry.event(
            "router", "join",
            {"replica": name, "epoch": epoch,
             "placeable": member.placeable},
        )
        return {
            "replica": name,
            "epoch": epoch,
            "placeable": member.placeable,
            "signature": sig,
        }

    def handle_join(self, payload: dict) -> dict:
        """The ``POST /join`` body: ``{"name": ..., "url": ...}``."""
        t = payload.get("timeout")
        return self.join(
            str(payload.get("name") or payload.get("url")),
            url=payload["url"],
            timeout=None if t is None else float(t),
        )

    def drain(self, name: str) -> bool:
        """Take a member out of NEW placements without ejecting it: its
        in-flight and queued work finishes on the replica, its heartbeat
        keeps flowing, and :meth:`remove` retires it once idle.  This is
        the scale-down half of zero-downtime membership — the mirror of
        the join fence's prime-before-placeable.  Returns False for an
        unknown member."""
        with self._lock:
            member = self._members.get(name)
            if member is None:
                return False
            member.draining = True
            member.placeable = False
            for key in [k for k, n in self._affinity.items() if n == name]:
                del self._affinity[key]
        telemetry.inc("router.drains")
        telemetry.event("router", "drain", {"replica": name})
        return True

    def remove(self, name: str, reason: str = "drained") -> bool:
        """Clean departure: pop the member, bump the fleet epoch, ledger
        a ``leave`` event.  Unlike :meth:`eject` this mints NO code-114
        error — the member left on purpose with zero work in flight.
        Returns False for an unknown member."""
        with self._lock:
            member = self._members.pop(name, None)
            if member is None:
                return False
            for key in [k for k, n in self._affinity.items() if n == name]:
                del self._affinity[key]
            self._epoch += 1
            epoch = self._epoch
        telemetry.inc("router.leaves")
        telemetry.event(
            "router", "leave",
            {"replica": name, "epoch": epoch, "reason": reason},
        )
        return True

    def eject(self, name: str, reason: str = "heartbeat lost",
              heartbeat_age_s: float | None = None) -> None:
        """Remove a member: epoch bump, affinity entries dropped (their
        keys re-place on the next request), code-114 error event."""
        with self._lock:
            member = self._members.pop(name, None)
            if member is None:
                return
            for key in [k for k, n in self._affinity.items() if n == name]:
                del self._affinity[key]
            self._epoch += 1
            epoch = self._epoch
        exc = ReplicaLostError(
            f"replica {name!r} ejected from the fleet: {reason}",
            replica=name,
            last_heartbeat_s=heartbeat_age_s,
        )
        telemetry.inc("router.ejects")
        telemetry.error_event("router.eject", exc, replica=name, epoch=epoch)
        telemetry.event(
            "router", "eject",
            {"replica": name, "epoch": epoch, "reason": reason},
        )

    def poll_once(self, now: float | None = None) -> dict:
        """One heartbeat sweep: refresh every member's load report;
        members whose reports fail (or whose workers are dead) past the
        timeout are ejected.  Returns ``{name: placeable}`` for the
        survivors.  Deterministic — tests call this directly instead of
        racing the background thread.

        Stale-but-alive discipline: a member whose report FETCH failed
        this sweep (transport hiccup, replica mid-GC) keeps its last
        report — stamped with ``report_age_s`` so placement reads its
        age honestly — and stays placeable until the silence crosses
        ``heartbeat_timeout_s``.  Ejection fires on real silence only;
        one dropped poll is not a dead replica."""
        now = time.monotonic() if now is None else now
        with self._lock:
            snapshot = list(self._members.items())
        lost = []
        for name, member in snapshot:
            fetched = True
            try:
                report = member.replica.load_report()
                alive = bool(report.get("worker_alive"))
            except Exception:  # noqa: BLE001 — a dead peer must not kill the sweep
                report, alive, fetched = None, False, False
            with self._lock:
                if self._members.get(name) is not member:
                    continue
                age = now - member.last_heartbeat
                if fetched:
                    member.report = report
                    member.placeable = alive and not member.draining
                    if alive:
                        member.last_heartbeat = now
                    elif age > self.params.heartbeat_timeout_s:
                        lost.append((name, age))
                elif age > self.params.heartbeat_timeout_s:
                    member.placeable = False
                    lost.append((name, age))
                else:
                    # stale-but-alive: keep serving on the last report,
                    # visibly aged so placement can discount it
                    member.report = dict(
                        member.report, report_age_s=round(age, 3)
                    )
        for name, age in lost:
            self.eject(name, heartbeat_age_s=round(age, 3))
        with self._lock:
            return {n: m.placeable for n, m in self._members.items()}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Router":
        if self.params.heartbeat_interval_s > 0 and self._hb_thread is None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="skylark-router-hb",
                daemon=True,
            )
            self._hb_thread.start()
        return self

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(5.0)
            self._hb_thread = None
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.params.heartbeat_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the heartbeat must survive
                pass

    # -- request path -------------------------------------------------------

    def submit(self, request: dict) -> Future:
        """Place and forward one request; ALWAYS returns a future
        resolving to a protocol response dict (fleet saturation and
        replica loss resolve to 112/114 envelopes — nothing raises),
        the same contract as :meth:`Server.submit`."""
        fut: Future = Future()
        self._dispatch(request, fut, attempt=0)
        return fut

    def call(self, request: dict | None = None, /, **fields) -> dict:
        req = dict(request or {}, **fields)
        return self.submit(req).result()

    def _dispatch(self, request: dict, outer: Future, attempt: int) -> None:
        key = protocol.placement_key(request)
        with self._lock:
            members = {
                n: {"placeable": m.placeable, "report": m.report}
                for n, m in self._members.items()
            }
            name = choose_replica(key, members, self._affinity)
            if name is not None:
                hit = self._affinity.get(key) == name
                self._affinity[key] = name
                member = self._members[name]
                epoch = self._epoch
        if name is None:
            if not members:
                exc: Exception = ReplicaLostError(
                    "no placeable replica in the fleet", replica=None
                )
            else:
                depths = [
                    m["report"].get("queue_depth") for m in members.values()
                ]
                exc = AdmissionError(
                    "every fleet replica is saturated; back off and retry",
                    queue_depth=max((d for d in depths if d is not None),
                                    default=None),
                )
            telemetry.inc("router.sheds")
            telemetry.error_event("router.place", exc, key=key)
            outer.set_result(
                protocol.error_response(
                    request.get("id"), exc,
                    {"events": [{"kind": "fleet_shed", "key": key}]},
                )
            )
            return
        telemetry.inc("router.placements")
        if hit:
            telemetry.inc("router.affinity_hits")
        telemetry.event(
            "router", "placement",
            {"key": key, "replica": name, "epoch": epoch,
             "affinity": hit, "attempt": attempt},
        )
        inner = member.replica.submit(request)

        def _relay(inner_fut: Future) -> None:
            try:
                resp = inner_fut.result()
            except Exception as e:  # noqa: BLE001 — in-flight replica loss
                self.eject(name, reason=f"in-flight failure: {e}")
                if attempt < self.params.max_failover:
                    telemetry.inc("router.failovers")
                    self._dispatch(request, outer, attempt + 1)
                else:
                    exc = ReplicaLostError(
                        f"request lost {attempt + 1} replicas in flight; "
                        "giving up",
                        replica=name,
                    )
                    telemetry.error_event("router.failover", exc, key=key)
                    outer.set_result(
                        protocol.error_response(
                            request.get("id"), exc, {"events": []}
                        )
                    )
                return
            # The placement→dispatch race: the replica was chosen while
            # placeable but stopped (or was ejected) before this request
            # reached its worker.  Its shutdown envelope is a 112 with
            # no queue depth (a saturation shed always carries one) —
            # that, or an infrastructure error from a member the fleet
            # already dropped, fails over transparently exactly like a
            # raised transport loss; a 114 reaches the caller only when
            # no placeable replica remains.
            err = None if resp.get("ok") else (resp.get("error") or {})
            if err is not None and attempt < self.params.max_failover:
                shutdown = (
                    err.get("code") == 112
                    and err.get("queue_depth") is None
                )
                with self._lock:
                    gone = self._members.get(name) is not member
                if shutdown or (gone and err.get("code") in (112, 114)):
                    if not gone:
                        self.eject(name, reason="shut down in flight")
                    telemetry.inc("router.failovers")
                    telemetry.event(
                        "router", "failover",
                        {"key": key, "replica": name,
                         "code": err.get("code"), "attempt": attempt + 1},
                    )
                    self._dispatch(request, outer, attempt + 1)
                    return
            trace = resp.setdefault("trace", {})
            trace["replica"] = name
            trace["fleet_epoch"] = epoch
            outer.set_result(resp)

        inner.add_done_callback(_relay)

    # -- observability ------------------------------------------------------

    def fleet_report(self) -> dict:
        now = time.monotonic()
        with self._lock:
            cache = {"hits": 0, "misses": 0, "entries": 0, "bytes": 0}
            for m in self._members.values():
                c = (m.report or {}).get("cache")
                if isinstance(c, dict):
                    for k in cache:
                        cache[k] += int(c.get(k, 0))
            return {
                "epoch": self._epoch,
                "signature": self._signature,
                # Fleet-wide result-cache rollup over the members' load
                # reports — the shared hit/miss state of the whole fleet
                # in one place (per-replica detail stays in each report).
                "cache": cache,
                "members": {
                    n: {
                        "placeable": m.placeable,
                        "draining": m.draining,
                        "heartbeat_age_s": round(now - m.last_heartbeat, 3),
                        "report": m.report,
                    }
                    for n, m in self._members.items()
                },
                "affinity": dict(self._affinity),
            }

    def stats(self) -> dict:
        counters = {
            k.split(".", 1)[1]: v
            for k, v in telemetry.REGISTRY.snapshot()["counters"].items()
            if k.startswith("router.")
        }
        return {"fleet": self.fleet_report(), "counters": counters}
