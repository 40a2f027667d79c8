"""The long-lived in-process solve server (port of
``libskylark_tpu/serve/server.py``).

One :class:`Server` owns a :class:`~.registry.Registry` of models, LS
systems and graphs resident on one ``torch.device`` (the card unless the
caller asks for the CPU; ``cuda`` without a card raises), a bounded
:class:`~.admission.AdmissionQueue`, and worker threads (one by default)
that drain the queue in coalesced batches through ``batcher.run_batch``.
Requests enter through :meth:`submit` (async, returns a future) or
:meth:`call` (blocking); both always resolve to a protocol response
dict — errors are structured envelopes, never raised across the
serving boundary.

Warm start: :meth:`start` replays the policy layer's hot-plan profiles
(``policy.warm_start``) and then *primes* every registered system/model
through its own executor at every ladder rung a coalesced batch can
reach, so neither the first request nor the first full batch captures
a CUDA graph while other threads launch.

Telemetry: every request lands counters under the ``serve.`` prefix
(requests/ok/errors/sheds/batches/coalesced/fallbacks), queue-wait and
latency histograms, and a bounded latency reservoir for the p50/p99
that ``telemetry.snapshot()["serve"]`` folds.  All of it rides the
``SKYLARK_TELEMETRY`` gate: disabled, a server run is bit-identical
and allocation-free on the telemetry side.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import asdict, dataclass

import numpy as np

from .. import telemetry
from .._device import resolve_device
from ..core.context import SketchContext
from ..utils.exceptions import (
    DeadlineExceededError,
    InvalidParameters,
    QuotaExceededError,
    RegistryEpochError,
    SkylarkError,
)
from . import batcher, protocol
from .admission import AdmissionQueue, Entry
from .cache import ResultCache, payload_digest
from .qos import DEFAULT_TENANT, LaneConfig, TenantQuotas, tenant_of
from .registry import Registry

__all__ = ["ServeParams", "Server", "latency_percentiles", "record_latency"]

# Process-wide latency reservoir (most recent completions AND sheds)
# feeding the p50/p99 in telemetry.snapshot()["serve"]; the registry's
# histograms keep only streaming moments, so the tails need their own
# samples.  Shed requests record their queue time with ``shed=True`` —
# otherwise saturation, the one regime where sheds dominate, is exactly
# when the reservoir would flatter p99 by dropping them.  Appended ONLY
# when telemetry is enabled — a disabled run allocates nothing here.
_LATENCIES: deque[tuple[float, bool]] = deque(maxlen=4096)


def record_latency(ms: float, shed: bool = False) -> None:
    if telemetry.enabled():
        _LATENCIES.append((float(ms), bool(shed)))


def latency_percentiles() -> dict:
    """p50/p99 over ALL samples (sheds included), plus ``_served``
    variants excluding sheds and the shed sample count whenever any
    shed is in the window — so both views are always computable."""
    if not _LATENCIES:
        return {}
    samples = list(_LATENCIES)
    lat = np.sort(np.asarray([m for m, _ in samples]))
    out = {
        "latency_p50_ms": round(float(np.percentile(lat, 50)), 4),
        "latency_p99_ms": round(float(np.percentile(lat, 99)), 4),
    }
    served = np.asarray([m for m, s in samples if not s])
    shed_n = len(samples) - served.size
    if shed_n:
        out["latency_shed_samples"] = int(shed_n)
        if served.size:
            served = np.sort(served)
            out["latency_p50_ms_served"] = round(
                float(np.percentile(served, 50)), 4)
            out["latency_p99_ms_served"] = round(
                float(np.percentile(served, 99)), 4)
    return out


def _predict_dtypes(model) -> list:
    """The request dtypes :meth:`Server.prime` captures a model's predict
    plans at: the protocol's default (float64) and the model's own."""
    from ..ml.model import _dtype_name

    own = getattr(model, "W", getattr(model, "X_train", None))
    names = {"float64"}
    if own is not None and own.dtype.is_floating_point:
        name = _dtype_name(own.dtype)
        if name in ("float16", "float32", "float64"):
            names.add(name)
    return sorted(names)


@dataclass
class ServeParams:
    """Knobs of one server instance.

    - ``max_queue``: admission depth cap; requests past it shed with
      :class:`AdmissionError` (code 112).
    - ``max_coalesce``: most requests one fused dispatch may carry
      (``1`` disables coalescing — the serial-per-request reference the
      bitwise tests and the bench SLO compare against).
    - ``coalesce_window_ms``: optional linger after the head request is
      taken, trading that much latency for fuller batches.
    - ``default_deadline_ms``: deadline applied to requests that carry
      none (``None`` = no deadline).
    - ``warm_start`` / ``prime``: replay policy warm-start profiles /
      capture registered entities' plans at every lane rung at
      :meth:`Server.start`.
    - ``workers``: batcher worker threads draining the one admission
      queue.  ``K>1`` pins worker ``i`` to ``cuda:{i % device_count}``
      (every worker on the CPU for a CPU server), staging through the
      streaming layer's placer, so small-batch traffic scales with card
      count.  Coalescing is
      unchanged — ``take_batch`` is already multi-consumer-safe, and
      per-slot purity keeps results bitwise identical to a single
      worker's.
    - ``cache`` / ``cache_max_entries`` / ``cache_max_bytes``: the
      front-door :class:`~.cache.ResultCache`.  ``None`` defers to the
      ``SKYLARK_CACHE`` / ``SKYLARK_CACHE_MAX_ENTRIES`` /
      ``SKYLARK_CACHE_MAX_BYTES`` knobs.
    - ``qos_quantum`` / ``tenant_weights``: deficit-round-robin lane
      scheduling (``SKYLARK_QOS_QUANTUM`` / ``SKYLARK_QOS_WEIGHTS``).
    - ``tenant_quota_rps`` / ``tenant_quota_burst`` / ``tenant_quotas``:
      per-tenant token-bucket admission quotas shedding code-117
      envelopes (``SKYLARK_QOS_QUOTA_RPS`` / ``SKYLARK_QOS_QUOTA_BURST``
      / ``SKYLARK_QOS_QUOTAS``); the rate default 0 means unlimited.
    - ``state_dir`` / ``recover`` / ``journal_compact_every``: the
      durability layer.  A ``state_dir`` attaches a write-ahead
      :class:`~.journal.Journal` to the registry (every mint journals
      durably BEFORE it publishes); ``recover=True`` additionally
      restores the registry from that directory's snapshot + journal
      tail at construction, bitwise-identical to the process that died.
      ``journal_compact_every`` overrides ``SKYLARK_JOURNAL_COMPACT_EVERY``
      (records between snapshot compactions; ``0`` disables compaction).
    """

    max_queue: int = 256
    max_coalesce: int = 16
    coalesce_window_ms: float = 0.0
    default_deadline_ms: float | None = None
    warm_start: bool = True
    prime: bool = True
    workers: int = 1
    cache: bool | None = None
    cache_max_entries: int | None = None
    cache_max_bytes: int | None = None
    qos_quantum: float | None = None
    tenant_weights: str | dict | None = None
    tenant_quota_rps: float | None = None
    tenant_quota_burst: float | None = None
    tenant_quotas: str | dict | None = None
    state_dir: str | None = None
    recover: bool = False
    journal_compact_every: int | None = None


class Server:
    def __init__(
        self,
        params: ServeParams | None = None,
        *,
        seed: int = 0,
        context: SketchContext | None = None,
        device=None,
    ):
        self.params = params or ServeParams()
        self.device = resolve_device(device)
        self.ctx = context if context is not None else SketchContext(seed=seed)
        # ONE cache instance: the front door's response cache, the
        # cond/ppr report memo, and the load-report census are all this
        # object, so registry mints invalidate everything at once.
        self.cache = ResultCache(
            max_entries=self.params.cache_max_entries,
            max_bytes=self.params.cache_max_bytes,
            enabled=self.params.cache,
        )
        if self.params.state_dir is not None and self.params.recover:
            # Restart path: snapshot + journal tail replay, pinned
            # bitwise-identical to the registry that died (same entity
            # bits, same epoch counter, same epoch_log) — the replica
            # rejoins the fleet at the exact epoch callers observed.
            self.registry = Registry.recover(
                self.params.state_dir,
                cache=self.cache,
                compact_every=self.params.journal_compact_every,
                device=self.device,
            )
        elif self.params.state_dir is not None:
            from .journal import Journal

            self.registry = Registry(
                cache=self.cache,
                journal=Journal(
                    self.params.state_dir,
                    compact_every=self.params.journal_compact_every,
                ),
                device=self.device,
            )
        else:
            self.registry = Registry(cache=self.cache, device=self.device)
        self.quotas = TenantQuotas(
            default_rps=self.params.tenant_quota_rps,
            default_burst=self.params.tenant_quota_burst,
            quotas=self.params.tenant_quotas,
        )
        self.queue = AdmissionQueue(
            self.params.max_queue,
            lanes=LaneConfig(
                quantum=self.params.qos_quantum,
                weights=self.params.tenant_weights,
            ),
        )
        # Bounded per-tenant metric labels: the tenant key is client-
        # controlled (header/payload), so minting counter names from it
        # raw is a cardinality DoS on the telemetry registry and the
        # Prometheus exposition.  Configured tenants (weights/quotas)
        # are always labelled; unconfigured ones claim a label first-
        # come up to the cap, and everything past it folds into the
        # "other" bucket.  Lanes/quotas/trace envelopes keep raw keys.
        self._metric_tenants = {DEFAULT_TENANT}
        self._metric_tenants.update(self.queue.lanes.weights)
        self._metric_tenants.update(self.quotas.quotas)
        self._metric_tenant_cap = max(
            len(self._metric_tenants),
            int(os.environ.get("SKYLARK_QOS_TENANT_METRICS_MAX", "32")),
        )
        # Bucket registration for the phase clock + the serve latency
        # histogram: configuration, not data (registration is free and
        # survives telemetry.reset()), so the fleet's _bucket{le=...}
        # series exist from the first traced request onward.  Non-serve
        # processes never call this, so their histograms stay moment-only.
        telemetry.enable_phase_buckets()
        telemetry.enable_buckets("serve.latency_ms")
        self.warm_summary: dict | None = None
        self.primed: list[str] = []
        self._thread: threading.Thread | None = None
        self._threads: list[threading.Thread] = []
        self._fresh_seq = 0
        # per-placement-key {key: [requests, busy_seconds]} — the
        # throughput half of the load report the fleet router places by
        self._key_stats: dict[str, list] = {}
        self._stats_lock = threading.Lock()

    # -- registration (delegates; the server's context is the default
    #    counter stream, so registration order is deterministic) ------------

    def register_model(self, name, model):
        self.registry.register_model(name, model)

    def load_model(self, name, path):
        return self.registry.load_model(name, path)

    def register_system(self, name, A, **kw):
        kw.setdefault("context", self.ctx)
        return self.registry.register_system(name, A, **kw)

    def register_graph(self, name, G, **kw):
        kw.setdefault("context", self.ctx)
        return self.registry.register_graph(name, G, **kw)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Server":
        if self._thread is not None:
            return self
        if self.params.warm_start:
            from .. import policy

            self.warm_summary = policy.warm_start(device=self.device)
        if self.params.prime:
            self.prime()
        for i, dev in enumerate(self._worker_devices()):
            t = threading.Thread(
                target=self._worker, args=(dev,),
                name=f"skylark-serve-worker-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._thread = self._threads[0]
        return self

    def _worker_devices(self) -> list:
        """One slot per worker thread: ``[None]`` for the single-worker
        server (the registry's device), else worker ``i`` pins
        ``cuda:{i % device_count}`` so independent batches land on
        disjoint cards (a CPU server's workers all stay on the CPU)."""
        k = max(1, self.params.workers)
        if k == 1:
            return [None]
        if self.device.type != "cuda":
            return [self.device] * k
        import torch

        n = torch.cuda.device_count()
        return [torch.device("cuda", i % n) for i in range(k)]

    def prime(self) -> list[str]:
        """Capture every plan a coalesced batch can reach, NOW.

        Every lane rung a batch of up to ``max_coalesce`` requests pads
        to runs through its executor once, so the plans it replays (one
        per map or sketch at the base rung's block) are captured before
        traffic, not mid-traffic while other worker threads launch."""
        mc = max(1, self.params.max_coalesce)
        # Multi-worker servers prime once per DISTINCT pinned device:
        # plans are per-device.  Single-worker = [None].
        devices = list({str(d): d for d in self._worker_devices()}.values())
        for name, system in self.registry.systems.items():
            widths = sorted({batcher._lane_bucket(k) for k in range(1, mc + 1)})
            for dev in devices:
                for w in widths:
                    entries = [
                        Entry(
                            {"op": "ls_solve", "system": name}, Future(), None,
                            "ls_solve", payload=np.zeros(system.m),
                        )
                        for _ in range(w)
                    ]
                    batcher._execute_ls(self.registry, entries, dev)
            # cond-est answers from this cached report; probing it here
            # keeps the first served cond_est request off the probe cost
            system.cond_report(cache=self.cache)
            self.primed.append(f"system:{name}:{widths}")
        for name, model in self.registry.models.items():
            d = getattr(model, "input_dim", None)
            if not d:
                continue
            rungs = sorted({batcher._lane_bucket(k) for k in range(1, mc + 1)})
            for dev in devices:
                for r in rungs:
                    for dt in _predict_dtypes(model):
                        entries = [
                            Entry(
                                {"op": "predict", "model": name}, Future(),
                                None, "predict",
                                payload=np.zeros((1, int(d)), dt),
                            )
                            for _ in range(r)
                        ]
                        batcher._execute_predict(self.registry, entries, dev)
            self.primed.append(f"model:{name}:{rungs}")
        for name, gsys in self.registry.graphs.items():
            # Graph queries serve from host arrays — nothing to capture;
            # one executor pass makes the first request's path identical
            # to every later one (and catches a broken embedding NOW).
            if gsys.G.n:
                entries = [
                    Entry(
                        {"op": "ase_embed", "graph": name}, Future(), None,
                        "ase_embed",
                        payload=("rows", np.zeros(1, np.int64)),
                    )
                ]
                batcher._execute_ase_embed(self.registry, entries, None)
            self.primed.append(f"graph:{name}:k={gsys.k}")
        return self.primed

    def stop(self, timeout: float = 10.0) -> None:
        self.queue.close()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._threads = []
        self._thread = None
        for e in self.queue.drain():  # anything the workers never reached
            self._resolve_error(
                e, SkylarkError("server stopped before dispatch")
            )

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    # -- request path -------------------------------------------------------

    def submit(self, request: dict) -> Future:
        """Admit one request; ALWAYS returns a future resolving to a
        protocol response dict (sheds and validation failures resolve
        immediately with structured errors — nothing raises)."""
        fut: Future = Future()
        telemetry.inc("serve.requests")
        try:
            entry = self._validate(request, fut)
        except SkylarkError as e:
            telemetry.inc("serve.errors")
            telemetry.error_event(
                "serve.validate", e, op=request.get("op")
            )
            fut.set_result(
                protocol.error_response(
                    request.get("id"), e, {"events": []}
                )
            )
            return fut
        if entry is None:  # ping/stats answered inline
            return fut
        entry.tenant = tenant_of(request)
        entry.tenant_label = self._tenant_label(entry.tenant)
        entry.trace["tenant"] = entry.tenant
        self._tenant_inc(entry.tenant_label, "requests")
        # Trace minting at admission: None (no allocation) with
        # telemetry off; the context's event list aliases entry.trace's.
        entry.tctx = telemetry.mint(
            entry.op,
            key=entry.key,
            request_id=request.get("id"),
            deadline_ms=request.get(
                "deadline_ms", self.params.default_deadline_ms
            ),
            events=entry.trace["events"],
        )
        if entry.tctx is not None:
            entry.trace["trace_id"] = entry.tctx.trace_id
        # -- exactly-once updates (idempotency-key dedup window) ------------
        # A replayed op:"update" — the router's 112/114 failover resends
        # the same request dict, or a client retried on a timeout whose
        # first send actually landed — must NOT re-execute the mutation.
        # The registry's journal-backed dedup window keyed (tenant,
        # idem_key) holds the epoch-ledger receipt the first execution
        # minted; a hit resolves with that recorded receipt and costs
        # zero queue/quota pressure, exactly like a cache hit.
        if entry.idem_key is not None:
            # The dedup identity is (tenant, key) — tenant is only known
            # HERE, after lane assignment, so the executor-bound payload
            # picks it up now.
            entry.payload["idem"] = (entry.tenant, entry.idem_key)
            receipt = self.registry.idem_receipt(
                entry.tenant, entry.idem_key
            )
            if receipt is not None:
                entry.trace["events"].append(
                    {
                        "kind": "idem_replay",
                        "idem_key": entry.idem_key,
                        "epoch": receipt.get("epoch"),
                    }
                )
                telemetry.inc("serve.ok")
                telemetry.inc("serve.idem_hits")
                telemetry.finish_trace(entry.tctx, "ok")
                fut.set_result(
                    protocol.ok_response(
                        request.get("id"), receipt, entry.trace
                    )
                )
                return fut
        # -- front-door result cache ---------------------------------------
        # Key = (placement key, canonical payload digest, pinned entity
        # epoch): the epoch component makes a registry mint observable by
        # the VERY NEXT request structurally — it computes a new key and
        # misses.  A hit costs zero device work AND zero queue/quota
        # pressure, so it deliberately bypasses the tenant token bucket:
        # quotas meter dispatches, not dict lookups.
        t_hit = time.monotonic()
        self._stamp_cache_key(entry)
        if entry.cache_key is not None:
            hit = self.cache.get(entry.cache_key)
            if hit is not None:
                entry.trace["events"].append(
                    {"kind": "cache_hit", "epoch": entry.cache_key[2]}
                )
                entry.trace["cache_hit"] = True
                if entry.entity is not None:
                    entry.trace["registry_epoch"] = int(
                        getattr(entry.entity, "epoch", 0)
                    )
                telemetry.inc("serve.ok")
                self._tenant_inc(entry.tenant_label, "cache_hits")
                telemetry.finish_trace(entry.tctx, "ok")
                ms = (time.monotonic() - t_hit) * 1e3
                telemetry.observe("serve.latency_ms", ms)
                record_latency(ms)
                telemetry.observe_slo(
                    entry.op, ms, tenant=entry.tenant_label
                )
                self._tenant_observe(entry.tenant_label, ms)
                fut.set_result(
                    protocol.ok_response(request.get("id"), hit, entry.trace)
                )
                return fut
        # -- per-tenant quota (code 117, BEFORE the global depth gate) ------
        try:
            self.quotas.admit(entry.tenant)
        except QuotaExceededError as e:
            telemetry.inc("serve.shed_quota")
            telemetry.inc("serve.errors")
            self._tenant_inc(entry.tenant_label, "shed_quota")
            entry.trace["events"].append(
                {
                    "kind": "quota_shed",
                    "tenant": entry.tenant,
                    "retry_after_ms": e.retry_after_ms,
                    **self._queue_state(),
                }
            )
            with telemetry.activate([entry.tctx]):
                telemetry.error_event(
                    "serve.quota", e, op=entry.op, tenant=entry.tenant
                )
            telemetry.finish_trace(entry.tctx, "shed_quota", code=e.code)
            fut.set_result(
                protocol.error_response(request.get("id"), e, entry.trace)
            )
            return fut
        try:
            self.queue.offer(entry, on_admit=self._on_admit)
        except SkylarkError as e:  # AdmissionError
            telemetry.inc("serve.shed_admission")
            telemetry.inc("serve.errors")
            self._tenant_inc(entry.tenant_label, "shed_admission")
            # The envelope carries the queue state that caused the shed:
            # depth/percentile context a backing-off caller (or a
            # post-mortem) needs, without a second round trip.
            entry.trace["events"].append(
                {
                    "kind": "admission_shed",
                    "queue_depth": getattr(e, "queue_depth", None),
                    "max_depth": getattr(e, "max_depth", None),
                    **self._queue_state(),
                }
            )
            with telemetry.activate([entry.tctx]):
                telemetry.error_event("serve.admission", e, op=entry.op)
            telemetry.finish_trace(
                entry.tctx, "shed_admission", code=e.code
            )
            # Door sheds spend ~0ms queued, but they still count:
            # excluding them is what flattered p99 under saturation.
            shed_ms = (time.monotonic() - t_hit) * 1e3
            record_latency(shed_ms, shed=True)
            telemetry.observe_slo(
                entry.op, shed_ms, tenant=entry.tenant_label, shed=True
            )
            fut.set_result(
                protocol.error_response(request.get("id"), e, entry.trace)
            )
        return fut

    def call(self, request: dict | None = None, /, **fields) -> dict:
        req = dict(request or {}, **fields)
        return self.submit(req).result()

    def stats(self) -> dict:
        counters = {
            k.split(".", 1)[1]: v
            for k, v in telemetry.REGISTRY.snapshot()["counters"].items()
            if k.startswith("serve.")
        }
        return {
            "queue_depth": len(self.queue),
            "params": asdict(self.params),
            "registry": self.registry.describe(),
            "counters": counters,
            "latency": latency_percentiles(),
            "warm_start": self.warm_summary,
            "primed": list(self.primed),
        }

    # -- fleet surface ------------------------------------------------------

    def census(self) -> dict:
        """The sorted names this replica serves — the human half of the
        membership check (the bit-exact half is :meth:`signature`)."""
        d = self.registry.describe()
        return {
            "models": sorted(d["models"]),
            "systems": sorted(d["systems"]),
            "graphs": sorted(d["graphs"]),
        }

    def signature(self) -> int:
        """CRC32 of the canonical registry description.  Two replicas
        may join one fleet only when their signatures agree — the same
        fencing discipline as the elastic layer's partition signature
        (``streaming/elastic.py``): a fleet that silently mixed
        registries would route requests to replicas that resolve the
        same name to different models."""
        import json
        import zlib

        blob = json.dumps(
            self.registry.describe(), sort_keys=True, default=str
        )
        return zlib.crc32(blob.encode())

    def load_report(self) -> dict:
        """Everything the front-door router needs to place a request,
        in one snapshot: live queue pressure, per-key measured
        throughput (this process), the policy profile store's prior
        (survives restarts), what's primed, and the membership identity
        (census + signature).  Served over HTTP as ``/fleet`` and folded
        into ``/healthz`` as ``"load"``."""
        with self._stats_lock:
            throughput = {
                k: {
                    "requests": c,
                    "busy_s": round(s, 6),
                    "rows_per_s": round(c / s, 3) if s > 0 else None,
                }
                for k, (c, s) in self._key_stats.items()
            }
        report = {
            "queue_depth": len(self.queue),
            "max_queue": self.params.max_queue,
            "epoch": self.registry.epoch,
            "workers": max(1, self.params.workers),
            "worker_alive": any(t.is_alive() for t in self._threads),
            "throughput": throughput,
            "latency": latency_percentiles(),
            "primed": list(self.primed),
            "census": self.census(),
            "signature": self.signature(),
            # The fleet-wide hit-sharing plane: which placement keys this
            # replica already holds warm results for (and how its cache
            # is doing) — the router's tie-break reads "keys", so a hot
            # seed set costs the fleet ONE dispatch.
            "cache": self.cache.stats(),
            "tenants": self.queue.depth_by_tenant(),
        }
        try:
            from ..policy import profile as _profile

            view = _profile.load_entries()
        except Exception:  # noqa: BLE001 — profiles are advisory
            view = None
        if view:
            profiles = {
                k: e["throughput"]
                for k, e in view.get("entries", {}).items()
                if e.get("throughput")
            }
            if profiles:
                report["profiles"] = profiles
        return report

    # -- internals ----------------------------------------------------------

    def _tenant_label(self, tenant: str) -> str:
        """Bounded metric label for a client-controlled tenant key:
        the raw name while the label budget lasts, ``"other"`` after —
        counter-name cardinality stays capped no matter what an
        untrusted client sends."""
        with self._stats_lock:
            if tenant in self._metric_tenants:
                return tenant
            if len(self._metric_tenants) < self._metric_tenant_cap:
                self._metric_tenants.add(tenant)
                return tenant
        return "other"

    def _tenant_inc(self, tenant: str, what: str, n: int = 1) -> None:
        # Per-tenant counter names are f-strings — gate on the telemetry
        # switch so a disabled run stays allocation-free (the pinned
        # disabled-telemetry contract).  ``tenant`` here is always the
        # entry's bounded ``tenant_label``, never the raw client key.
        if telemetry.enabled():
            telemetry.inc(f"serve.tenant.{tenant}.{what}", n)

    def _tenant_observe(self, tenant: str, ms: float) -> None:
        if telemetry.enabled():
            telemetry.observe(f"serve.tenant.{tenant}.latency_ms", ms)

    def _stamp_cache_key(self, entry: Entry) -> None:
        """Compute the result-cache identity of a validated entry, or
        leave it None (uncacheable).  Cacheable: every idempotent read
        op.  NOT cacheable: fresh-sketch solves (each draws a unique
        counter-addressed sketch — the request is *defined* to differ),
        updates (mutations), ping/stats (answered inline already)."""
        if not self.cache.enabled:
            return
        op = entry.op
        if op == "ls_solve":
            if entry.request.get("fresh_sketch"):
                return
            src = entry.payload  # b AFTER retired-row zeroing
        elif op == "cond_est":
            src = ()
        elif op == "ppr":
            src = entry.payload  # canonical (seeds, alpha, gamma, eps)
        elif op == "ase_embed":
            src = (entry.payload, entry.squeeze)
        elif op == "predict":
            src = (
                entry.payload,
                bool(entry.request.get("labels")),
                entry.squeeze,
            )
        else:
            return
        entry.cache_key = (
            protocol.placement_key(entry.request),
            payload_digest(src),
            int(getattr(entry.entity, "epoch", 0)),
        )
        entry.cache_entity = (
            entry.request.get("system")
            or entry.request.get("model")
            or entry.request.get("graph")
        )

    def _validate(self, request: dict, fut: Future) -> Entry | None:
        op = request.get("op")
        if op == "ping":
            fut.set_result(
                protocol.ok_response(request.get("id"), "pong", {"events": []})
            )
            telemetry.inc("serve.ok")
            return None
        if op == "stats":
            fut.set_result(
                protocol.ok_response(
                    request.get("id"), self.stats(), {"events": []}
                )
            )
            telemetry.inc("serve.ok")
            return None
        if op == "ls_solve":
            system = self.registry.get_system(request.get("system"))
            self._check_epoch(request, system, "system")
            b = np.asarray(request.get("b"), np.float64)
            if b.ndim != 1 or b.shape[0] != system.m:
                raise InvalidParameters(
                    f"ls_solve b must be 1-D of length {system.m}, "
                    f"got shape {b.shape} (coalesce multi-RHS as "
                    "multiple requests)"
                )
            if system.retired:
                # Retired rows are zero in the held S·A; zeroing their b
                # entries drops them from the solve exactly (the caller's
                # other rows are untouched).
                b = b.copy()
                b[sorted(system.retired)] = 0.0
            ep = getattr(system, "epoch", 0)
            if request.get("fresh_sketch"):
                self._fresh_seq += 1
                key = ("ls", request["system"], ep, "fresh", self._fresh_seq)
            else:
                key = ("ls", request["system"], ep)
            entry = Entry(request, fut, key, op, payload=b)
            entry.entity = system
            return entry
        if op == "cond_est":
            # validate the name at the door; the executor serves the
            # system's cached sketched-spectrum report to the batch
            system = self.registry.get_system(request.get("system"))
            self._check_epoch(request, system, "system")
            entry = Entry(
                request, fut,
                ("cond", request["system"], getattr(system, "epoch", 0)),
                op, payload=np.zeros(0),
            )
            entry.entity = system
            return entry
        if op == "predict":
            model = self.registry.get_model(request.get("model"))
            self._check_epoch(request, model, "model")
            dtype = np.dtype(request.get("dtype", "float64"))
            x = np.asarray(request.get("x"), dtype)
            squeeze = x.ndim == 1
            if squeeze:
                x = x[None, :]
            d = getattr(model, "input_dim", None)
            if x.ndim != 2 or (d and x.shape[1] != int(d)):
                raise InvalidParameters(
                    f"predict x must be (r, {d or '?'}) or ({d or '?'},), "
                    f"got shape {np.asarray(request.get('x')).shape}"
                )
            if request.get("labels"):
                request["_classes"] = getattr(model, "classes", None)
            entry = Entry(
                request, fut,
                ("predict", request["model"], str(dtype),
                 getattr(model, "epoch", 0)),
                op, payload=x,
            )
            entry.squeeze = squeeze
            entry.entity = model
            return entry
        if op == "ppr":
            gsys = self.registry.get_graph(request.get("graph"))
            self._check_epoch(request, gsys, "graph")
            seeds = request.get("seeds")
            if not isinstance(seeds, (list, tuple)) or not seeds:
                raise InvalidParameters(
                    "ppr seeds must be a non-empty list of vertex "
                    f"ids/names, got {seeds!r}"
                )
            ids = self._graph_ids(gsys, seeds, "ppr seeds")
            # Canonical payload: the memo key in GraphSystem.ppr_report.
            # Sorting/deduping HERE means riders with the same seed set
            # in any order coalesce onto one diffusion.
            payload = (
                tuple(sorted(set(ids))),
                float(request.get("alpha", 0.85)),
                float(request.get("gamma", 5.0)),
                float(request.get("epsilon", 0.001)),
            )
            entry = Entry(
                request, fut,
                ("ppr", request["graph"], getattr(gsys, "epoch", 0)),
                op, payload=payload,
            )
            entry.entity = gsys
            return entry
        if op == "ase_embed":
            gsys = self.registry.get_graph(request.get("graph"))
            self._check_epoch(request, gsys, "graph")
            has_ids = "ids" in request
            has_nb = "neighbors" in request
            if has_ids == has_nb:
                raise InvalidParameters(
                    "ase_embed takes exactly one of 'ids' (embedding row "
                    "lookup) or 'neighbors' (out-of-sample projection)"
                )
            if has_ids:
                items = request["ids"]
                squeeze = not isinstance(items, (list, tuple))
                if squeeze:
                    items = [items]
                idx = self._graph_ids(gsys, items, "ase_embed ids")
                payload = ("rows", np.asarray(idx, np.int64))
            else:
                items = request["neighbors"]
                squeeze = False
                if not isinstance(items, (list, tuple)) or not items:
                    raise InvalidParameters(
                        "ase_embed neighbors must be a non-empty list of "
                        f"vertex ids/names, got {items!r}"
                    )
                idx = self._graph_ids(gsys, items, "ase_embed neighbors")
                payload = ("oos", np.asarray(idx, np.int64))
            entry = Entry(
                request, fut,
                ("ase", request["graph"], getattr(gsys, "epoch", 0)),
                op, payload=payload,
            )
            entry.squeeze = squeeze
            entry.entity = gsys
            return entry
        if op == "update":
            return self._validate_update(request, fut)
        raise InvalidParameters(
            f"unknown op {op!r}; supported: {list(protocol.OPS)}"
        )

    def _validate_update(self, request: dict, fut: Future) -> Entry:
        """Door validation for live-registry mutations.  The mutation
        itself runs in the WORKER (the update executor) — updates ride
        the same admission queue as traffic, so a coalesced batch that
        admitted before the update keeps its pinned pre-update version
        and everything admitted after sees the new epoch: the queue
        order IS the epoch order.  Each update gets a UNIQUE coalesce
        key: mutations must apply exactly once, so they never batch and
        never enter the solo-retry path."""
        targets = [t for t in ("graph", "system", "model") if t in request]
        if targets != ["graph"] and targets != ["system"]:
            raise InvalidParameters(
                "update takes exactly one target: 'graph' (with 'edges') "
                "or 'system' (with 'append' or 'drop'); model updates are "
                "a server-side API (Registry.update_model), got "
                f"targets {targets!r}"
            )
        if targets == ["graph"]:
            name = request["graph"]
            self.registry.get_graph(name)  # validate at the door
            edges = request.get("edges")
            if not isinstance(edges, (list, tuple)) or not all(
                isinstance(p, (list, tuple)) and len(p) == 2 for p in edges
            ):
                raise InvalidParameters(
                    "graph update needs 'edges': a list of (u, v) pairs, "
                    f"got {type(edges).__name__}"
                )
            payload = {"kind": "graph_fold", "name": name,
                       "edges": [tuple(p) for p in edges]}
        else:
            name = request["system"]
            self.registry.get_system(name)
            has_append = "append" in request
            if has_append == ("drop" in request):
                raise InvalidParameters(
                    "system update takes exactly one of 'append' (row "
                    "block) or 'drop' (row index list)"
                )
            if has_append:
                payload = {
                    "kind": "row_append", "name": name,
                    "rows": np.asarray(request["append"], np.float64),
                }
            else:
                payload = {
                    "kind": "row_downdate", "name": name,
                    "drop": [int(i) for i in request["drop"]],
                }
        self._fresh_seq += 1
        entry = Entry(
            request, fut, ("update", name, self._fresh_seq), "update",
            payload=payload,
        )
        idem = request.get("idem_key")
        if idem is not None:
            if not isinstance(idem, str) or not idem or len(idem) > 256:
                raise InvalidParameters(
                    "idem_key must be a non-empty string of at most 256 "
                    f"characters, got {idem!r}"
                )
            entry.idem_key = idem
        return entry

    def _check_epoch(self, request: dict, entity, kind: str) -> None:
        """The code-116 fence: a request may pin ``registry_epoch`` to
        demand the exact version it knows; if the entity has moved on
        (or has not reached that epoch), refuse with the two epochs in
        the envelope rather than serve silently-different bits."""
        want = request.get("registry_epoch")
        if want is None:
            return
        current = int(getattr(entity, "epoch", 0))
        if int(want) != current:
            telemetry.inc("registry.epoch.misses")
            raise RegistryEpochError(
                f"{kind} {getattr(entity, 'name', '?')!r} is at registry "
                f"epoch {current}, request pinned epoch {int(want)} — the "
                "pinned version is retired (or not yet minted)",
                requested=int(want), current=current,
                entity=getattr(entity, "name", None),
            )

    @staticmethod
    def _graph_ids(gsys, items, what: str) -> list:
        """Resolve a seed/id list to vertex ids at the door: ints are
        range-checked, anything else goes through the graph's name
        index — so executors never see an unresolvable vertex."""
        n = gsys.G.n
        ids = []
        for v in items:
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
                i = int(v)
                if not (0 <= i < n):
                    raise InvalidParameters(
                        f"{what}: vertex id {i} outside [0, {n})"
                    )
            else:
                try:
                    i = gsys.G.index[v]
                except (KeyError, TypeError):
                    raise InvalidParameters(
                        f"{what}: unknown vertex {v!r} in graph "
                        f"{gsys.name!r}"
                    ) from None
            ids.append(i)
        return ids

    def _on_admit(self, entry: Entry) -> None:
        """Admission-ordered side effects, under the queue lock: the
        deadline stamp, and for fresh-sketch requests the counter
        reservation — the server context advances HERE, in admission
        order, so batching can never perturb the counter stream."""
        dm = entry.request.get(
            "deadline_ms", self.params.default_deadline_ms
        )
        if dm is not None:
            entry.deadline = entry.t_admit + float(dm) / 1e3
        if entry.op == "ls_solve" and entry.request.get("fresh_sketch"):
            system = self.registry.get_system(entry.request["system"])
            entry.counter_base = self.ctx.counter
            entry.sketch = type(system.S)(system.m, system.S.s, self.ctx)

    def _queue_state(self) -> dict:
        """Queue/latency context folded into shed envelopes (satellite of
        the observability plane): depth always; serve counters and the
        p50/p99 only when telemetry is on (they are empty otherwise)."""
        state: dict = {"depth": len(self.queue)}
        if telemetry.enabled():
            counters = telemetry.REGISTRY.snapshot()["counters"]
            for k in ("requests", "shed_admission", "shed_deadline"):
                v = counters.get(f"serve.{k}")
                if v:
                    state[k] = v
            state.update(latency_percentiles())
        return state

    def _resolve_error(
        self, entry: Entry, e: SkylarkError, status: str = "error"
    ) -> None:
        telemetry.inc("serve.errors")
        telemetry.finish_trace(
            entry.tctx, status, code=getattr(e, "code", 100)
        )
        entry.future.set_result(
            protocol.error_response(entry.request.get("id"), e, entry.trace)
        )

    def _worker(self, device=None) -> None:
        while True:
            batch = self.queue.take_batch(
                self.params.max_coalesce,
                self.params.coalesce_window_ms / 1e3,
            )
            if batch is None:
                return
            now = time.monotonic()
            phased = telemetry.phases_enabled()
            live = []
            for e in batch:
                waited_ms = (now - e.t_admit) * 1e3
                e.trace["queue_ms"] = round(waited_ms, 4)
                if e.deadline is not None and now > e.deadline:
                    telemetry.inc("serve.shed_deadline")
                    self._tenant_inc(e.tenant_label, "shed_deadline")
                    e.trace["events"].append(
                        {
                            "kind": "deadline_shed",
                            "waited_ms": round(waited_ms, 4),
                            **self._queue_state(),
                        }
                    )
                    exc = DeadlineExceededError(
                        "deadline expired before dispatch",
                        deadline_ms=e.request.get(
                            "deadline_ms",
                            self.params.default_deadline_ms,
                        ),
                        waited_ms=round(waited_ms, 4),
                    )
                    with telemetry.activate([e.tctx]):
                        telemetry.error_event(
                            "serve.deadline", exc, op=e.op
                        )
                    self._resolve_error(e, exc, status="shed_deadline")
                    # A deadline shed IS the saturation signal: its
                    # queue time joins the reservoir flagged shed=True.
                    record_latency(waited_ms, shed=True)
                    telemetry.observe_slo(
                        e.op, waited_ms, tenant=e.tenant_label, shed=True
                    )
                    continue
                telemetry.observe("serve.queue_ms", waited_ms)
                if phased and e.tctx is not None and e.t_pop is not None:
                    # Phase clock: the chained monotonic stamps make the
                    # phases sum to the request's end-to-end latency by
                    # construction (the batcher fills in the rest).
                    e.phases = {
                        "admit_wait": (e.t_pop - e.t_admit) * 1e3,
                        "coalesce_linger": (now - e.t_pop) * 1e3,
                        "_t_take": now,
                    }
                live.append(e)
            if not live:
                continue
            telemetry.inc("serve.batches")
            telemetry.observe("serve.batch_size", len(live))
            if len(live) > 1:
                telemetry.inc("serve.coalesced", len(live))
            t_exec = time.monotonic()
            try:
                batcher.run_batch(self.registry, live, device)
            except Exception as e:  # noqa: BLE001 — the worker must survive
                for entry in live:
                    if not entry.future.done():
                        self._resolve_error(
                            entry, SkylarkError(f"serve worker error: {e}")
                        )
            done = time.monotonic()
            self._fold_key_stats(live, done - t_exec)
            for e in live:
                ms = (done - e.t_admit) * 1e3
                telemetry.observe("serve.latency_ms", ms)
                record_latency(ms)
                telemetry.observe_slo(e.op, ms, tenant=e.tenant_label)
                self._tenant_observe(e.tenant_label, ms)
            # Roll the time-series ring forward (lazy tick: a no-op
            # until the window interval elapses, nothing when disabled).
            telemetry.timeline_tick(
                extra={"queue_depth": len(self.queue)}
            )

    def _fold_key_stats(self, live, busy_s: float) -> None:
        """Per-placement-key throughput accounting, fed by every batch
        regardless of the telemetry gate — the router's placement logic
        needs it even on telemetry-dark replicas.  One batch is one key
        (``take_batch`` coalesces same-key only)."""
        key = protocol.placement_key(live[0].request)
        with self._stats_lock:
            slot = self._key_stats.setdefault(key, [0, 0.0])
            slot[0] += len(live)
            slot[1] += busy_s
