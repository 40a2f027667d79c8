"""Multi-tenant QoS primitives for the serve front door (port of
``libskylark_tpu/serve/qos.py``; host-only).

Two mechanisms, both tenant-keyed:

* **Weighted-fair lanes** (:class:`LaneConfig`) — the admission queue
  becomes deficit-weighted round-robin over per-tenant sub-queues, so a
  noisy tenant flooding the door gets *its own lane* drained at its
  weight's share instead of starving the global FIFO.  The scheduling
  itself lives in :class:`~libskylark_tpu_torch.serve.admission.AdmissionQueue`;
  this module only parses the weights.

* **Token-bucket quotas** (:class:`TenantQuotas`) — per-tenant admission
  rate limits shedding a structured code-117
  :class:`~libskylark_tpu_torch.utils.exceptions.QuotaExceededError` at the
  door, with a ``retry_after_ms`` backoff hint.  Global depth/deadline
  sheds keep codes 112/113; 117 is the *per-tenant* refusal.

Requests name their tenant via a ``tenant`` payload field (the HTTP
transport also maps an ``X-Skylark-Tenant`` header onto it).  Requests
that carry none ride the default lane — and when only the default lane
exists the queue short-circuits to the exact legacy FIFO, so
single-tenant deployments are preserved bitwise.

Knobs: ``SKYLARK_QOS_QUANTUM`` (batches of credit per round, default 1),
``SKYLARK_QOS_WEIGHTS`` (``"tenantA:4,tenantB:1"``),
``SKYLARK_QOS_QUOTA_RPS`` (default 0 = unlimited),
``SKYLARK_QOS_QUOTA_BURST`` (bucket capacity, default 2x rate),
``SKYLARK_QOS_QUOTAS`` (per-tenant ``"tenantA:100:200,tenantB:5"``
rate[:burst] overrides).
"""

from __future__ import annotations

import os
import threading
import time

from ..utils.exceptions import QuotaExceededError

__all__ = [
    "DEFAULT_TENANT",
    "tenant_of",
    "LaneConfig",
    "TokenBucket",
    "TenantQuotas",
]

DEFAULT_TENANT = "default"


def tenant_of(request):
    """Extract the tenant key from a request payload (dict or None)."""
    if isinstance(request, dict):
        t = request.get("tenant")
        if t is not None:
            return str(t)
    return DEFAULT_TENANT


def _parse_weights(spec):
    weights = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weights[name.strip()] = max(1e-6, float(w))
        except ValueError:
            continue
    return weights


class LaneConfig:
    """Deficit-round-robin parameters for the per-tenant lanes."""

    def __init__(self, quantum=None, weights=None):
        if quantum is None:
            quantum = float(os.environ.get("SKYLARK_QOS_QUANTUM", "1"))
        if weights is None:
            weights = _parse_weights(os.environ.get("SKYLARK_QOS_WEIGHTS"))
        elif isinstance(weights, str):
            weights = _parse_weights(weights)
        self.quantum = max(1e-6, float(quantum))
        self.weights = dict(weights or {})

    def weight(self, tenant):
        return float(self.weights.get(tenant, 1.0))


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    ``clock`` is injectable so quota tests are deterministic without
    sleeping.  Not thread-safe on its own — :class:`TenantQuotas` holds
    the lock.
    """

    def __init__(self, rate, burst, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.clock = clock
        self.tokens = self.burst
        self._t_last = clock()

    def _refill(self):
        now = self.clock()
        dt = max(0.0, now - self._t_last)
        self._t_last = now
        self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def take(self):
        """Consume one token; return None on success or the ms until a
        token accrues on refusal."""
        self._refill()
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        if self.rate <= 0:
            return None  # rate 0 with a take() call means unlimited lane
        deficit = 1.0 - self.tokens
        return int(deficit / self.rate * 1000.0) + 1


class TenantQuotas:
    """Per-tenant token-bucket admission quotas.

    ``default_rps`` of 0 (the knob default) means tenants without an
    explicit quota are unlimited — quotas are opt-in, so deployments
    that never configure them see zero behaviour change.
    """

    def __init__(self, default_rps=None, default_burst=None, quotas=None,
                 clock=time.monotonic):
        if default_rps is None:
            default_rps = float(os.environ.get("SKYLARK_QOS_QUOTA_RPS", "0"))
        if default_burst is None:
            burst_env = os.environ.get("SKYLARK_QOS_QUOTA_BURST")
            default_burst = float(burst_env) if burst_env else None
        if quotas is None:
            quotas = self._parse_quotas(
                os.environ.get("SKYLARK_QOS_QUOTAS"))
        elif isinstance(quotas, str):
            quotas = self._parse_quotas(quotas)
        self.default_rps = float(default_rps)
        self.default_burst = default_burst
        self.quotas = dict(quotas or {})  # tenant -> (rate, burst|None)
        self.clock = clock
        self._buckets = {}
        self._lock = threading.Lock()

    @staticmethod
    def _parse_quotas(spec):
        quotas = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 2:
                continue
            try:
                rate = float(bits[1])
                burst = float(bits[2]) if len(bits) > 2 else None
            except ValueError:
                continue
            quotas[bits[0].strip()] = (rate, burst)
        return quotas

    def _limits_for(self, tenant):
        if tenant in self.quotas:
            rate, burst = self.quotas[tenant]
        else:
            rate, burst = self.default_rps, self.default_burst
        if rate <= 0:
            return None
        if burst is None:
            burst = max(1.0, 2.0 * rate)
        return rate, burst

    def admit(self, tenant):
        """Charge one request to ``tenant``'s bucket; raise
        :class:`QuotaExceededError` (code 117) when exhausted."""
        limits = self._limits_for(tenant)
        if limits is None:
            return
        rate, burst = limits
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None or bucket.rate != rate or bucket.burst != burst:
                bucket = TokenBucket(rate, burst, clock=self.clock)
                self._buckets[tenant] = bucket
            retry_ms = bucket.take()
        if retry_ms is not None:
            raise QuotaExceededError(
                "tenant %r quota exceeded (%.3g req/s, burst %.3g)"
                % (tenant, rate, burst),
                tenant=tenant, rate=rate, burst=burst,
                retry_after_ms=retry_ms)

    def stats(self):
        with self._lock:
            return {
                t: {"tokens": b.tokens, "rate": b.rate, "burst": b.burst}
                for t, b in self._buckets.items()
            }
