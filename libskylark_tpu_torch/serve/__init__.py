"""High-throughput sketch-serving: cross-request coalescing onto captured
plans (port of ``libskylark_tpu/serve``).

A long-lived, multi-tenant in-process solve service whose hot path
coalesces concurrent requests that hash to the same (registered entity,
serialized sketch, input signature) key into ONE padded, planned
dispatch on the card, then de-pads and fans the results back out,
bit-identical per request to serving them one at a time.  State lives on
an explicit ``torch.device`` (``Server(params, seed=..., device=None)``
and ``Registry(..., device=None)`` default to ``cuda`` and raise without
a card); payloads become tensors at the batch and results come back to
the host once per batch.  The names, the wire format and the journal
format are the JAX package's.

Layout:

- :mod:`.protocol` — the JSON frames (byte-identical ``encode``);
- :mod:`.admission` — bounded queue with deficit-weighted round-robin
  tenant lanes, depth/deadline shedding (codes 112/113);
- :mod:`.cache` — the versioned, bounded front-door result cache (keyed
  on placement key + canonical payload digest + registry epoch);
- :mod:`.qos` — tenant keys, weighted-fair lane config, token-bucket
  quotas (code 117);
- :mod:`.registry` — models, LS systems and graphs, loaded once,
  device-resident, live (epoch-versioned edge folds, row
  appends/downdates, model swaps; code 116 for retired-epoch pins);
- :mod:`.journal` — the write-ahead journal every registry mint appends
  to (fsync'd) BEFORE it publishes, snapshot compaction into a
  ``CheckpointStore`` slot, ``Registry.recover`` and the idempotency
  window (code 118);
- :mod:`.batcher` — the coalescing executors (fixed blocks of the base
  rung, so coalesced ≡ serial bitwise) + solo-retry fault isolation
  (code 108);
- :mod:`.server` — the worker loop (``workers=K`` pins K batcher
  threads to the local cards), warm start, priming, telemetry;
- :mod:`.dispatch` — device-parallel dispatch: past the gates the heavy
  half of a batch runs split over several devices, each program held
  bitwise to the single device by a parity probe at its first dispatch;
- :mod:`.router` — the fleet front door: signature-fenced membership
  (code 109), key-affinity placement, 112/114 shedding, heartbeat
  ejection with in-flight re-placement;
- :mod:`.transport` / :mod:`.client` — stdio + HTTP/1.1 keep-alive
  fronts and the Python client (``skylark-torch-serve`` is the CLI);
- :mod:`.autoscale` — the membership control loop: spawns replicas
  against queue-depth/p99 targets (primed before placeable,
  join-fenced) and drains idle ones to zero in-flight before they leave.
"""

from .admission import AdmissionQueue, Entry
from .autoscale import AutoscaleParams, Autoscaler
from .cache import ResultCache, payload_crc, payload_digest
from .client import Client
from .qos import (
    DEFAULT_TENANT,
    LaneConfig,
    TenantQuotas,
    TokenBucket,
    tenant_of,
)
from .protocol import (
    decode,
    encode,
    error_payload,
    error_response,
    exception_for,
    make_request,
    ok_response,
    placement_key,
    raise_for_error,
)
from .journal import Journal
from .registry import GraphSystem, LSSystem, Registry
from .router import (
    HttpReplica,
    InProcessReplica,
    Router,
    RouterParams,
    choose_replica,
)
from .server import ServeParams, Server, latency_percentiles, record_latency
from .transport import serve_http, serve_stdio

__all__ = [
    "AdmissionQueue",
    "AutoscaleParams",
    "Autoscaler",
    "Client",
    "DEFAULT_TENANT",
    "Entry",
    "GraphSystem",
    "HttpReplica",
    "InProcessReplica",
    "Journal",
    "LSSystem",
    "LaneConfig",
    "Registry",
    "ResultCache",
    "Router",
    "RouterParams",
    "ServeParams",
    "Server",
    "TenantQuotas",
    "TokenBucket",
    "choose_replica",
    "decode",
    "encode",
    "error_payload",
    "error_response",
    "exception_for",
    "latency_percentiles",
    "make_request",
    "ok_response",
    "payload_crc",
    "payload_digest",
    "placement_key",
    "raise_for_error",
    "record_latency",
    "serve_http",
    "serve_stdio",
    "tenant_of",
]
