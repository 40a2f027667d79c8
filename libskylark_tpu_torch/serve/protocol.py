"""JSON wire protocol for the serve layer (port of
``libskylark_tpu/serve/protocol.py``: the same frames, byte for byte).

One request = one JSON object; one response = one JSON object.  The
interchange unit for anything sketch-shaped is the serialized-sketch
JSON — the same ~100-byte counter-addressed record the ``native/``
C-API parity surface exchanges (``NativeSketch.to_json``), so a C shim
or a foreign-language client speaks this protocol without new
marshalling.

Request schema::

    {"id": str|int,            # caller-chosen correlation id (optional)
     "op": "ls_solve" | "cond_est" | "predict" | "ppr" | "ase_embed"
           | "update" | "ping" | "stats",
     # ls_solve:
     "system": str,            # registered system name
     "b": [float, ...],        # RHS, length m
     "fresh_sketch": bool,     # per-request sketch from the server's
                               # counter stream (slow path; bitwise-
                               # addressable via trace.counter_base)
     # cond_est: {"system": str} — result is the system's cached
     # sketched-spectrum report {cond, sigma_max, sigma_min,
     # effective_rank, n, sketch_size}; coalesced riders share one probe
     # predict:
     "model": str,             # registered model name
     "x": [..] | [[..], ..],   # one row (d,) or a block (r, d)
     "labels": bool,           # decode through the model's classes
     # ppr: {"graph": str, "seeds": [id|name, ...],
     #       "alpha"/"gamma"/"epsilon": float (optional)} — result is
     # the memoized seed-set community report {graph, seeds, cluster,
     # conductance, alpha, gamma, epsilon}; same-seed riders share one
     # active-support diffusion
     # ase_embed: {"graph": str} plus EXACTLY ONE of
     #   "ids": id|name|[...]       — embedding row lookup
     #   "neighbors": [id|name,...] — out-of-sample projection from a
     #                                new vertex's neighbor list
     # update: live-registry mutation — EXACTLY ONE target of
     #   {"graph": str, "edges": [[u, v], ...]}       — edge fold
     #   {"system": str, "append": [[...], ...]}      — row append
     #   {"system": str, "drop": [int, ...]}          — row downdate
     # result is the minted epoch-ledger record {name, kind, epoch,
     # ...delta counts}; updates never coalesce and apply exactly once,
     # in admission order
     "idem_key": str,          # optional update idempotency key (≤256
                               # chars): the server's journal-backed
                               # dedup window keyed (tenant, idem_key)
                               # makes retried/failover-replayed updates
                               # apply EXACTLY once — a replayed key
                               # returns the originally minted epoch
                               # receipt instead of re-executing
     # either:
     "registry_epoch": int,    # pin to an exact registry version: served
                               # bitwise at that epoch, or refused with a
                               # code-116 RegistryEpochError envelope
                               # carrying {requested, current, entity}
     "deadline_ms": float}     # shed if not dispatched in time

Response schema::

    {"id": ...,
     "ok": true,  "result": ...,            # arrays as nested lists
     "trace": {"queue_ms", "exec_ms", "batch_size", "bucket",
               "coalesced", "events": [...], ...}}
    {"id": ...,
     "ok": false, "error": {"code": int,    # the 100-118 ladder
                            "type": str, "message": str},
     "trace": {...}}

Error codes ride ``utils.exceptions``: admission shed = 112
(``AdmissionError``), deadline shed = 113 (``DeadlineExceededError``),
retired registry version = 116 (``RegistryEpochError``), per-tenant
quota shed = 117 (``QuotaExceededError``, carrying
``{tenant, rate, burst, retry_after_ms}``), serve-probe numerical
failures = 108 (``NumericalHealthError``), write-ahead-journal damage
= 118 (``JournalError``, carrying ``{path, record, reason}``); foreign
exceptions degrade to the base code 100.

Requests may also carry ``"tenant": str`` — the QoS lane key (the HTTP
transport maps an ``X-Skylark-Tenant`` header onto it).  Absent tenant
means the default lane, preserved bitwise.
"""

from __future__ import annotations

import json

import numpy as np

from ..utils import exceptions as exc

__all__ = [
    "OPS",
    "decode",
    "encode",
    "error_payload",
    "error_response",
    "exception_for",
    "make_request",
    "ok_response",
    "placement_key",
    "raise_for_error",
]

OPS = ("ls_solve", "cond_est", "predict", "ppr", "ase_embed",
       "update", "ping", "stats")


def placement_key(request: dict) -> str:
    """The routing identity of a request — the string granularity at
    which the fleet router tracks affinity and replicas report
    throughput.  Mirrors the batcher's coalescing key (``Entry.key``
    minus the fresh-sketch suffix): requests sharing a placement key
    can share a fused dispatch, so the router sends them to the same
    replica to keep batches full."""
    op = request.get("op")
    if op == "ls_solve":
        return f"ls:{request.get('system')}"
    if op == "cond_est":
        return f"cond:{request.get('system')}"
    if op == "predict":
        return (
            f"predict:{request.get('model')}"
            f":{np.dtype(request.get('dtype', 'float64')).name}"
        )
    if op == "ppr":
        return f"ppr:{request.get('graph')}"
    if op == "ase_embed":
        return f"ase:{request.get('graph')}"
    if op == "update":
        name = (request.get("graph") or request.get("system")
                or request.get("model"))
        return f"update:{name}"
    return str(op)

# code -> exception class, for client-side re-raising (raise_for_error)
_CODE_CLASSES = {
    cls.code: cls
    for cls in vars(exc).values()
    if isinstance(cls, type) and issubclass(cls, exc.SkylarkError)
}


def make_request(op: str, *, id=None, **fields) -> dict:
    req = {"op": op, **fields}
    if id is not None:
        req["id"] = id
    return req


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if hasattr(obj, "tolist"):  # tensors, np scalars
        return obj.tolist()
    return str(obj)


def encode(obj: dict) -> str:
    """One JSON line (arrays as nested lists, no trailing newline)."""
    return json.dumps(obj, default=_jsonable)


def decode(line: str) -> dict:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise exc.InvalidParameters(
            f"protocol frame must be a JSON object, got {type(obj).__name__}"
        )
    return obj


def error_payload(e: BaseException) -> dict:
    """The structured error envelope: stable code + type + message."""
    payload = {
        "code": int(getattr(e, "code", exc.SkylarkError.code)),
        "type": type(e).__name__,
        "message": str(e),
    }
    for attr in (
        "queue_depth", "max_depth", "deadline_ms", "waited_ms", "stage",
        "requested", "current", "entity", "tenant", "rate", "burst",
        "retry_after_ms", "path", "record", "reason",
    ):
        v = getattr(e, attr, None)
        if v is not None:
            payload[attr] = v
    report = getattr(e, "report", None)
    if report is not None:
        to_dict = getattr(report, "to_dict", None)
        payload["recovery"] = to_dict() if callable(to_dict) else report
    return payload


def ok_response(req_id, result, trace: dict) -> dict:
    return {"id": req_id, "ok": True, "result": result, "trace": trace}


def error_response(req_id, e: BaseException, trace: dict) -> dict:
    return {
        "id": req_id,
        "ok": False,
        "error": error_payload(e),
        "trace": trace,
    }


def exception_for(payload: dict) -> exc.SkylarkError:
    """Rebuild the closest exception class from an error envelope."""
    cls = _CODE_CLASSES.get(int(payload.get("code", 100)), exc.SkylarkError)
    try:
        return cls(payload.get("message", "serve error"))
    except TypeError:  # classes with mandatory extra args
        return exc.SkylarkError(payload.get("message", "serve error"))


def raise_for_error(response: dict) -> dict:
    """Pass an ok response through; raise the mapped exception otherwise."""
    if response.get("ok"):
        return response
    raise exception_for(response.get("error") or {})
