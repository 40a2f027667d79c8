"""Observation recording: solve outcomes → the profile store (port of
``libskylark_tpu/policy/record.py``).

Routed entry points call :func:`consult` before the solve, then
:func:`observe` (which queues the run's observation in memory); the
run's terminal ``telemetry.run_summary`` calls :func:`flush` (which
folds everything pending into this process's profile file) before its
telemetry gate, so every observation is on disk by the end of the call
that made it, with telemetry on or off.  With the layer off or no store
directory, ``observe``, ``note_plan`` and ``flush`` return at once.  The
plans layer calls :func:`note_plan` on every planned apply, and
``flush`` writes the plan-compile totals into the store's meta.  With
telemetry on, decisions, routes, precision rungs, escalations and
profile writes count under ``policy.*``.
"""

from __future__ import annotations

import threading
import time

import torch

from .. import telemetry
from . import config
from .decide import Decision, ProblemSignature, choose_route
from .profile import ProfileStore

__all__ = ["consult", "observe", "note_plan", "flush", "recording_active", "reset"]

_LOCK = threading.RLock()
_STATE = {"store": None, "pending": 0}


def recording_active() -> bool:
    """True when observations will actually be persisted."""
    return config.enabled() and config.policy_dir() is not None


def _store() -> ProfileStore:
    with _LOCK:
        st = _STATE["store"]
        directory = config.policy_dir()
        if st is None or st.directory != directory:
            st = ProfileStore(directory)
            _STATE["store"] = st
        return st


def reset() -> None:
    """Drop pending state (test hook; nothing on disk is touched)."""
    with _LOCK:
        _STATE["store"] = None
        _STATE["pending"] = 0


def _dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype (``"float32"``,
    ``"bfloat16"``), as the JAX package's keys spell it."""
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else str(dtype)


def _backend_name(device) -> str:
    """``"gpu"`` for a CUDA device (what ``jax.default_backend()`` names
    an NVIDIA card), ``"cpu"`` otherwise."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def consult(kind: str, *, m: int, n: int, targets: int = 1, dtype, sparse: bool = False,
            device="cpu", route: str | None = None, sketch_type: str | None = None,
            sketch_size: int | None = None, guard_on: bool = True) -> Decision:
    """Build the problem's signature on ``device`` and run
    :func:`~libskylark_tpu_torch.policy.choose_route`: the one call every
    routed entry point makes.  ``guard_on=False`` keeps the default
    decision (the store's deviations lean on the guard)."""
    sig = ProblemSignature(kind=kind, m=int(m), n=int(n), targets=int(targets),
                           dtype=_dtype_name(dtype), sparse=bool(sparse),
                           backend=_backend_name(device))
    d = choose_route(sig, route=route, sketch_type=sketch_type, sketch_size=sketch_size,
                     guard_on=guard_on)
    if telemetry.enabled():  # (disabled, not even the trace's attrs are built)
        telemetry.inc("policy.decisions")
        # route + provenance onto any serve trace this solve is answering
        telemetry.trace_event("policy", route=d.route, sketch_type=d.sketch_type,
                              sketch_size=int(d.sketch_size), source=d.source,
                              escalated=d.escalated, reasons=list(d.reasons))
        if d.route not in ("sketch", "cholesky"):
            telemetry.inc(f"policy.route.{d.route}")
        if d.compute_dtype == "float8_e4m3fn":
            telemetry.inc("policy.fp8_first")
        elif d.compute_dtype:
            telemetry.inc("policy.bf16_first")
    return d


def _recovery_obs(info: dict | None) -> dict:
    """Fold ``info["recovery"]`` into observation fields."""
    obs: dict = {}
    rec = (info or {}).get("recovery") or {}
    attempts = rec.get("attempts") or []
    if not rec.get("guarded", False):
        return obs
    if attempts:
        first = attempts[0]
        obs["ok0"] = first.get("verdict") == "OK"
        obs["resketches"] = sum(1 for a in attempts if a.get("verdict") == "RESKETCH")
        obs["fallback"] = any(
            a.get("action") == "fallback" or a.get("verdict") == "FALLBACK" for a in attempts
        )
        for a in attempts:
            if a.get("verdict") == "OK":
                if a.get("cond") is not None:
                    obs["cond"] = float(a["cond"])
                if a.get("sketch_size") is not None:
                    obs["sketch_size"] = int(a["sketch_size"])
                break
    return obs


def observe(
    decision: Decision,
    info: dict | None,
    *,
    default_size: int | None = None,
    bf16: str | None = None,
    fp8: str | None = None,
    refine: dict | None = None,
    rows_per_s: float | None = None,
    batches: int | None = None,
) -> None:
    """Queue one run's observation (persisted by the next :func:`flush`)."""
    if not recording_active() or not decision.key:
        return
    obs = _recovery_obs(info)
    obs["route"] = decision.route
    obs["sketch_type"] = decision.sketch_type
    if refine is not None:
        obs["refine"] = dict(refine)
    if default_size is not None:
        obs["default_size"] = int(default_size)
    if decision.escalated:
        obs["escalated"] = True
    if bf16 is not None:
        obs["bf16"] = bf16
    elif decision.compute_dtype == "bfloat16":
        obs["bf16"] = "ok" if obs.get("ok0", True) else "fail"
    if fp8 is not None:
        obs["fp8"] = fp8
    elif decision.compute_dtype == "float8_e4m3fn":
        obs["fp8"] = "ok" if obs.get("ok0", True) else "fail"
    if rows_per_s is not None:
        obs["rows_per_s"] = float(rows_per_s)
        obs["batches"] = int(batches or 0)
    with _LOCK:
        _store().fold(decision.key, obs, now=time.time())
        _STATE["pending"] += 1
    if decision.escalated:
        telemetry.inc("policy.escalations")


def note_plan(plan: str, S, *, dim: str | None = None, shape=None, dtype: str | None = None,
              acc_dtype: str | None = None) -> None:
    """Count one plan-cache key toward the store's hot-plan list (called
    by the plans layer on every planned apply).  The record keeps what a
    warm start needs to replay it: the plan kind, the sketch JSON and
    the input signature (numpy dtype names)."""
    if not recording_active():
        return
    try:
        rec = {"plan": plan, "sketch": S.to_json(), "dim": dim,
               "shape": [int(v) for v in shape] if shape is not None else None,
               "dtype": dtype, "acc_dtype": acc_dtype}
    except (TypeError, ValueError):  # a sketch that does not serialize: skip
        return
    with _LOCK:
        _store().note_plan(rec)
        _STATE["pending"] += 1


def flush(name: str | None = None, info: dict | None = None) -> str | None:
    """Persist pending observations and the plan-compile totals (the
    store's meta; ``xla_cache_dir`` is None, the port has no XLA cache);
    returns the profile file's path, or None when nothing was written.
    Called by ``telemetry.run_summary``, which passes on the run's
    ``name`` and ``info``."""
    if not recording_active():
        return None
    with _LOCK:
        if _STATE["pending"] == 0:
            return None
        from .. import plans

        st = plans.stats()
        store = _store()
        store.set_meta(xla_cache_dir=None, plan_compiles=st["compiles"],
                       plan_compile_seconds=st["compile_seconds"])
        path = store.save(now=time.time())
        if path is not None:
            _STATE["pending"] = 0
        telemetry.inc("policy.profile_writes")
        return path
