"""Warm start: replay the store's hot plan keys before first traffic (port
of ``libskylark_tpu/policy/warmstart.py``).

A fresh process pays a warm-up and a CUDA graph capture for every plan
its predecessor already used (``plans.stats()["compile_seconds"]``,
recorded in the store's meta).  :func:`warm_start` rebuilds the store's
hottest (sketch, signature) records (``sketch.from_json`` and zeros of
the recorded shape) and pushes them through the live plan entry
points, so the process-wide plan cache holds their graphs before the
first real call.  The JAX package also re-applies its persisted XLA
compilation cache here; the port has none, so ``xla_cache_dir`` is
always None.

A record that no longer fits (an unknown sketch type, a dtype or shape
that does not match its sketch) or that the plans would run eagerly
(a slice step they do not capture, an input over the cache's byte
bound) is skipped and counted; a record that fits replays, and a
failure there raises like any other plan call.
"""

from __future__ import annotations

import time

import torch

from .. import telemetry
from .._device import resolve_device
from . import config
from .profile import load_entries

__all__ = ["warm_start"]

_KINDS = ("apply", "slice", "rowwise")


def _replay_args(rec: dict):
    """``(S, kind, shape, dtype, acc_dtype, dim)`` of a record, or raise
    ValueError/KeyError/TypeError when it is stale."""
    from ..sketch.base import Dimension, from_json

    kind = rec.get("plan")
    if kind not in _KINDS:
        raise ValueError(f"unknown plan kind {kind!r}")
    S = from_json(rec["sketch"])
    shape = tuple(int(v) for v in rec.get("shape") or ())
    dtype = getattr(torch, rec.get("dtype") or "float32")
    acc_dtype = getattr(torch, rec.get("acc_dtype") or "float32")
    if not (isinstance(dtype, torch.dtype) and isinstance(acc_dtype, torch.dtype)):
        raise TypeError(f"not a dtype: {rec.get('dtype')!r} / {rec.get('acc_dtype')!r}")
    dim = Dimension.of(rec.get("dim") or "columnwise")
    if not shape:
        raise ValueError("record has no shape")
    if kind == "apply":
        axis = 0 if dim is Dimension.COLUMNWISE else len(shape) - 1
        if shape[axis] != S.n:
            raise ValueError(f"shape {shape} does not fit N = {S.n}")
    elif len(shape) != 2 or (kind == "rowwise" and shape[1] != S.n):
        raise ValueError(f"shape {shape} does not fit a {kind} plan of N = {S.n}")
    from ..plans import PLAN_CACHE
    from ..plans.plan import _nbytes, plans_slices

    if kind == "slice" and not plans_slices(S):
        raise ValueError(f"the plans run {S.sketch_type}'s steps eagerly")
    if not PLAN_CACHE.fits(_nbytes(shape, dtype)):
        raise ValueError(f"shape {shape} is over the plan cache's byte bound")
    return S, kind, shape, dtype, acc_dtype, dim


def _replay_one(args: tuple, device: torch.device) -> None:
    from .. import plans

    S, kind, shape, dtype, acc_dtype, dim = args
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    if kind == "apply":
        plans.apply(S, zeros, dim)
    elif kind == "slice":
        acc = torch.zeros((S.s, shape[1]), dtype=acc_dtype, device=device)
        plans.accumulate_slice(S, acc, zeros, 0)
    else:
        plans.apply_rowwise_bucketed(S, zeros)


def warm_start(directory: str | None = None, *, max_plans: int | None = None,
               device=None) -> dict:
    """Prime the process from the profile store; returns ``{"enabled",
    "profile_keys", "plans_replayed", "plans_skipped", "xla_cache_dir",
    "seconds"}``.  The hottest ``SKYLARK_POLICY_WARM_PLANS`` records (or
    ``max_plans``) replay on ``device`` (default: the port's default
    device, the card).  Safe to call unconditionally at process start:
    with the layer off or no store it returns at once."""
    summary = {"enabled": False, "profile_keys": 0, "plans_replayed": 0, "plans_skipped": 0,
               "xla_cache_dir": None, "seconds": 0.0}
    if not config.enabled():
        return summary
    directory = directory or config.policy_dir()
    if not directory:
        return summary
    view = load_entries(directory)
    if view is None or not view.get("files"):
        return summary
    dev = resolve_device(device)
    t0 = time.perf_counter()
    summary["enabled"] = True
    summary["profile_keys"] = len(view.get("entries", {}))
    budget = config.warm_plans() if max_plans is None else max(0, max_plans)
    for rec in (view.get("plans") or [])[:budget]:
        try:
            args = _replay_args(rec)
        except (ValueError, KeyError, TypeError, AttributeError):
            summary["plans_skipped"] += 1
            continue
        _replay_one(args, dev)
        summary["plans_replayed"] += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    summary["seconds"] = round(time.perf_counter() - t0, 6)
    if telemetry.enabled():
        telemetry.inc("policy.warm_plans", summary["plans_replayed"])
        telemetry.event("policy", "warm_start", dict(summary))
    return summary
