"""The process-wide LRU plan cache and its counters (port of
``libskylark_tpu/plans/cache.py``).

One cache for the whole process: plans are keyed on the *serialized*
sketch (``SketchTransform.to_json()``, ~100 bytes, fully determines the
counter streams) plus the input signature (dim, shape, dtype, device)
and the slice flags, so two sketch objects rebuilt from the same JSON
(a solver re-run, a model reload, every sweep of a sketch-and-solve
loop) share one plan.

Counters (``stats()``):

- ``hits`` / ``misses``: cache lookups by outcome (a miss builds a new
  plan);
- ``evictions``: plans dropped by the LRU bounds: at most
  ``SKYLARK_PLAN_CACHE_SIZE`` plans (default 128), holding at most
  :data:`MAX_BYTES` between them (``PLAN_CACHE.set_max_bytes``);
- ``traces``: plan bodies captured (a CUDA graph capture on the card,
  the one build of an eager body on the CPU) — the retrace guard: a
  healthy streaming pass traces once per bucket, never once per batch;
- ``compiles`` / ``compile_seconds``: first calls per plan and the wall
  clock they took (the eager warm-up on the card, through a
  synchronize);
- ``bypasses``: planned entry points that took the eager apply (plans
  off, sparse blocks, ...).

All counters are monotone non-decreasing for the life of the process
(``reset_stats()`` zeroes them; ``clear()`` also drops the plans and
releases their graphs' memory).

``stats()["bytes"]`` is what the cached plans hold on their device:
each plan lists its static buffers and its sketch's memos in ``held``
(key -> bytes), and a buffer that several plans share counts once.  A
plan whose own buffers exceed the byte bound is never built (its entry
point takes the eager path and counts a ``bypass``); otherwise the
least recently used plans go until the rest fit.  The graphs' shared
pool of intermediates is not counted: it is as large as the largest
captured body's, and an evicted plan's share goes back to the device
once no graph uses the pool.  With telemetry on, every lookup is a
``plan`` / ``cache`` ledger event (``hit``, the plan kind) and a trace
event, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import torch

from .. import telemetry

__all__ = ["stats", "reset", "reset_stats", "clear", "set_cache_size", "PlanCache"]


def _default_size() -> int:
    try:
        return max(1, int(os.environ.get("SKYLARK_PLAN_CACHE_SIZE", "128")))
    except ValueError:
        return 128


#: The bytes the cached plans may hold on their device: 1 GiB, so that a
#: large input (the 2 GiB A of a 2^20 x 512 least-squares problem) is
#: applied eagerly rather than copied once more into a static buffer.
MAX_BYTES = 1 << 30


class PlanCache:
    """OrderedDict-backed LRU of plans plus the counter block."""

    def __init__(self, max_size: int | None = None, max_bytes: int | None = None):
        self._lock = threading.RLock()
        self._plans: OrderedDict = OrderedDict()
        self.max_size = max_size if max_size is not None else _default_size()
        self.max_bytes = MAX_BYTES if max_bytes is None else max_bytes
        self._counters = self._zero()

    @staticmethod
    def _zero() -> dict:
        return {"hits": 0, "misses": 0, "evictions": 0, "traces": 0, "compiles": 0,
                "compile_seconds": 0.0, "bypasses": 0}

    def bump(self, counter: str, amount=1) -> None:
        with self._lock:
            self._counters[counter] += amount

    def get_or_build(self, key, builder):
        """The plan under ``key``, built by ``builder()`` (outside the
        lock) and LRU-inserted on a miss."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._counters["hits"] += 1
                self._plans.move_to_end(key)
            else:
                self._counters["misses"] += 1
        if telemetry.enabled():
            telemetry.event("plan", "cache", {"hit": plan is not None, "plan": key[0]})
            # a serve dispatch in flight sees its plan-cache fate too
            telemetry.trace_event("plan", hit=plan is not None, plan=key[0])
        if plan is not None:
            return plan
        plan = builder()
        with self._lock:
            existing = self._plans.get(key)
            if existing is not None:  # a racing builder won
                return existing
            self._plans[key] = plan
            self._evict()
        return plan

    def fits(self, nbytes: int) -> bool:
        """Whether a plan holding ``nbytes`` may be built at all."""
        return nbytes <= self.max_bytes

    def held_bytes(self) -> int:
        """The bytes the cached plans hold, each shared buffer once."""
        with self._lock:
            held = {}
            for plan in self._plans.values():
                held.update(getattr(plan, "held", {}))
            return sum(held.values())

    def _evict(self) -> None:
        # The most recent plan stays, whatever it holds: it is in use.
        while len(self._plans) > self.max_size or (
                len(self._plans) > 1 and self.held_bytes() > self.max_bytes):
            self._plans.popitem(last=False)
            self._counters["evictions"] += 1

    def settle(self) -> None:
        """Re-apply the bounds once a plan's ``held`` grew (its first call
        made its static outputs and filled its sketch's memos)."""
        with self._lock:
            self._evict()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["compile_seconds"] = round(out["compile_seconds"], 6)
            out["size"] = len(self._plans)
            out["max_size"] = self.max_size
            out["bytes"] = self.held_bytes()
            out["max_bytes"] = self.max_bytes
            return out

    def reset_stats(self) -> None:
        with self._lock:
            self._counters = self._zero()

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._counters = self._zero()

    def set_max_size(self, n: int) -> None:
        with self._lock:
            self.max_size = max(1, int(n))
            self._evict()

    def set_max_bytes(self, n: int) -> None:
        with self._lock:
            self.max_bytes = max(0, int(n))
            self._evict()


PLAN_CACHE = PlanCache()


def stats() -> dict:
    """Snapshot of the plan-cache counters (see the module docstring)."""
    return PLAN_CACHE.stats()


def reset() -> None:
    """Zero the counters; the plans stay cached."""
    PLAN_CACHE.reset_stats()


reset_stats = reset


def clear() -> None:
    """Drop every cached plan and zero the counters.  On the card the
    dropped plans' graph memory pools go back to the device: a private
    pool's free blocks serve no other allocation until
    ``torch.cuda.empty_cache`` releases them."""
    PLAN_CACHE.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def set_cache_size(n: int) -> None:
    """Adjust the LRU bound (evicting the oldest plans when shrinking)."""
    PLAN_CACHE.set_max_size(n)
