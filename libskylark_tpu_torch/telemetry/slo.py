"""Declarative latency SLOs with rolling error budgets (port of
``libskylark_tpu/telemetry/slo.py``).

An *objective* says "requests of op X (optionally for tenant Y) finish
under T ms at least P% of the time".  Operators declare them in
``SKYLARK_SLO`` as a comma-separated list::

    SKYLARK_SLO="ls_solve:50:99.9,predict@acme:20:99"

i.e. ``key:threshold_ms:target_pct`` where ``key`` is an op name or
``op@tenant`` for a tenant-scoped objective.

The tracker keeps a bounded rolling window of good/bad verdicts per
objective (``SKYLARK_SLO_WINDOW`` samples, default 1024; a shed request
is always bad) and derives the remaining error budget::

    allowed = window_size * (1 - target_pct / 100)
    budget_remaining = 1 - bad / allowed        # 1.0 = untouched, <0 = blown

Each observation refreshes a ``slo.budget_remaining.<key>`` gauge
(exported as ``skylark_slo_budget_remaining{objective="<key>"}`` on
``/metrics``).  When the budget drops below ``SKYLARK_SLO_BURN``
(default 0.25) the tracker mints ONE edge-triggered ``slo_burn``
trace-violation record into the flight recorder's violations ring plus
a ledgered ``slo``/``burn`` event, re-arming only after the budget
recovers above the threshold.  Burn evaluation waits for a small floor
of samples (8) so one unlucky first request cannot page anyone.

Everything rides ``SKYLARK_TELEMETRY``: disabled, :func:`observe_slo`
returns before parsing or allocating anything.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import config, ledger
from .registry import inc, set_gauge
from .trace import RECORDER, next_id

__all__ = [
    "Objective",
    "parse_slos",
    "SloTracker",
    "TRACKER",
    "observe_slo",
    "slo_report",
    "reset_slo",
]

_DEF_WINDOW = 1024
_DEF_BURN = 0.25
_MIN_SAMPLES = 8


class Objective:
    """One parsed SLO: ``key`` (op or ``op@tenant``), threshold, target."""

    __slots__ = ("key", "threshold_ms", "target_pct")

    def __init__(self, key: str, threshold_ms: float, target_pct: float):
        self.key = key
        self.threshold_ms = float(threshold_ms)
        self.target_pct = float(target_pct)

    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "threshold_ms": self.threshold_ms,
            "target_pct": self.target_pct,
        }


def parse_slos(spec: str | None) -> dict:
    """Parse a ``SKYLARK_SLO`` spec into ``{key: Objective}``.

    Malformed entries are skipped (and counted under ``slo.parse_errors``
    when telemetry is on) rather than raised — a typo in an env var must
    not take down a serving process.
    """
    objectives: dict = {}
    if not spec:
        return objectives
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        try:
            if len(fields) != 3:
                raise ValueError(part)
            key = fields[0].strip()
            thr = float(fields[1])
            pct = float(fields[2])
            if not key or thr <= 0 or not (0.0 < pct <= 100.0):
                raise ValueError(part)
        except (ValueError, TypeError):
            inc("slo.parse_errors")
            continue
        objectives[key] = Objective(key, thr, pct)
    return objectives


class SloTracker:
    """Rolling error-budget tracker over the declared objectives.

    The objective table is re-parsed lazily whenever the ``SKYLARK_SLO``
    string changes (read per call, like every other telemetry knob), so
    tests and operators can flip objectives at runtime.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._spec: str | None = None
        self._objectives: dict = {}
        self._windows: dict = {}      # key -> deque of bools (True = bad)
        self._bad: dict = {}          # key -> running bad count in window
        self._burning: dict = {}      # key -> edge-trigger state

    # -- configuration ------------------------------------------------

    def _refresh_locked(self) -> dict:
        spec = os.environ.get("SKYLARK_SLO") or ""
        if spec != self._spec:
            self._spec = spec
            self._objectives = parse_slos(spec)
            for gone in set(self._windows) - set(self._objectives):
                self._windows.pop(gone, None)
                self._bad.pop(gone, None)
                self._burning.pop(gone, None)
        return self._objectives

    @staticmethod
    def _window_size() -> int:
        try:
            n = int(os.environ.get("SKYLARK_SLO_WINDOW", _DEF_WINDOW))
        except ValueError:
            n = _DEF_WINDOW
        return max(1, n)

    @staticmethod
    def _burn_threshold() -> float:
        try:
            return float(os.environ.get("SKYLARK_SLO_BURN", _DEF_BURN))
        except ValueError:
            return _DEF_BURN

    # -- observation --------------------------------------------------

    def observe(self, op: str, latency_ms: float, *, tenant=None,
                shed: bool = False) -> None:
        """Judge one finished (or shed) request against the objectives."""
        if not config.enabled():
            return
        with self._lock:
            objectives = self._refresh_locked()
            if not objectives:
                return
            keys = [op]
            if tenant:
                keys.append(f"{op}@{tenant}")
            for key in keys:
                obj = objectives.get(key)
                if obj is not None:
                    self._observe_one_locked(obj, latency_ms, shed)

    def _observe_one_locked(self, obj, latency_ms: float, shed: bool) -> None:
        size = self._window_size()
        win = self._windows.get(obj.key)
        if win is None or win.maxlen != size:
            win = deque(win or (), maxlen=size)
            self._windows[obj.key] = win
            self._bad[obj.key] = sum(win)
        bad = bool(shed) or float(latency_ms) > obj.threshold_ms
        if len(win) == win.maxlen:
            self._bad[obj.key] -= win[0]
        win.append(bad)
        if bad:
            self._bad[obj.key] += 1
            inc("slo.breaches")
        inc("slo.observed")
        remaining = self._budget_remaining(obj, len(win), self._bad[obj.key])
        set_gauge(f"slo.budget_remaining.{obj.key}", round(remaining, 6))
        burn_min = self._burn_threshold()
        if len(win) >= min(_MIN_SAMPLES, win.maxlen):
            if remaining < burn_min and not self._burning.get(obj.key):
                self._burning[obj.key] = True
                self._mint_burn_locked(obj, remaining, len(win),
                                       self._bad[obj.key])
            elif remaining >= burn_min and self._burning.get(obj.key):
                self._burning[obj.key] = False
                inc("slo.recoveries")

    @staticmethod
    def _budget_remaining(obj, n: int, bad: int) -> float:
        if n == 0:
            return 1.0
        allowed = n * (1.0 - obj.target_pct / 100.0)
        if allowed <= 0.0:
            return 1.0 if bad == 0 else float(-bad)
        return 1.0 - bad / allowed

    def _mint_burn_locked(self, obj, remaining: float, n: int,
                          bad: int) -> None:
        inc("slo.burns")
        payload = {
            "trace_id": f"slo-burn-{next_id()}",
            "op": "slo_burn",
            "status": "slo_burn",
            "violation": True,
            "ts": time.time(),
            "slo": obj.key,
            "threshold_ms": obj.threshold_ms,
            "target_pct": obj.target_pct,
            "budget_remaining": round(remaining, 6),
            "window": n,
            "bad": bad,
        }
        RECORDER.record(payload, violating=True)
        ledger.event("slo", "burn", {
            "slo": obj.key,
            "budget_remaining": round(remaining, 6),
            "window": n,
            "bad": bad,
        })

    # -- reporting ----------------------------------------------------

    def report(self) -> dict:
        """``{key: {...objective, window, bad, burn_rate, budget_remaining,
        burning}}`` for every declared objective (empty when none)."""
        with self._lock:
            objectives = self._refresh_locked()
            out = {}
            for key, obj in objectives.items():
                win = self._windows.get(key)
                n = len(win) if win else 0
                bad = self._bad.get(key, 0)
                out[key] = {
                    **obj.to_dict(),
                    "window": n,
                    "bad": bad,
                    "burn_rate": round(bad / n, 6) if n else 0.0,
                    "budget_remaining": round(
                        self._budget_remaining(obj, n, bad), 6),
                    "burning": bool(self._burning.get(key)),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._spec = None
            self._objectives = {}
            self._windows.clear()
            self._bad.clear()
            self._burning.clear()


TRACKER = SloTracker()


def observe_slo(op: str, latency_ms: float, *, tenant=None,
                shed: bool = False) -> None:
    """Module-level shorthand for ``TRACKER.observe`` (no-op when the
    telemetry gate is off or no objectives are declared)."""
    TRACKER.observe(op, latency_ms, tenant=tenant, shed=shed)


def slo_report() -> dict:
    """Current per-objective budget state (empty dict when none declared)."""
    return TRACKER.report()


def reset_slo() -> None:
    """Test hook: drop all windows and edge-trigger state."""
    TRACKER.reset()
