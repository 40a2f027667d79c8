"""The recovery ladder: resketch → grow → dense fallback (port of
``libskylark_tpu/guard/ladder.py``).

1. attempt 0 — the caller's own sketch (``initial``);
2. attempt 1 — a fresh-seed resketch at the same size (``resketch``);
3. attempts 2..max_retries — fresh seed and the sketch dimension grown
   by :data:`~.config.GROWTH_FACTOR`, clamped to the problem (``grow``);
4. ``fallback`` — the exact dense solve.

Every attempt lands in a :class:`RecoveryReport`, whose ``to_dict()``
solvers attach as ``info["recovery"]``; with telemetry on, each rung is
also a ``guard`` ledger event, a trace event and the ``guard.attempts``
/ ``guard.<action>`` counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.context import SketchContext
from ..utils.exceptions import NumericalHealthError
from . import config
from .certify import FALLBACK, OK

__all__ = ["RecoveryAttempt", "RecoveryReport", "derived_context", "run_ladder"]


@dataclass
class RecoveryAttempt:
    """One rung taken: what was tried and what the certificate said."""

    action: str  # initial | resketch | grow | fallback
    verdict: str | None = None  # OK | RESKETCH | FALLBACK
    detail: str = ""
    cond: float | None = None
    sketch_size: int | None = None
    chunk: int | None = None

    def to_dict(self) -> dict:
        d = {"action": self.action}
        for k in ("verdict", "detail", "cond", "sketch_size", "chunk"):
            v = getattr(self, k)
            if v not in (None, ""):
                d[k] = v
        return d


@dataclass
class RecoveryReport:
    """Everything the guard did for one solve; ``to_dict()`` is the
    stable ``info["recovery"]`` payload ``{"stage", "guarded",
    "recovered", "attempts"}`` (no attempts when the guard is off)."""

    stage: str
    guarded: bool = True
    recovered: bool = False
    attempts: list = field(default_factory=list)

    @classmethod
    def disabled(cls, stage: str) -> "RecoveryReport":
        return cls(stage=stage, guarded=False)

    def record(self, action: str, **kw) -> RecoveryAttempt:
        a = RecoveryAttempt(action=action, **kw)
        self.attempts.append(a)
        from .. import telemetry

        if telemetry.enabled():
            # One ledger event per rung taken, with the certificate's
            # verdict riding along — the run ledger's view of the ladder.
            attrs = a.to_dict()
            attrs["stage"] = self.stage
            attrs["rung"] = len(self.attempts) - 1
            telemetry.event("guard", action, attrs)
            # ... and the request trace's view: a rung > 0 here marks
            # the trace SLO-violating (see telemetry.trace.is_violating)
            telemetry.trace_event("guard", **attrs)  # attrs carry action
            telemetry.inc("guard.attempts")
            telemetry.inc(f"guard.{action}")
        return a

    def to_dict(self) -> dict:
        return {
            "stage": self.stage,
            "guarded": self.guarded,
            "recovered": self.recovered,
            "attempts": [a.to_dict() for a in self.attempts],
        }


def derived_context(context: SketchContext, attempt: int) -> SketchContext:
    """The fresh-seed context of ladder attempt ``attempt``: golden-ratio
    mixing of the base seed, the JAX package's derivation exactly."""
    seed = (int(context.seed) ^ (0x9E3779B9 * attempt)) % (2**31 - 1)
    return SketchContext(seed=seed)


def run_ladder(stage: str, context: SketchContext, sketch_size: int, max_size: int,
               attempt_fn, fallback_fn, *, report: RecoveryReport | None = None,
               max_retries: int | None = None, growth: float | None = None):
    """Drive ``attempt_fn(ctx, s, index) -> (result, Certificate)`` up the
    ladder; returns ``(result, report)``.  ``fallback_fn() -> result`` is
    the dense rung; with ``None`` an exhausted ladder raises
    :class:`NumericalHealthError`."""
    report = report or RecoveryReport(stage=stage)
    retries = max_retries if max_retries is not None else config.max_retries()
    factor = growth if growth is not None else config.GROWTH_FACTOR
    s = int(sketch_size)
    for i in range(retries + 1):
        if i == 0:
            action, ctx = "initial", context
        elif i == 1:
            action, ctx = "resketch", derived_context(context, i)
        else:
            action, ctx = "grow", derived_context(context, i)
            s = min(int(s * factor), int(max_size))
        result, cert = attempt_fn(ctx, s, i)
        report.record(action, verdict=cert.verdict, detail=cert.detail, cond=cert.cond,
                      sketch_size=s)
        if cert.verdict == OK:
            report.recovered = i > 0
            return result, report
        if cert.verdict == FALLBACK:
            break
    if fallback_fn is None:
        raise NumericalHealthError(
            f"recovery ladder exhausted at stage {stage!r} ({len(report.attempts)} attempts)",
            stage=stage, report=report)
    result = fallback_fn()
    report.record("fallback", verdict=FALLBACK, detail="exact dense solve")
    report.recovered = True
    return result, report
