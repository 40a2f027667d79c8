"""Unified telemetry: structured spans, metrics registry, JSONL run ledger
(port of ``libskylark_tpu/telemetry``).

One process-wide :class:`Registry` of counters/gauges/histograms,
nestable :func:`span` contexts (host time, never a wait for the card;
each a ``utils.profiling.annotate`` region, so a profiler trace shows
the program's layers beside the card's kernels; the names are
:data:`~.spans.SPANS`), and a monotonically sequenced JSONL event sink
— the *run ledger* — with the JAX package's schema ``{ts, seq, pid,
kind, name, attrs}`` and file name (``ledger-<pid>.jsonl``).

Wired where the JAX package wires it: plan-cache hits/misses/compiles
(``plans``), streaming chunk spans + prefetch overlap (``streaming``),
recovery-ladder attempts (``guard``), checkpoint save/restore
(``resilient``), policy decisions (``policy``), byte-source retries
(``io``); every ``(x, info)`` solver entrypoint closes its run with a
:func:`run_summary` event, which is also where the policy layer's
observations reach the profile store.  The least-squares path has
spans of its own from the entry down to the plans' captures and the
solvers' chunks (:mod:`.spans`); a span is legal inside a CUDA graph
capture, where its host code runs once.

Gated by ``SKYLARK_TELEMETRY`` (default OFF, read per call): disabled,
every entry point returns before allocating and never waits for the
card — runs are bitwise those of a build without this package.  A
span also opens its annotation while a ``torch.profiler`` profile
records, with telemetry off.
``SKYLARK_TELEMETRY_DIR`` (or :func:`configure`, or the CLIs'
``--telemetry-dir``) points the ledger at a directory; without it events
still count in the registry.

End of run: :func:`snapshot` folds the registry with ``plans.stats()``,
the prefetch overlap ratios, and the guard / checkpoint / policy counter
groups; :func:`report` prints the counters through
``utils.timer.timer_report``.  The request-scoped traces (:mod:`.trace`),
SLO budgets (:mod:`.slo`), the timeline ring (:mod:`.timeline`), the
fleet folds (:mod:`.fleet`) and the Prometheus exposition
(:mod:`.exposition`) are here for the serve plane; the multi-process
reductions gather over the ``torch.distributed`` group.
"""

from .config import enabled, ledger_dir
from .exposition import prometheus_text
from .fleet import fleet_snapshot, fold_ledgers, merge_snapshots
from .ledger import close, configure, emit, event, flush, ledger_path
from .phases import PHASES, enable_phase_buckets, observe_phase, phases_enabled
from .registry import (
    LOCK,
    REGISTRY,
    Registry,
    enable_buckets,
    inc,
    observe,
    reset,
    set_gauge,
)
from .report import report, run_summary, snapshot
from .slo import observe_slo, reset_slo, slo_report
from .timeline import (
    reset_timeline,
    timeline_state,
    timeline_tick,
    timeline_windows,
)
# SPANS is the port's own catalog, outside __all__ (the JAX package's list).
from .spans import NOOP_SPAN, SPANS, Span, span
from .trace import (
    RECORDER,
    FlightRecorder,
    TraceContext,
    activate,
    drain_traces,
    dump_traces,
    error_event,
    get_trace,
    is_violating,
    mint,
    trace_enabled,
    trace_event,
    trace_ids,
)
from .trace import finish as finish_trace

__all__ = [
    "enabled",
    "ledger_dir",
    "configure",
    "event",
    "emit",
    "ledger_path",
    "flush",
    "close",
    "Registry",
    "REGISTRY",
    "LOCK",
    "inc",
    "set_gauge",
    "observe",
    "enable_buckets",
    "reset",
    # phase clock + SLO engine + timeline ring
    "PHASES",
    "phases_enabled",
    "observe_phase",
    "enable_phase_buckets",
    "observe_slo",
    "slo_report",
    "reset_slo",
    "timeline_tick",
    "timeline_windows",
    "timeline_state",
    "reset_timeline",
    "span",
    "Span",
    "NOOP_SPAN",
    "snapshot",
    "run_summary",
    "report",
    # tracing + flight recorder
    "TraceContext",
    "FlightRecorder",
    "RECORDER",
    "mint",
    "trace_enabled",
    "is_violating",
    "activate",
    "trace_event",
    "error_event",
    "finish_trace",
    "get_trace",
    "trace_ids",
    "drain_traces",
    "dump_traces",
    # fleet aggregation + exposition
    "merge_snapshots",
    "fold_ledgers",
    "fleet_snapshot",
    "prometheus_text",
]
