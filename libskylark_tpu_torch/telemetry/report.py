"""End-of-run folds: ``snapshot()``, ``run_summary()``, ``report()``
(port of ``libskylark_tpu/telemetry/report.py``).

``snapshot()`` is the single picture the four private status channels
used to be: the registry's metrics plus ``plans.stats()``, the prefetch
overlap ratio (from the counters the streaming engine folds in when a
pass closes), and the guard / checkpoint / policy counter groups (the
policy group covers decisions made, escalations, and profile
hits/misses — ``docs/autotuning.md``).

``report()`` is the counter table, and deliberately REUSES
``utils.timer.timer_report``: with ``distributed=True`` every rank of the
``torch.distributed`` group must call it, and the table is min / max /
avg over the ranks.
"""

from __future__ import annotations

from . import config
from .ledger import event, flush
from .registry import REGISTRY

__all__ = ["snapshot", "run_summary", "report"]


def _ratio(num, den):
    return round(num / den, 6) if den else None


def snapshot(fleet: bool = False, root=None) -> dict:
    """Fold every status channel into one dict (works even disabled —
    an empty registry still reports the plan-cache block).

    ``fleet=True`` returns the cross-host fold instead: every rank's
    registry allgathered under the ``timer_report`` CRC name-signature
    discipline and merged so counters SUM over ranks, plus — when
    ``root`` (or ``SKYLARK_TELEMETRY_FLEET_ROOT``) names an elastic
    checkpoint root — the epoch-fenced fold of its
    ``host-*/progress.jsonl`` ledgers under ``"hosts"``.  A
    single-process world degenerates to the local snapshot's numbers;
    in a larger ``torch.distributed`` world every rank must call it
    (see ``telemetry/fleet.py``).
    """
    if fleet:
        from .fleet import fleet_snapshot

        return fleet_snapshot(root)
    from .. import plans

    snap = REGISTRY.snapshot()
    counters = snap["counters"]
    st = plans.stats()
    snap["plans"] = st
    lookups = st["hits"] + st["misses"]
    snap["plan_cache_hit_rate"] = _ratio(st["hits"], lookups)
    gets = counters.get("prefetch.hits", 0) + counters.get("prefetch.waits", 0)
    snap["prefetch_overlap"] = _ratio(counters.get("prefetch.hits", 0), gets)
    # Compute-hidden transfer fraction: of the staging (parse +
    # transfer-issue) seconds the producer spent, how many the consumer
    # never waited for.  1.0 = every transfer hid behind compute;
    # None = no prefetch pipeline ran.
    prod = counters.get("prefetch.producer_seconds", 0.0)
    wait = min(counters.get("prefetch.wait_seconds", 0.0), prod)
    snap["overlap_efficiency"] = _ratio(prod - wait, prod)
    snap["guard"] = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("guard.")
    }
    snap["checkpoint"] = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("checkpoint.")
    }
    snap["policy"] = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("policy.")
    }
    snap["serve"] = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("serve.") and not k.startswith("serve.tenant.")
    }
    # Per-tenant QoS counters fold NESTED (serve.tenant.<t>.<metric> →
    # serve.tenants[t][metric]) instead of flattening into the serve
    # group — the flat group keeps its pre-QoS key set exactly.
    tenants: dict = {}
    for k, v in counters.items():
        if k.startswith("serve.tenant."):
            t, _, metric = k[len("serve.tenant."):].partition(".")
            if metric:
                tenants.setdefault(t, {})[metric] = v
    if tenants:
        snap["serve"]["tenants"] = tenants
    hits = counters.get("serve.cache.hit", 0)
    lookups_c = hits + counters.get("serve.cache.miss", 0)
    if lookups_c:
        snap["serve"]["cache_hit_rate"] = _ratio(hits, lookups_c)
    if snap["serve"]:
        # Derived serving SLOs: fraction of requests that rode a >1
        # coalesced batch, and the latency percentiles from the serve
        # layer's own reservoir (the registry's histograms keep only
        # streaming moments).  The module lookup goes through
        # sys.modules so a run that never imported the serve layer —
        # or a disabled-telemetry run, whose counters stay empty and
        # never reach this branch — folds nothing extra.
        import sys as _sys

        snap["serve"]["coalesce_ratio"] = _ratio(
            counters.get("serve.coalesced", 0),
            counters.get("serve.requests", 0),
        )
        srv = _sys.modules.get("libskylark_tpu_torch.serve")
        if srv is not None:
            snap["serve"].update(srv.latency_percentiles())
    router = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("router.")
    }
    if router:
        # Fleet front-door counters (placements, affinity_hits, joins,
        # ejects, sheds, failovers) fold only when a router actually
        # ran — single-server snapshots keep their exact PR-12 shape.
        router["affinity_ratio"] = _ratio(
            counters.get("router.affinity_hits", 0),
            counters.get("router.placements", 0),
        )
        snap["router"] = router
    autoscale = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("autoscale.")
    }
    if autoscale:
        # Membership control-loop counters (ticks, scale_ups,
        # scale_downs, drains_done, spawn_failures) fold only when an
        # autoscaler ran.
        snap["autoscale"] = autoscale
    registry_live = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("registry.")
    }
    if registry_live:
        # Live-registry epoch counters (epoch.bumps, per-kind mints,
        # epoch.misses = code-116 refusals) — present only once an
        # entity registered or mutated.
        snap["registry"] = registry_live
    train = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("train.")
    }
    if train:
        # Distributed-training counters (runs, iterations, consensus
        # merges, escalations, repartitions, registered hand-offs) —
        # present only when a trainer ran.
        snap["train"] = train
    slo_counters = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("slo.") and not k.startswith("slo.budget_remaining")
    }
    if slo_counters or any(
        k.startswith("slo.budget_remaining.") for k in snap["gauges"]
    ):
        # SLO error-budget state: counters (observed, breaches, burns,
        # recoveries) plus the per-objective budget report — present
        # only once an objective observed traffic.
        from .slo import slo_report

        snap["slo"] = slo_counters
        objectives = slo_report()
        if objectives:
            snap["slo"]["objectives"] = objectives
    timeline_counters = {
        k.split(".", 1)[1]: v
        for k, v in counters.items()
        if k.startswith("timeline.")
    }
    if timeline_counters:
        # Time-series ring counters (ticks) — present only once a
        # window closed.
        snap["timeline"] = timeline_counters
    return snap


def run_summary(name: str, info: dict | None = None, **attrs):
    """Terminal ledger event of one solver run.

    Every ``(x, info)`` solver entrypoint calls this with its ``info``
    dict right before returning (static contract in
    ``tests/test_torch_telemetry.py``), so the ledger's last word on
    a run carries the recovery ledger, the row/batch accounting, AND the
    registry + plan-cache counters to correlate them against.  Returns
    the event's ``seq`` (None when disabled).

    This is also the policy layer's persistence point: pending profile
    observations flush to the ``SKYLARK_POLICY_DIR`` store here — BEFORE
    the telemetry gate, so profiles persist even with telemetry off
    (``policy.flush`` is an allocation-free no-op when the policy layer
    is disabled or storeless).
    """
    from .. import policy

    policy.flush(name, info)
    if not config.enabled():
        return None
    payload = dict(attrs)
    payload["info"] = dict(info or {})
    payload["snapshot"] = snapshot()
    seq = event("run_summary", name, payload)
    flush()
    return seq


def report(distributed: bool = False) -> str:
    """Counter table (gauges as ``gauge.<name>``) through
    :func:`~libskylark_tpu_torch.utils.timer.timer_report`: telemetry
    counters ride where phase totals normally do.  ``distributed=True``
    is a collective: every rank of the group calls it with the same
    counter names, and the table is min / max / avg over the ranks."""
    from ..utils.timer import timer_report

    snap = REGISTRY.snapshot()
    totals = {k: float(v) for k, v in snap["counters"].items()}
    for k, g in snap["gauges"].items():
        try:
            totals[f"gauge.{k}"] = float(g)
        except (TypeError, ValueError):
            continue
    return timer_report(totals, distributed=distributed)
