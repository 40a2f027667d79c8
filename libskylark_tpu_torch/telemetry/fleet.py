"""Cross-host telemetry aggregation: one fleet view of many registries
(port of ``libskylark_tpu/telemetry/fleet.py``).

Two independent folds, composable because both produce/consume the
``snapshot()`` dict shape:

- :func:`merge_snapshots` — the pure reduction.  Counters sum (the
  acceptance contract: merged counters EQUAL the sum of per-rank
  snapshots), histograms merge their streaming moments
  (count/sum add, min/max extremize), gauges keep the per-rank values
  under ``gauges_by_rank`` plus a max fold, and the ``plans`` counter
  block sums like counters.  Derived ratios are recomputed from the
  merged numbers, never averaged.
- :func:`fold_ledgers` — the durable half: walks the elastic
  checkpoint root's ``host-*/progress.jsonl`` ledgers (the elastic
  layer's per-host fold records), epoch-fenced exactly like
  ``streaming.repartition``: only the NEWEST epoch's records merge
  (``epoch.json`` marker when present, else the max epoch observed),
  stale epochs are counted, never folded.  The result is one merged
  timeline ordered by ``(ts, rank, seq)`` plus per-rank progress
  summaries — the single view an elastic run never had.

:func:`fleet_snapshot` composes them: the live-process side gathers
every rank's registry, and the ledger side folds whatever root it is
pointed at.  In a single-process world (``torch.distributed`` not
initialized, or a world of 1) the gather degenerates to the local
snapshot, so ``telemetry.snapshot(fleet=True)`` is safe to call there;
a larger world all-gathers every rank's registry.

The ledger fold reads the files the elastic layer writes
(``host-*/progress.jsonl`` in the run-ledger schema, the root's
``epoch.json``).  The two readers, :func:`read_progress` and
:func:`read_epoch`, live here once: ``streaming.elastic`` and
``streaming.repartition`` import them from this module (the telemetry
package is imported before the streaming one).
"""

from __future__ import annotations

import glob
import json
import os
import re

from .report import snapshot as _local_snapshot

__all__ = ["merge_snapshots", "fold_ledgers", "fleet_snapshot"]

_HOST_RE = re.compile(r"host-(\d+)$")

PROGRESS_NAME = "progress.jsonl"  # ≙ libskylark_tpu/streaming/elastic.py:89
EPOCH_NAME = "epoch.json"  # ≙ libskylark_tpu/streaming/repartition.py:84


def read_progress(path) -> list[dict]:
    """Parse a ``progress.jsonl`` (≙ ``streaming/elastic.py:309-343`` of
    the JAX package) — tolerant of the torn trailing line a SIGKILL
    mid-write can leave.  Missing file → ``[]``.

    Records are deduplicated by ``(epoch, seq)`` — keeping the LAST
    occurrence, the rewrite wins — and returned ordered by ``(epoch,
    seq)``.  Records without a usable ``seq`` are kept in file order
    after the sequenced ones.
    """
    sequenced: dict[tuple[int, int], dict] = {}
    stray = []
    try:
        # errors="replace": a torn tail can end mid-UTF-8-sequence; the
        # mangled line must fail json.loads (and be skipped), not abort
        # the whole read with UnicodeDecodeError.
        with open(path, encoding="utf-8", errors="replace") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(rec, dict):
                    continue
                try:
                    attrs = rec.get("attrs") or {}
                    key = (int(attrs.get("epoch", 0)), int(rec["seq"]))
                except (AttributeError, KeyError, TypeError, ValueError):
                    stray.append(rec)
                    continue
                sequenced[key] = rec
    except OSError:
        pass
    return [sequenced[k] for k in sorted(sequenced)] + stray


def read_epoch(root) -> dict | None:
    """The root-level epoch marker, or ``None`` for a pre-repartition
    (epoch 0) root or an unreadable marker (≙
    ``streaming/repartition.py:102-115`` of the JAX package)."""
    try:
        with open(os.path.join(str(root), EPOCH_NAME), encoding="utf-8") as fh:
            d = json.load(fh)
    except (OSError, UnicodeDecodeError, json.JSONDecodeError):
        return None
    if d.get("skylark_object_type") != "elastic_epoch":
        return None
    return d


def _ratio(num, den):
    return round(num / den, 6) if den else None


def merge_snapshots(snaps: list[dict]) -> dict:
    """Fold per-rank ``snapshot()`` dicts into one fleet snapshot.

    Merged ``counters[k]`` is exactly ``sum(rank_counters[k])`` over the
    ranks that carry ``k`` — the acceptance invariant pinned in
    ``tests/test_torch_trace.py``.
    """
    counters: dict = {}
    histograms: dict = {}
    gauges_by_rank: dict = {}
    plans: dict = {}
    for rank, snap in enumerate(snaps):
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, h in (snap.get("histograms") or {}).items():
            m = histograms.get(k)
            if m is None:
                m = dict(h)
                if "buckets" in h:
                    m["buckets"] = {
                        "le": list(h["buckets"]["le"]),
                        "counts": list(h["buckets"]["counts"]),
                        "count": h["buckets"]["count"],
                        "sum": h["buckets"]["sum"],
                    }
                histograms[k] = m
            else:
                m["count"] += h["count"]
                m["sum"] += h["sum"]
                m["min"] = min(m["min"], h["min"])
                m["max"] = max(m["max"], h["max"])
                # Buckets merge in this PURE path only (the allgathered
                # fleet vectors stay 4-row moments so cross-rank CRC
                # signatures are untouched); mismatched bounds drop the
                # buckets rather than sum misaligned bins.
                bm, bh = m.get("buckets"), h.get("buckets")
                if bm is not None:
                    if bh is not None and list(bm["le"]) == list(bh["le"]):
                        bm["counts"] = [a + b for a, b in
                                        zip(bm["counts"], bh["counts"])]
                        bm["count"] += bh["count"]
                        bm["sum"] += bh["sum"]
                    else:
                        m.pop("buckets", None)
        for k, g in (snap.get("gauges") or {}).items():
            gauges_by_rank.setdefault(k, {})[rank] = g
        for k, v in (snap.get("plans") or {}).items():
            if isinstance(v, (int, float)):
                plans[k] = plans.get(k, 0) + v
    gauges = {}
    for k, per_rank in gauges_by_rank.items():
        nums = [v for v in per_rank.values()
                if isinstance(v, (int, float))]
        if nums:
            gauges[k] = max(nums)
    out = {
        "world": len(snaps),
        "counters": counters,
        "gauges": gauges,
        "gauges_by_rank": gauges_by_rank,
        "histograms": histograms,
        "plans": plans,
    }
    lookups = plans.get("hits", 0) + plans.get("misses", 0)
    out["plan_cache_hit_rate"] = _ratio(plans.get("hits", 0), lookups)
    gets = counters.get("prefetch.hits", 0) + counters.get(
        "prefetch.waits", 0
    )
    out["prefetch_overlap"] = _ratio(counters.get("prefetch.hits", 0), gets)
    for group in ("guard", "checkpoint", "policy", "serve"):
        out[group] = {
            k.split(".", 1)[1]: v
            for k, v in counters.items()
            if k.startswith(group + ".")
        }
    return out


def fold_ledgers(root, *, timeline_limit: int = 256) -> dict:
    """Epoch-fenced fold of every ``host-*/progress.jsonl`` under
    ``root`` into per-rank summaries + one merged timeline.

    Returns ``{"epoch", "ranks": {rank: {...}}, "timeline": [...],
    "stale_records", "lost_hosts"}``; a missing/empty root folds to an
    empty view rather than raising (the exposition surface must stay up
    when no elastic run ever wrote here).
    """
    root = str(root)
    paths = sorted(
        glob.glob(os.path.join(root, "host-*", PROGRESS_NAME))
        + glob.glob(os.path.join(root, "epoch-*", "host-*", PROGRESS_NAME))
    )
    marker = read_epoch(root)
    per_path: list[tuple[int, list[dict]]] = []
    max_epoch = 0
    lost_hosts = []
    for path in paths:
        m = _HOST_RE.search(os.path.dirname(path))
        rank = int(m.group(1)) if m else -1
        try:
            recs = read_progress(path)
        except Exception:  # noqa: BLE001 — a corrupt host is reported, not fatal
            lost_hosts.append(rank)
            continue
        per_path.append((rank, recs))
        for rec in recs:
            max_epoch = max(
                max_epoch, int((rec.get("attrs") or {}).get("epoch", 0))
            )
    epoch = int(marker["epoch"]) if marker else max_epoch
    ranks: dict = {}
    timeline = []
    stale = 0
    for rank, recs in per_path:
        for rec in recs:
            attrs = rec.get("attrs") or {}
            if int(attrs.get("epoch", 0)) != epoch:
                stale += 1
                continue
            r = int(attrs.get("rank", rank))
            summary = ranks.setdefault(
                r,
                {"records": 0, "rows": 0, "batches": 0,
                 "last_seq": 0, "last_ts": 0.0},
            )
            summary["records"] += 1
            summary["rows"] += int(attrs.get("rows", 0) or 0)
            summary["batches"] += int(attrs.get("batches", 1) or 0)
            summary["last_seq"] = max(
                summary["last_seq"], int(rec.get("seq", 0) or 0)
            )
            summary["last_ts"] = max(
                summary["last_ts"], float(rec.get("ts", 0) or 0)
            )
            timeline.append(rec)
    timeline.sort(
        key=lambda rec: (
            float(rec.get("ts", 0) or 0),
            int((rec.get("attrs") or {}).get("rank", -1)),
            int(rec.get("seq", 0) or 0),
        )
    )
    return {
        "epoch": epoch,
        "ranks": ranks,
        "rows_total": sum(r["rows"] for r in ranks.values()),
        "timeline": timeline[-timeline_limit:],
        "stale_records": stale,
        "lost_hosts": lost_hosts,
    }


def _gather_registries(local: dict) -> list[dict]:
    """Every process's registry, in rank order: ``[local]`` in a
    single-process world, else an ``all_gather_object`` of the counter
    and histogram blocks over the ``torch.distributed`` group.  Every
    rank must carry the same counter and histogram names (the collective
    contract of ``utils.timer.timer_report(distributed=True)``); gauges
    and plans are process-local context and ride along for rank 0 only.
    """
    from ..parallel.collectives import gather_objects

    mine = {"counters": dict(local["counters"]), "histograms": {
        n: {f: h[f] for f in ("count", "sum", "min", "max")}
        for n, h in local["histograms"].items()}}
    snaps = gather_objects(mine)
    if len(snaps) == 1:
        return [local]
    names = [(sorted(s["counters"]), sorted(s["histograms"])) for s in snaps]
    if any(n != names[0] for n in names):
        raise RuntimeError(
            "telemetry.snapshot(fleet=True): processes carry different counter-name sets "
            f"(this rank has {len(local['counters'])} counters); every rank must fold the "
            "same metrics — the same collective contract as "
            "utils.timer.timer_report(distributed=True)")
    return [{"counters": {k: float(v) for k, v in s["counters"].items()},
             "histograms": s["histograms"],
             "gauges": local["gauges"] if p == 0 else {},
             "plans": local["plans"] if p == 0 else {}} for p, s in enumerate(snaps)]


def fleet_snapshot(root=None) -> dict:
    """The fleet-wide fold ``telemetry.snapshot(fleet=True)`` returns:
    allgathered per-rank registries merged by :func:`merge_snapshots`,
    plus the epoch-fenced ledger fold of ``root`` (or
    ``SKYLARK_TELEMETRY_FLEET_ROOT``) when one is given."""
    local = _local_snapshot()
    merged = merge_snapshots(_gather_registries(local))
    root = root or os.environ.get("SKYLARK_TELEMETRY_FLEET_ROOT")
    if root:
        merged["hosts"] = fold_ledgers(root)
    return merged
