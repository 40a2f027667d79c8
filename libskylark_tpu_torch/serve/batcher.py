"""Cross-request coalescing executors: N requests, one fused dispatch
(port of ``libskylark_tpu/serve/batcher.py``).

A batch arrives here already grouped by coalesce key (same registered
entity, same serialized sketch, same input signature — see
``admission.take_batch``).  The executor stacks the requests' payloads
on the host (an LS batch straight into pinned memory in the system's
dtype), stages the stacked block onto the device once
(``streaming.pipeline.device_placer``: pinned memory, the copy stream),
pads it up to the lane-uniform rung, runs the planned sketch applies
(``plans.apply`` / ``plans.apply_rowwise_bucketed``, captured CUDA
graphs on the card) and the small solve or matmul, brings the results
back to the host once per batch, and fans them out to the per-request
futures.

Bitwise isolation contract: a request's result is bit-identical
whatever batch it rode in — alone (padded to the first rung), coalesced
with strangers, or on another rung.  The JAX package gets this from
XLA's per-slot purity on the lane-uniform sub-ladder.  Here cuBLAS (and
MKL on the CPU) pick their GEMM and triangular-solve algorithms by
operand width: at 2048 x 512 by 32 columns MKL already gives other bits
in every column than at 8, and the plain WHT of a 2^20-row FJLT puts the
batch width in its GEMMs' free dimension.  So every executor runs in
fixed blocks of the base rung (:data:`BLOCK` = 8 columns of an LS batch,
8 rows of a predict batch): each sketch apply, GEMM and triangular
solve sees the same shape whatever the batch width, and a slot's bits
do not depend on its position inside a block (each output element is
one reduction in the same order).  ``tests/test_torch_serve.py`` pins
coalesced ≡ serial bitwise for LS-solve and predict (both model kinds)
across rung boundaries, and ``chip_smoke.py`` phase 3n on the card.

Fault isolation: after every batch the per-request results are probed
finite.  A failing request (or a batch-wide exception in a >1 batch) is
re-run SOLO through the same executor, and only if the solo run still
fails does that request get a structured ``NumericalHealthError`` (code
108) response; its batch-mates keep their results.  A solo request whose
executor raises (a failed launch, an invalidated capture) gets that
error in its response: nothing answers from a plain version instead.
Every retry/fallback lands in the request's ``trace["events"]``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import plans, telemetry
from ..core.random import _const
from ..telemetry.trace import is_violating, next_id
from ..utils.exceptions import NumericalHealthError, SkylarkError, UnsupportedError
from . import dispatch, protocol

__all__ = ["run_batch", "BLOCK"]

#: The base rung: executors compute in blocks of this many slots.
BLOCK = 8


def _host_block(payloads, dtype, device: torch.device) -> torch.Tensor:
    """The k payloads stacked as one ``(k, ...)`` host tensor of
    ``dtype``, written straight into pinned memory when it is bound for
    a card: one pass over each payload, the cast to ``dtype`` being the
    copy (no stacked f64 intermediate, no second copy to pin it)."""
    out = torch.empty((len(payloads),) + payloads[0].shape, dtype=dtype,
                      pin_memory=device.type == "cuda")
    for row, p in zip(out, payloads):
        row.copy_(torch.from_numpy(p))
    return out


def _stage(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host→device staging of one executor operand through the streaming
    layer's placer (pinned memory and the copy stream on the card), made
    safe to use on the current stream."""
    from ..streaming.pipeline import device_placer, ready

    return ready(device_placer(x, device))


def _lane_bucket(k: int) -> int:
    """Smallest ladder rung >= k that is a multiple of the base rung (8):
    the ladder minus its lone 12-wide rung, so every rung is a whole
    number of :data:`BLOCK`-wide blocks."""
    kb = plans.bucket_for(k)
    while kb % BLOCK:
        kb = plans.bucket_for(kb + 1)
    return kb


def _by_blocks(fn, X: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` applied to each :data:`BLOCK`-wide block of ``X`` along
    ``dim`` (columns: 1, rows: 0), the results concatenated there."""
    return torch.cat([fn(blk.contiguous()) for blk in X.split(BLOCK, dim=dim)], dim=dim)


def _qr_solve(Qt, R, SB):
    """x̂ = R⁻¹ Qᵀ S b per column — the sketch-and-solve normal step, in
    blocks of :data:`BLOCK` columns."""
    return _by_blocks(
        lambda sb: torch.linalg.solve_triangular(R, Qt @ sb, upper=True), SB, 1)


def _execute_ls(registry, entries, device=None):
    # The entity PINNED at validation, not the registry head: a live
    # row-append/downdate landing while this batch queued published a
    # new version object — this batch still executes against the exact
    # epoch it admitted under (prime() entries carry no pin).
    system = entries[0].entity or registry.get_system(
        entries[0].request["system"]
    )
    S = entries[0].sketch or system.S
    dev = system.device if device is None else torch.device(device)
    k = len(entries)
    kb = _lane_bucket(k)
    Bt = _stage(_host_block([e.payload for e in entries], system.dtype, dev), dev)
    # (S.n, kb): the k right-hand sides as columns, zero columns up to the
    # rung, and for a capacity-reserved system zero rows up to the sketch
    # domain (rows [m, capacity) are virtual zeros in the registered S·A).
    B = Bt.new_zeros((S.n, kb))
    B[: Bt.shape[1], :k] = Bt.T

    def single():
        return _by_blocks(lambda b: plans.apply(S, b, "columnwise"), B, 1)

    SB = None
    if entries[0].sketch is not None:
        # fresh-sketch slow path: the factorization is per-request
        Q, R = torch.linalg.qr(plans.apply(S, system.A.to(dev), "columnwise"))
        Qt = Q.T.contiguous()
    else:
        Qt, R = system.Qt.to(dev), system.R.to(dev)
        # Heavy half over several devices when the rung clears the gates
        # (dispatch.py); the (s, kb) solve below is the unchanged light half.
        SB = dispatch.maybe_sketch_sharded(S, B, kb, entries, single)
    if SB is None:
        SB = single()
    X = _qr_solve(Qt, R, SB)[:, :k].T.cpu().numpy()  # (k, n), one read per batch
    return list(X), kb


def _feature_z(model, Xb):
    """The feature block Z of one :data:`BLOCK`-row block of a predict
    batch (zero rows past the requests'), planned: every map rides
    ``apply_rowwise_bucketed`` at the block's fixed shape, so one plan per
    map serves every batch."""
    blocks = []
    for S in model.maps:
        Z = plans.apply_rowwise_bucketed(S, Xb)
        if model.scale_maps:
            Z = Z * _const(math.sqrt(Z.shape[-1] / Xb.shape[-1]), Z.dtype, Z.device)
        blocks.append(Z)
    return torch.cat(blocks, dim=-1) if blocks else Xb


def _execute_predict(registry, entries, device=None):
    name = entries[0].request["model"]
    model = entries[0].entity or registry.get_model(name)
    dev = registry.device if device is None else torch.device(device)
    X = np.concatenate([e.payload for e in entries])  # (R, d)
    R_tot = X.shape[0]
    kb = _lane_bucket(R_tot)
    Xp = _stage(torch.from_numpy(plans.pad_rows(X, kb)), dev)
    if hasattr(model, "maps"):
        W = model.W.to(dev)

        def block(xb):
            Z = _feature_z(model, xb)
            return Z @ W.to(Z.dtype)

        def single():
            return _by_blocks(block, Xp, 0)

        O = dispatch.maybe_feature_sharded(model, Xp, R_tot, entries, single)
    else:
        def single():
            return _by_blocks(model.predict, Xp, 0)

        O = dispatch.maybe_kernel_sharded(model, Xp, R_tot, entries, single)
    if O is None:
        O = single()
    O = O[:R_tot].cpu().numpy()
    outs, at = [], 0
    for e in entries:
        r = e.payload.shape[0]
        outs.append(O[at:at + r])
        at += r
    return outs, kb


def _execute_cond_est(registry, entries, device=None):
    """Served cond-est: ONE cached probe of the system's R factor
    (``LSSystem.cond_report``), fanned to every coalesced rider."""
    system = entries[0].entity or registry.get_system(
        entries[0].request["system"]
    )
    rep = system.cond_report(cache=getattr(registry, "cache", None))
    return [dict(rep) for _ in entries], len(entries)


def _execute_ppr(registry, entries, device=None):
    """Served PPR: each rider's canonical seed-set payload resolves
    through ``GraphSystem.ppr_report`` — memoized, so coalesce-mates
    with the same seed set share ONE active-support diffusion."""
    gsys = entries[0].entity or registry.get_graph(
        entries[0].request["graph"]
    )
    cache = getattr(registry, "cache", None)
    return (
        [dict(gsys.ppr_report(e.payload, cache=cache)) for e in entries],
        len(entries),
    )


def _execute_ase_embed(registry, entries, device=None):
    """Served embedding queries against the resident ASE matrix: row
    lookup (``"rows"`` payloads) or out-of-sample neighbor projection
    (``"oos"``).  Pure host-array indexing per rider."""
    gsys = entries[0].entity or registry.get_graph(
        entries[0].request["graph"]
    )
    outs = []
    for e in entries:
        mode, idx = e.payload
        outs.append(gsys.rows(idx) if mode == "rows" else gsys.project(idx))
    return outs, len(entries)


def _execute_update(registry, entries, device=None):
    """Live-registry mutation executor.  Updates NEVER coalesce (the
    server keys each uniquely) and never solo-retry — a mutation must
    apply at most once.  The result is the minted epoch-ledger record."""
    outs = []
    for e in entries:
        p = e.payload
        idem = p.get("idem")
        if p["kind"] == "graph_fold":
            _, rec = registry.fold_graph_edges(
                p["name"], p["edges"], idem=idem
            )
        elif p["kind"] == "row_append":
            _, rec = registry.append_system_rows(
                p["name"], p["rows"], idem=idem
            )
        else:
            _, rec = registry.downdate_system_rows(
                p["name"], p["drop"], idem=idem
            )
        outs.append(dict(rec))
    return outs, len(entries)


_EXECUTORS = {
    "ls_solve": _execute_ls,
    "cond_est": _execute_cond_est,
    "predict": _execute_predict,
    "ppr": _execute_ppr,
    "ase_embed": _execute_ase_embed,
    "update": _execute_update,
}


def _result_finite(out) -> bool:
    """The per-request finite probe, dict-aware: structured results
    (cond-est reports) probe their numeric leaves, and NaN alone is
    unhealthy — an honest ``inf`` cond for a numerically singular
    system is a legitimate served answer, not a fault."""
    if isinstance(out, dict):
        vals = [v for v in out.values() if isinstance(v, (int, float))]
        return not np.isnan(np.asarray(vals, np.float64)).any()
    return bool(np.isfinite(np.asarray(out, np.float64)).all())


def _decode(entry, out):
    """Per-request post-processing AFTER the finite probe: label decode
    for classification predicts, squeeze for single-row requests."""
    if entry.op == "predict" and entry.request.get("labels"):
        # classes snapshot onto the request at admission (server side)
        classes = entry.request.get("_classes")
        idx = np.argmax(out, axis=-1)
        out = np.asarray(classes)[idx] if classes is not None else idx
    if (
        entry.squeeze
        and getattr(out, "ndim", 0) > 0
        and entry.op in ("predict", "ase_embed")
    ):
        out = out[0]
    return out


def _stamp_phases(entry, phase_info) -> None:
    """Finalize the phase clock for one traced entry: the stamps form a
    contiguous monotonic chain (admit → pop → take → exec start → exec
    end → here), so the phases sum to the end-to-end latency by
    construction; ``plan_compile`` is carved out of the executor wall
    time via the plan-cache compile-seconds delta."""
    t0m, t1m, compile_ms = phase_info
    t_done = time.monotonic()
    exec_ms = (t1m - t0m) * 1e3
    p = entry.phases
    t_take = p.pop("_t_take", t0m)
    p["dispatch_queue"] = (t0m - t_take) * 1e3
    p["plan_compile"] = min(max(compile_ms, 0.0), exec_ms)
    p["device_execute"] = exec_ms - p["plan_compile"]
    p["depad_serialize"] = (t_done - t1m) * 1e3
    entry.phases = None  # consumed — a solo retry would restamp fresh
    phases = {k: round(v, 4) for k, v in p.items()}
    entry.trace["phases"] = phases
    if entry.t_admit is not None:
        entry.trace["e2e_ms"] = round((t_done - entry.t_admit) * 1e3, 4)
    for k, v in phases.items():
        telemetry.observe_phase(k, v)


def _finish_ok(entry, out, batch_size, bucket, t_exec_ms, registry=None,
               phase_info=None):
    entry.trace.update(
        batch_size=batch_size,
        bucket=bucket,
        coalesced=batch_size > 1,
        exec_ms=round(t_exec_ms, 4),
    )
    if entry.phases is not None and phase_info is not None:
        _stamp_phases(entry, phase_info)
    if entry.counter_base is not None:
        entry.trace["counter_base"] = entry.counter_base
    if entry.entity is not None:
        # The epoch this request was actually served at — the auditable
        # half of the live-registry bitwise contract.
        entry.trace["registry_epoch"] = int(
            getattr(entry.entity, "epoch", 0)
        )
    if registry is not None and entry.cache_key is not None:
        # Fill the front-door result cache with the DECODED per-request
        # result (the cache deep-copies and freezes on put, so a caller
        # mutating the response envelope cannot poison it).  The key
        # pins the epoch this batch served at, so a fold landing
        # mid-flight never aliases old bits onto the new version's key.
        registry.cache.put(
            entry.cache_key, out, entity=entry.cache_entity
        )
    telemetry.inc("serve.ok")
    if telemetry.enabled():
        telemetry.inc(f"serve.tenant.{entry.tenant_label}.ok")
    # a request that answered OK but only after a solo-retry / guard
    # rung is still an SLO incident: keep it in the violation ring
    telemetry.finish_trace(
        entry.tctx, "ok", violation=is_violating(entry.trace["events"])
    )
    entry.future.set_result(
        protocol.ok_response(entry.request.get("id"), out, entry.trace)
    )


def _finish_error(entry, exc, batch_size):
    entry.trace.update(batch_size=batch_size, coalesced=batch_size > 1)
    code = int(getattr(exc, "code", 100))
    if telemetry.enabled():
        telemetry.inc(f"serve.tenant.{entry.tenant_label}.errors")
    if entry.tctx is not None:
        # error_event appends onto the active trace, whose event list
        # aliases entry.trace["events"] — envelope and recorder in one
        with telemetry.activate([entry.tctx]):
            telemetry.error_event(
                f"serve.{entry.op}", exc, op=entry.op
            )
    else:
        entry.trace["events"].append(
            {"kind": "error", "code": code, "type": type(exc).__name__}
        )
    telemetry.finish_trace(entry.tctx, "error", code=code)
    entry.future.set_result(
        protocol.error_response(entry.request.get("id"), exc, entry.trace)
    )


def run_batch(registry, entries, device=None) -> None:
    """Execute one coalesced batch; every entry's future is resolved by
    the time this returns (ok, degraded-solo, or structured error).

    Tracing: ONE dispatch span id is minted per call and attached to
    every traced entry — the k requests a coalesced batch carried share
    it, and a solo retry (which re-enters here) mints a fresh one, so
    the two rungs stay distinguishable in the flight recorder.  The
    traces ride the thread's active set for the duration, so plan-cache
    and guard events emitted below land on them too."""
    tctxs = [e.tctx for e in entries if e.tctx is not None]
    if not tctxs:  # telemetry off: zero tracing work, not even a span id
        _dispatch(registry, entries, device)
        return
    sid = next_id()
    n = len(entries)
    peers = {"peers": [t.trace_id for t in tctxs]} if n > 1 else {}
    for t in tctxs:
        t.event("dispatch", span=sid, batch_size=n, **peers)
    with telemetry.activate(tctxs):
        _dispatch(registry, entries, device)


def _dispatch(registry, entries, device=None) -> None:
    executor = _EXECUTORS[entries[0].op]
    n = len(entries)
    # Phase clock: only when the worker armed at least one entry (traced
    # request with SKYLARK_PHASES on) — otherwise not even a timestamp.
    phase_t0 = (
        time.monotonic()
        if any(e.phases is not None for e in entries)
        else None
    )
    compile_before = (
        plans.stats()["compile_seconds"] if phase_t0 is not None else 0.0
    )
    t0 = time.perf_counter()
    try:
        outs, bucket = executor(registry, entries, device)
    except Exception as e:  # noqa: BLE001 — isolate, then solo-retry
        if n == 1 or isinstance(e, UnsupportedError):
            # A route the port refuses is the batch's, not a payload's: a
            # solo retry at a narrower rung would hide it, so every rider
            # gets the error.
            for entry in entries:
                telemetry.inc("serve.errors")
                if not isinstance(e, SkylarkError):
                    telemetry.event("serve", "batch_error", {"type": type(e).__name__})
                _finish_error(entry, e, n)
            return
        # a poisoned batch: re-run each request alone so one bad payload
        # cannot take its batch-mates down with it
        telemetry.inc("serve.fallbacks")
        for e2 in entries:
            e2.trace["events"].append(
                {"kind": "fallback", "reason": f"batch raised {type(e).__name__}"}
            )
            telemetry.inc("serve.solo_retries")
            run_batch(registry, [e2], device)
        return
    t_ms = (time.perf_counter() - t0) * 1e3
    phase_info = None
    if phase_t0 is not None:
        # Executor wall time is device time: every executor brings its
        # result to the host, which waits for the device.
        phase_info = (
            phase_t0,
            time.monotonic(),
            (plans.stats()["compile_seconds"] - compile_before) * 1e3,
        )
    for entry, out in zip(entries, outs):
        if not _result_finite(out):
            if n > 1:
                # this request's own data is bad (padding and batch-mates
                # cannot leak in — slot purity): solo re-run confirms, and
                # the solo path owns the structured verdict
                telemetry.inc("serve.fallbacks")
                telemetry.inc("serve.solo_retries")
                entry.trace["events"].append(
                    {"kind": "fallback", "reason": "non-finite in batch"}
                )
                telemetry.event(
                    "serve", "fallback",
                    {"op": entry.op, "id": entry.request.get("id")},
                )
                run_batch(registry, [entry], device)
                continue
            telemetry.inc("serve.errors")
            entry.trace["events"].append(
                {"kind": "fallback", "reason": "non-finite solo result"}
            )
            _finish_error(
                entry,
                NumericalHealthError(
                    "served result is non-finite after solo re-run "
                    "(request payload is numerically unhealthy)",
                    stage=f"serve_{entry.op}",
                ),
                n,
            )
            continue
        _finish_ok(entry, _decode(entry, out), n, bucket, t_ms, registry,
                   phase_info)
