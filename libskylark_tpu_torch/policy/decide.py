"""``choose_route``: the decision function of the policy layer (port of
``libskylark_tpu/policy/decide.py``).

A decision is a pure function of (the store's entry for the problem's
key, the problem's signature, the caller's pinned fields): no RNG, no
clock, no per-process state, so every process reading the same store
files decides the same.  The decision with nothing learned (the layer
off, no store, an immature entry, or the guard off) is the historical
default: the sketch route, FJLT for dense and CWT for sparse least
squares (JLT for a dense stream), sketch size ``min(4n, m)``, the input
dtype.  A caller-pinned ``route``, ``sketch_type`` or ``sketch_size``
always wins.

What a matured entry can change:

- **route**: a fallback rate of at least one half sends least squares
  to the exact solve; a resketch rate of at least one half to the
  preconditioned iterative solvers (Blendenpik dense, LSRN sparse); a
  refine history with at least one converged run, no stagnation, a
  healthy guard record and a comfortable cond margin earns ``refine``.
- **sketch dimension**: a healthy entry shrinks toward the smallest
  size that certified OK, and with a comfortable cond margin probes one
  step (3/4) below it, never under ``min(2n, m)``; the guard's ladder
  catches an undershoot, and its recorded resketch stops the shrinking.
- **precision**: a healthy dense f32 entry with no bf16 failure on
  record sketches bf16-first where ``config.bf16_allowed``; after
  ``min_samples`` clean bf16 runs and no fp8 failure, fp8 (e4m3)-first
  where ``config.fp8_allowed`` and this torch has e4m3
  (``core.precision.fp8_available``).  The caller escalates to the
  input dtype when attempt 0 does not certify OK.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import telemetry
from . import config
from .profile import load_entries, profile_key

__all__ = ["LS_ROUTES", "ProblemSignature", "Decision", "choose_route"]

# Valid least-squares routes, in escalation order of cost.
LS_ROUTES = ("sketch", "refine", "blendenpik", "lsrn", "exact")

# A certificate is "comfortable" when the estimated cond sits at least
# this factor under the guard's ceiling: margin enough that a smaller
# sketch (cond grows as the dimension shrinks toward n) stays certified.
# The f32 ceiling is 0.1/sqrt(eps) ≈ 290.
_COMFORT_MARGIN = 16.0


@dataclass(frozen=True)
class ProblemSignature:
    """What the dispatcher is allowed to see of a problem: its tags."""

    kind: str  # "ls" | "ls_stream" | "krr" | "train"
    m: int
    n: int
    targets: int = 1
    dtype: str = "float32"
    sparse: bool = False
    backend: str = "cpu"

    @property
    def key(self) -> str:
        return profile_key(self.kind, self.backend, self.dtype, self.m, self.n)


@dataclass
class Decision:
    """One routing decision plus its provenance (``info["policy"]``)."""

    route: str
    sketch_type: str
    sketch_size: int
    compute_dtype: str | None = None
    source: str = "default"  # default | profile
    key: str = ""
    escalated: bool = False
    reasons: list = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {
            "route": self.route,
            "sketch_type": self.sketch_type,
            "sketch_size": int(self.sketch_size),
            "source": self.source,
            "key": self.key,
        }
        if self.compute_dtype:
            d["compute_dtype"] = self.compute_dtype
        if self.escalated:
            d["escalated"] = True
        if self.reasons:
            d["reasons"] = list(self.reasons)
        return d


def _default_decision(sig: ProblemSignature) -> Decision:
    """The historical defaults, exactly."""
    if sig.kind == "ls":
        stype = "CWT" if sig.sparse else "FJLT"
        return Decision("sketch", stype, min(4 * sig.n, sig.m), key=sig.key)
    if sig.kind == "ls_stream":
        stype = "CWT" if sig.sparse else "JLT"
        return Decision("sketch", stype, min(4 * sig.n, sig.m), key=sig.key)
    if sig.kind == "krr":
        # n is the feature count the caller fixed; the route is the
        # Cholesky normal-equations solve.
        return Decision("cholesky", "-", sig.n, key=sig.key)
    if sig.kind == "train":
        # n is the random-feature count of the trainer's maps; the route
        # is the BlockADMM consensus trainer.
        return Decision("admm", "-", sig.n, key=sig.key)
    raise ValueError(f"unknown problem kind {sig.kind!r}")



def _cond_ceiling(dtype: str) -> float:
    """The guard's cond ceiling for a dtype named as the JAX package
    names it (``"float32"``)."""
    from ..guard import config as guard_config

    tdtype = getattr(torch, str(dtype), None)
    return float(guard_config.cond_max(tdtype if isinstance(tdtype, torch.dtype) else None))


def _healthy(entry: dict) -> bool:
    g = entry.get("guard") or {}
    return int(g.get("fallback", 0)) == 0 and int(g.get("resketch", 0)) == 0


def _comfortable(cond_seen, dtype: str) -> bool:
    return cond_seen is not None and float(cond_seen) * _COMFORT_MARGIN < _cond_ceiling(dtype)


def choose_route(
    sig: ProblemSignature,
    *,
    route: str | None = None,
    sketch_type: str | None = None,
    sketch_size: int | None = None,
    guard_on: bool = True,
    store_view: dict | None = None,
) -> Decision:
    """Decide (route, sketch family and size, precision) for ``sig``.

    Pinned fields are honored verbatim and the store fills only those
    left open.  With the layer off, no store, an immature entry (fewer
    than ``SKYLARK_POLICY_MIN_SAMPLES`` runs) or ``guard_on=False`` (a
    deviation leans on the certificate as its safety net), the decision
    is exactly the default.  ``store_view`` stands in for the merged
    view of the configured store.
    """
    d = _default_decision(sig)
    if route is not None:
        d.route = route
        d.reasons.append("route pinned by caller")
    if sketch_type is not None:
        d.sketch_type = sketch_type
    if sketch_size is not None:
        d.sketch_size = int(sketch_size)
    if not config.enabled() or not guard_on:
        return d
    view = store_view if store_view is not None else load_entries()
    entry = (view or {}).get("entries", {}).get(sig.key)
    if entry is None or int(entry.get("runs", 0)) < config.min_samples():
        telemetry.inc("policy.profile_misses")
        return d
    telemetry.inc("policy.profile_hits")
    d.source = "profile"
    runs = max(1, int(entry.get("runs", 1)))
    g = entry.get("guard") or {}
    fallback_rate = int(g.get("fallback", 0)) / runs
    resketch_rate = int(g.get("resketch", 0)) / runs
    healthy = _healthy(entry)

    # -- route ---------------------------------------------------------------
    if route is None and sig.kind == "ls":
        if fallback_rate >= 0.5:
            d.route = "exact"
            d.reasons.append(
                f"fallback rate {fallback_rate:.2f}: sketching keeps "
                "failing on this shape class"
            )
        elif resketch_rate >= 0.5:
            d.route = "lsrn" if sig.sparse else "blendenpik"
            d.reasons.append(
                f"resketch rate {resketch_rate:.2f}: ill-conditioned but "
                "recoverable; preconditioned iterative route"
            )
        else:
            # Refine is earned by recorded history only: a converged run,
            # no stagnation (one retires the route), a healthy guard
            # record and a comfortable cond margin.
            rf = entry.get("refine") or {}
            if (
                healthy
                and int(rf.get("ok", 0)) >= 1
                and int(rf.get("stagnate", 0)) == 0
                and _comfortable((entry.get("cond") or {}).get("max"), sig.dtype)
            ):
                d.route = "refine"
                d.reasons.append(
                    f"refine earned: {int(rf.get('ok', 0))} certified "
                    "refine runs, no stagnation, comfortable cond margin"
                )

    # -- sketch dimension ----------------------------------------------------
    if (
        sketch_size is None
        and d.route == "sketch"
        and sig.kind in ("ls", "ls_stream")
        and healthy
    ):
        sk = entry.get("sketch") or {}
        cond_max_seen = (entry.get("cond") or {}).get("max")
        floor = min(2 * sig.n, sig.m)
        target = d.sketch_size
        if sk.get("min_ok") is not None:
            target = min(target, int(sk["min_ok"]))
        if _comfortable(cond_max_seen, sig.dtype):
            # Probe one geometric step below the smallest certified size;
            # attempt 0's certificate validates the probe.
            target = (target * 3) // 4
            d.reasons.append(
                f"cond margin {float(cond_max_seen):.3e} ≪ ceiling: "
                "probing a smaller sketch dimension"
            )
        new_s = max(floor, min(d.sketch_size, target))
        if new_s != d.sketch_size:
            d.sketch_size = int(new_s)
            if not d.reasons or "probing" not in d.reasons[-1]:
                d.reasons.append("shrunk to smallest certified-OK dimension")

    # -- precision -----------------------------------------------------------
    bf = entry.get("bf16") or {}
    if (
        sig.dtype == "float32"
        and not sig.sparse
        and sig.kind in ("ls", "krr", "train")
        and d.route != "refine"  # refine owns its precision rung
        and healthy
        and int(bf.get("fail", 0)) == 0
        and config.bf16_allowed(sig.backend)
    ):
        d.compute_dtype = "bfloat16"
        d.reasons.append(
            "bf16-first: healthy entry, no bf16 failure on record; guard "
            "certifies, f32 is the escalation rung"
        )
        fp = entry.get("fp8") or {}
        from ..core.precision import fp8_available

        if (
            int(bf.get("ok", 0)) >= config.min_samples()
            and int(fp.get("fail", 0)) == 0
            and config.fp8_allowed(sig.backend)
            and fp8_available()
        ):
            # The rung below: e4m3-rounded operands, f32 accumulation.
            # Earned only through a clean bf16 history at this key, and
            # retired by one recorded fp8 failure.
            d.compute_dtype = "float8_e4m3fn"
            d.reasons.append(
                f"fp8-first: {int(bf.get('ok', 0))} clean bf16 runs, no "
                "fp8 failure on record; guard certifies, f32 escalates"
            )
    return d
