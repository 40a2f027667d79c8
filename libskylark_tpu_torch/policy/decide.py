"""``choose_route``: the routing decision (port of the default decision
and the caller overrides of ``libskylark_tpu/policy/decide.py``).

The decision with nothing learned is the historical default: the sketch
route, FJLT for dense and CWT for sparse least squares (JLT for a dense
stream), sketch size ``min(4n, m)``, the input dtype.  A caller-pinned
``route``, ``sketch_type`` or ``sketch_size`` wins.  The JAX package
may deviate from the default once a profile entry has matured; the port
has no store yet (ROADMAP Queue A item 3b), so it never does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .profile import profile_key

__all__ = ["LS_ROUTES", "ProblemSignature", "Decision", "choose_route"]

# Valid least-squares routes, in escalation order of cost.
LS_ROUTES = ("sketch", "refine", "blendenpik", "lsrn", "exact")


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


def choose_route(sig: ProblemSignature, *, route: str | None = None,
                 sketch_type: str | None = None, sketch_size: int | None = None) -> Decision:
    """Decide (route, sketch family and size) for ``sig``: the default
    decision with the caller's pinned fields honored verbatim."""
    d = _default_decision(sig)
    if route is not None:
        d.route = route
        d.reasons.append("route pinned by caller")
    if sketch_type is not None:
        d.sketch_type = sketch_type
    if sketch_size is not None:
        d.sketch_size = int(sketch_size)
    return d
