"""Model and solve-system registry: load once, serve device-resident — live
(port of ``libskylark_tpu/serve/registry.py``).

The registry is the serve layer's "load amplification" half: a model's
weights (``ml/model.py`` JSON + binary sidecars) or an LS system's
factorization are loaded/computed ONCE at registration and every request
afterwards hits state resident on the registry's ``torch.device`` (the
card by default; a registry asked for ``cuda`` without one raises) — the
per-request cost is one padded batch through an already-captured plan.

- :class:`LSSystem` — a registered least-squares design matrix with its
  sketch and the QR factorization of ``S·A`` precomputed on the device:
  ``S·A`` through ``plans.apply`` and ``torch.linalg.qr``; serving a
  request is one COLUMNWISE sketch-apply of the coalesced RHS block plus
  one small triangular solve (sketch-and-solve).
- Models are the ``ml/model.py`` classes verbatim, their arrays moved
  to the registry's device at registration; ``load`` goes through the
  same polymorphic ``load_model`` the CLIs use.
- :class:`GraphSystem` — a graph with its ASE embedding: the SJLT
  adjacency sketch ``Ω·A`` (``graph.stream.incore_adjacency_sketch`` or
  the streamed fold, in torch's default float, which on the card takes
  the ``segment_sum_flat`` kernel) and ``ase_from_sketch``; the
  embedding itself is kept as host numpy.

**Live registries** (epoch discipline).  Sketches are linear, so a
registered entity can absorb updates without a re-register-the-world
restart:

- a :class:`GraphSystem` retains its SJLT ``Ω`` and the folded sketch
  ``SA = Ω·A``; new edge batches fold in through the same
  ``adjacency_sketch_fold`` scatter the streamed route uses and the
  embedding refreshes via ``ase_from_sketch`` — bitwise identical to
  re-registering the merged graph from scratch (adjacency entries are
  0/1 and SJLT values ±2⁻¹: every partial sum is exact dyadic);
- an :class:`LSSystem` registered with ``capacity > m`` takes row-append
  and row-downdate deltas: the sketch contribution of the touched rows
  (``S.apply_slice``) adds/subtracts into the retained ``S·A`` and only
  the small (s, n) QR re-runs (transforms without a columnwise slice
  rule, FJLT among them, refuse with ``UnsupportedError``);
- a model can be swapped wholesale, or a :class:`~..ml.model.KernelModel`
  can append/drop training centers.

Every update MINTS a registry epoch (one global counter; the updated
entity is stamped with it, the decision appended to ``epoch_log`` and
the telemetry ledger).  Updated versions are NEW objects — the
superseded version stays untouched, so in-flight batches pinned at
admission keep serving its exact bits; a request that pins
``registry_epoch`` to a retired version gets a structured code-116
:class:`~..utils.exceptions.RegistryEpochError` envelope.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import plans, telemetry
from .._device import resolve_device
from ..core.context import SketchContext
from ..ml.model import _dtype_name
from ..sketch import base as sketch_base
from ..utils.exceptions import (
    InvalidParameters,
    JournalError,
    UnsupportedError,
)
from .cache import ResultCache, payload_digest

__all__ = ["GraphSystem", "LSSystem", "Registry"]


def on_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or nested list) as a tensor on
    ``device``, cast to ``dtype`` when given; a tensor already there is
    not copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


class LSSystem:
    """A registered (A, S) pair with its sketched QR cached on the device.

    ``capacity`` (optional) sizes the sketch domain BEYOND the live row
    count: rows [m, capacity) are virtual zeros, so the registered
    factorization is unchanged math, and later ``appended`` rows land
    in reserved sketch-domain positions (the counter-addressed hash of
    a row depends only on its absolute index, so pre-sizing the domain
    is what makes append deltas exact).  Without it the system is
    frozen exactly as before.
    """

    def __init__(self, name: str, A, S, *, capacity: int | None = None,
                 retired=frozenset(), device=None):
        self.name = name
        self.A = on_device(A, resolve_device(device))
        if self.A.ndim != 2:
            raise InvalidParameters(
                f"system {name!r}: A must be 2-D, got shape {tuple(self.A.shape)}"
            )
        self.m, self.n = (int(d) for d in self.A.shape)
        self.capacity = int(capacity) if capacity else self.m
        if self.capacity < self.m:
            raise InvalidParameters(
                f"system {name!r}: capacity {self.capacity} < A rows "
                f"{self.m}"
            )
        if S.n != self.capacity:
            raise InvalidParameters(
                f"system {name!r}: sketch domain {S.n} != row capacity "
                f"{self.capacity}"
            )
        self.S = S
        self.dtype = self.A.dtype
        self.retired = frozenset(int(i) for i in retired)
        self.epoch = 0  # stamped by Registry._mint
        if self.capacity == self.m:
            SA = plans.apply(S, self.A, "columnwise")
        else:
            Ap = self.A.new_zeros((self.capacity, self.n))
            Ap[: self.m] = self.A
            SA = plans.apply(S, Ap, "columnwise")
        self._set_sa(SA)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _set_sa(self, SA) -> None:
        self.SA = SA
        Q, R = torch.linalg.qr(SA)
        # Stored transposed: the per-batch solve consumes Qᵀ directly.
        self.Qt = Q.T.contiguous()
        self.R = R

    def _successor(self) -> "LSSystem":
        new = object.__new__(LSSystem)
        new.name, new.n, new.S = self.name, self.n, self.S
        new.capacity, new.dtype = self.capacity, self.dtype
        new.retired, new.epoch, new.m = self.retired, self.epoch, self.m
        return new

    # -- live deltas (return NEW versions; self stays frozen) ---------------

    def appended(self, rows) -> "LSSystem":
        """New version with ``rows`` appended at [m, m+r).

        The delta is ``S.apply_slice(rows, m)`` — the exact sketch
        contribution of those row positions — added into the retained
        ``S·A``; only the (s, n) QR re-runs.  Needs reserved capacity.
        """
        rows = on_device(rows, self.device, self.dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or int(rows.shape[1]) != self.n:
            raise InvalidParameters(
                f"system {self.name!r}: appended rows must be (r, {self.n})"
                f", got shape {tuple(rows.shape)}"
            )
        r = int(rows.shape[0])
        if self.m + r > self.capacity:
            raise InvalidParameters(
                f"system {self.name!r}: append of {r} rows exceeds "
                f"capacity {self.capacity} (live rows {self.m}); register "
                "with a larger capacity="
            )
        new = self._successor()
        new.A = torch.cat([self.A, rows], dim=0)
        new.m = self.m + r
        new._set_sa(self.SA + self.S.apply_slice(rows, self.m, "columnwise"))
        return new

    def downdated(self, indices) -> "LSSystem":
        """New version with the given live rows RETIRED: their sketch
        contribution is subtracted from the retained ``S·A`` and the
        rows zeroed in place (positions are kept so later appends stay
        addressable; the server zeroes the matching ``b`` entries at
        validation so retired rows drop out of the solve exactly)."""
        idx = sorted({int(i) for i in indices})
        for i in idx:
            if not (0 <= i < self.m):
                raise InvalidParameters(
                    f"system {self.name!r}: downdate index {i} outside "
                    f"[0, {self.m})"
                )
            if i in self.retired:
                raise InvalidParameters(
                    f"system {self.name!r}: row {i} is already retired"
                )
        new = self._successor()
        new.retired = self.retired | frozenset(idx)
        SA = self.SA
        A = self.A.clone()
        for i in idx:
            SA = SA - self.S.apply_slice(self.A[i : i + 1], i, "columnwise")
            A[i] = 0.0
        new.A = A
        new._set_sa(SA)
        return new

    def describe(self) -> dict:
        return {
            "shape": [self.m, self.n],
            "dtype": _dtype_name(self.dtype),
            "sketch": type(self.S).__name__,
            "sketch_size": int(self.S.s),
            "capacity": self.capacity,
            "retired": len(self.retired),
            "epoch": self.epoch,
        }

    def cond_report(self, cache: "ResultCache | None" = None) -> dict:
        """Condition / effective-rank report of the sketched system,
        probed ONCE and cached: R from QR(S·A) carries S·A's singular
        values, so the probe is a short-budget ``cond_est`` on R plus one
        small SVD for the effective rank — the full (m, n) A is never
        touched.  Coalesced ``cond_est`` requests for the same placement
        key all fan out this one dict.

        The memo lives in the shared bounded :class:`ResultCache` when
        one is passed (epoch-keyed); the per-object ``_cond_report``
        attribute is the cacheless fallback (new versions never copy it).
        """
        ck = ("cond:" + self.name, 0, self.epoch) if cache is not None \
            else None
        if cache is not None:
            rep = cache.get(ck)
            if rep is not None:
                return rep
        rep = getattr(self, "_cond_report", None)
        if rep is None:
            from ..solvers.cond_est import CondEstParams, cond_est

            r = cond_est(
                self.R,
                SketchContext(seed=0x5EED),
                CondEstParams(iter_lim=60, powerits=25),
            )
            sv = torch.linalg.svdvals(self.R).cpu().numpy()
            cutoff = float(np.finfo(sv.dtype).eps) * self.n * float(sv[0])
            cond, smax, smin = (float(v) for v in torch.stack(
                [r.cond, r.sigma_max, r.sigma_min]).tolist())
            rep = self._cond_report = {
                "system": self.name,
                "cond": cond,
                "sigma_max": smax,
                "sigma_min": smin,
                "effective_rank": int((sv > cutoff).sum()),
                "n": self.n,
                "sketch_size": int(self.S.s),
                "epoch": self.epoch,
            }
        if cache is not None:
            cache.put(ck, rep, entity=self.name)
        return rep


class GraphSystem:
    """A registered graph with its ASE embedding resident — and live.

    The heavy work runs ONCE at registration, on the registry's device;
    every served query afterwards is a host-array lookup (``ase_embed``)
    or a memoized active-support diffusion (``ppr``).  The embedding is
    kept as host numpy: graph queries are small-row traffic.

    The embedding route is the streaming eigensolve's: an SJLT ``Ω``
    drawn once from the registration context, the folded sketch
    ``SA = Ω·A`` (in-core sparse apply, bitwise the streamed edge-block
    fold) in torch's default float, and ``ase_from_sketch``'s small
    math.  Both ``Ω`` and ``SA`` are RETAINED, which is what makes the
    system live: :meth:`folded` absorbs an edge batch by one delta fold
    plus the small-math refresh.  ``params.num_iterations > 0`` opts
    into the subspace-iterated ``approximate_ase`` route — frozen (no
    fold state is retained).
    """

    def __init__(self, name: str, G, *, k: int = 8, context=None,
                 params=None, device=None):
        from ..graph.ase import ASEParams
        from ..graph.graph import SimpleGraph

        if not isinstance(G, SimpleGraph):
            raise InvalidParameters(
                f"graph {name!r}: register a SimpleGraph, got "
                f"{type(G).__name__}"
            )
        if not (1 <= int(k) <= max(G.n, 1)):
            raise InvalidParameters(
                f"graph {name!r}: embedding rank {k} outside [1, {G.n}]"
            )
        dev = resolve_device(device)
        self.name = name
        self.G = G
        self.k = int(k)
        context = context if context is not None else SketchContext(
            seed=0x5EED
        )
        params = params or ASEParams()
        self.epoch = 0  # stamped by Registry._mint
        self._streamed = bool(getattr(params, "streamed", False))

        if getattr(params, "num_iterations", 0):
            from ..graph.ase import approximate_ase

            X, lam = approximate_ase(G, self.k, context, params, device=dev)
            self._S = None
            self._sa = None
        else:
            from ..graph.stream import (
                ase_from_sketch,
                graph_block_source,
                incore_adjacency_sketch,
                streamed_adjacency_sketch,
            )
            from ..linalg.svd import _sketch_size
            from ..sketch.hash import SJLT

            k_, s = _sketch_size(self.k, params, G.n)
            self._S = SJLT(G.n, s, context)
            if self._streamed:
                from ..streaming.engine import StreamParams
                from ..streaming.pipeline import pinned_placer

                self._sa = streamed_adjacency_sketch(
                    graph_block_source(
                        G, batch_edges=getattr(params, "batch_edges", 65536)
                    ),
                    self._S, ncols=G.n, dtype=torch.get_default_dtype(),
                    params=StreamParams(placer=pinned_placer(dev)),
                )
            else:
                self._sa = incore_adjacency_sketch(G, self._S, device=dev)
            V, lam = ase_from_sketch(self._sa, self._S, k_)
            X = V * torch.sqrt(lam.abs())[None, :]
        self.X = X.cpu().numpy()
        self.lam = lam.cpu().numpy()
        self._ppr_reports: dict[tuple, dict] = {}

    # -- live edge folds (return NEW versions; self stays frozen) -----------

    def folded(self, pairs) -> tuple["GraphSystem", int]:
        """New version absorbing an edge batch; returns ``(gsys, r)``
        with ``r`` the count of genuinely-new undirected edges folded.

        One ``adjacency_sketch_fold`` step over the delta block (the
        same scatter the streamed registration route uses) plus the
        ``ase_from_sketch`` refresh — O(Δedges + s·n) work, and bitwise
        ≡ registering the merged graph from scratch."""
        if self._S is None:
            raise UnsupportedError(
                f"graph {self.name!r} was registered through the "
                "subspace-iterated route (num_iterations > 0); live edge "
                "folds need the retained-sketch route (num_iterations=0)"
            )
        from ..graph.stream import adjacency_sketch_fold, ase_from_sketch

        try:
            G2, fresh = self.G.with_edges(pairs)
        except KeyError as e:
            raise InvalidParameters(str(e)) from None
        new = object.__new__(GraphSystem)
        new.name, new.k, new.G = self.name, self.k, G2
        new._S, new._streamed = self._S, self._streamed
        new.epoch = self.epoch
        if fresh.size:
            _, step = adjacency_sketch_fold(
                self._S, self.G.n, self._sa.dtype, device=self._sa.device
            )
            acc = step(
                {"sa": self._sa, "edge": np.asarray(0, np.int64)},
                {
                    "rows": np.concatenate([fresh[:, 0], fresh[:, 1]]),
                    "cols": np.concatenate([fresh[:, 1], fresh[:, 0]]),
                    "vals": np.ones(2 * fresh.shape[0], np.float64),
                },
                0,
            )
            new._sa = acc["sa"]
            V, lam = ase_from_sketch(new._sa, self._S, self.k)
            new.X = (V * torch.sqrt(lam.abs())[None, :]).cpu().numpy()
            new.lam = lam.cpu().numpy()
        else:
            new._sa = self._sa
            new.X, new.lam = self.X, self.lam
        # The graph changed: cached diffusions belong to the old version.
        new._ppr_reports = {}
        return new, int(fresh.shape[0])

    def describe(self) -> dict:
        return {
            "n": int(self.G.n),
            "volume": int(self.G.volume),
            "k": self.k,
            "streamed": self._streamed,
            "epoch": self.epoch,
        }

    def rows(self, idx) -> np.ndarray:
        """Embedding rows for vertex ids (the ``ase_embed`` lookup)."""
        return self.X[idx]

    def project(self, neighbor_ids) -> np.ndarray:
        """Out-of-sample projection from a neighbor id list.

        For ``A = V Λ Vᵀ`` and a new vertex whose adjacency row is
        ``a``, the ASE position is ``x̂_c = (Σ_{j∈nb} X[j,c]) / λ_c``
        — for an existing vertex's own neighbor list this reproduces
        its embedding row exactly.  Components with |λ| at the spectral
        floor contribute zero rather than a division blow-up.
        """
        s = self.X[np.asarray(neighbor_ids, np.int64)].sum(axis=0)
        floor = np.abs(self.lam).max(initial=0.0) * np.finfo(
            self.lam.dtype
        ).eps * max(self.G.n, 1)
        safe = np.abs(self.lam) > floor
        return np.divide(
            s, self.lam, out=np.zeros_like(s), where=safe
        )

    def ppr_report(self, payload: tuple,
                   cache: "ResultCache | None" = None) -> dict:
        """Seed-set PPR community report, memoized by the canonical
        payload ``(sorted-unique seed ids, alpha, gamma, epsilon)`` the
        server validated — coalesced riders with the same seed set share
        one diffusion.  The solve is ``find_local_cluster``'s
        active-support diffusion on the host: work scales with the
        cluster found, not with the graph held.  The memo lives in the
        shared :class:`ResultCache` when one is passed (keyed on the
        payload digest and this version's epoch), else in the
        per-object dict (``folded`` resets it)."""
        ck = ("ppr:" + self.name, payload_digest(payload), self.epoch) \
            if cache is not None else None
        if cache is not None:
            rep = cache.get(ck)
            if rep is not None:
                return rep
        rep = self._ppr_reports.get(payload)
        if rep is None:
            from ..graph.community import find_local_cluster

            seeds, alpha, gamma, epsilon = payload
            cluster, cond = find_local_cluster(
                self.G, list(seeds),
                alpha=alpha, gamma=gamma, epsilon=epsilon,
            )
            rep = self._ppr_reports[payload] = {
                "graph": self.name,
                "seeds": [int(v) for v in seeds],
                "cluster": sorted(int(v) for v in cluster),
                "conductance": float(cond),
                "alpha": float(alpha),
                "gamma": float(gamma),
                "epsilon": float(epsilon),
            }
        if cache is not None:
            cache.put(ck, rep, entity=self.name)
        return rep


def _model_to(model, device: torch.device):
    """Move a ``ml.model`` model's arrays to ``device`` in place (the
    registry owns what it serves)."""
    for attr in ("W", "X_train", "A"):
        t = getattr(model, attr, None)
        if isinstance(t, torch.Tensor) and t.device != device:
            setattr(model, attr, t.to(device))
    return model


class Registry:
    def __init__(self, cache: ResultCache | None = None, journal=None, *,
                 device=None):
        # Where registered state lives: the card unless the caller asks
        # for the CPU (a registry asked for cuda without one raises).
        self.device = resolve_device(device)
        self.models: dict[str, object] = {}
        self.systems: dict[str, LSSystem] = {}
        self.graphs: dict[str, GraphSystem] = {}
        # The shared bounded result cache: the front door's response
        # cache AND the cond/ppr report memo are this one instance.
        # Invalidation rides _mint below.
        self.cache = cache if cache is not None else ResultCache()
        # One monotone counter over ALL mutations; each current version
        # object carries the epoch it was minted at.
        self.epoch = 0
        self.epoch_log: list[dict] = []
        self._lock = threading.RLock()
        # Optional serve/journal.py Journal: every mutation appends its
        # CRC-framed record (and fsyncs) BEFORE publishing; _replaying
        # suspends journaling while recover() re-executes the records.
        self.journal = journal
        self._replaying = False
        # Bounded idempotency-receipt window for exactly-once updates:
        # (tenant, idem_key) -> the minted epoch receipt (journal-backed).
        self._idem: OrderedDict[tuple[str, str], dict] = OrderedDict()
        self._idem_window = int(os.environ.get("SKYLARK_IDEM_WINDOW", "1024"))

    def _mint(self, kind: str, name: str, obj=None, **attrs) -> dict:
        with self._lock:
            self.epoch += 1
            epoch = self.epoch
            if obj is not None:
                try:
                    obj.epoch = epoch
                except AttributeError:  # exotic model classes with slots
                    pass
            rec = {"epoch": epoch, "kind": kind, "name": name, **attrs}
            self.epoch_log.append(rec)
        # Free the retired entity's cached results now; the epoch in
        # every cache key already makes the next request miss.
        self.cache.invalidate(name)
        telemetry.inc("registry.epoch.bumps")
        telemetry.inc(f"registry.epoch.{kind}")
        telemetry.event("registry", "epoch", rec)
        return rec

    # -- durability ---------------------------------------------------------

    def _journal_active(self) -> bool:
        return self.journal is not None and not self._replaying

    def _journal_append(self, kind, name, payload, attrs, idem=None):
        """Durably append the mutation's record BEFORE it publishes.
        Callers hold ``self._lock``, so ``epoch + 1`` is exactly the
        epoch ``_mint`` will stamp right after the publish."""
        rec = {
            "epoch": self.epoch + 1,
            "kind": kind,
            "name": name,
            "attrs": attrs,
            "payload": payload,
        }
        if idem is not None:
            rec["idem"] = [str(idem[0]), str(idem[1])]
        self.journal.append(rec)

    def _maybe_compact(self) -> None:
        j = self.journal
        if j is None or self._replaying or not j.due():
            return
        from .journal import snapshot_registry

        leaves, meta = snapshot_registry(self)
        j.compact(leaves, meta, step=self.epoch)

    def _record_idem(self, idem, rec) -> None:
        if idem is None:
            return
        key = (str(idem[0]), str(idem[1]))
        with self._lock:
            self._idem[key] = dict(rec)
            self._idem.move_to_end(key)
            while len(self._idem) > self._idem_window:
                self._idem.popitem(last=False)

    def idem_receipt(self, tenant, key):
        """The recorded epoch receipt for ``(tenant, key)``, or ``None``
        — the dedup lookup the server makes before admitting an
        ``op:"update"`` that carries an idempotency key."""
        with self._lock:
            rec = self._idem.get((str(tenant), str(key)))
            return dict(rec) if rec is not None else None

    @classmethod
    def recover(cls, directory, *, cache: ResultCache | None = None,
                compact_every=None, keep_snapshots: int = 2,
                device=None) -> "Registry":
        """Rebuild a registry from its durable state directory (written
        by either package): restore the newest valid compaction snapshot
        (field-copy, no recompute), then replay the journal tail through
        the SAME mutator code paths that minted it — the result is
        bitwise-identical to the never-crashed registry (entity bits,
        epoch counter, epoch_log, idempotency window).  A torn final
        journal line is truncated and counted; mid-journal corruption,
        epoch gaps, or a replay that mints a different record than the
        journal holds raise :class:`~..utils.exceptions.JournalError`
        (118).  The returned registry keeps journaling from the exact
        epoch it died at."""
        from .journal import REPLAY_HANDLERS, Journal, read_journal, \
            restore_registry

        journal = Journal(directory, compact_every=compact_every,
                          keep_snapshots=keep_snapshots)
        reg = cls(cache=cache, journal=journal, device=device)
        reg._replaying = True
        try:
            snap_epoch = 0
            snap = journal.load_snapshot()
            if snap is not None:
                leaves, meta = snap
                restore_registry(reg, leaves, meta)
                snap_epoch = reg.epoch
            # Journal.__init__ already truncated any torn tail.
            records, _ = read_journal(journal.path)
            replayed = 0
            for rec in records:
                if rec["epoch"] <= snap_epoch:
                    # Folded into the snapshot already (a crash between
                    # snapshot commit and journal truncation).
                    continue
                if rec["epoch"] != reg.epoch + 1:
                    raise JournalError(
                        f"journal epoch gap: record minted at epoch "
                        f"{rec['epoch']} follows registry epoch "
                        f"{reg.epoch}",
                        path=journal.path, reason="epoch-gap",
                    )
                handler = REPLAY_HANDLERS.get(rec["kind"])
                if handler is None:
                    raise JournalError(
                        f"journal record kind {rec['kind']!r} has no "
                        "replay handler",
                        path=journal.path, reason="unknown-kind",
                    )
                handler(reg, rec)
                minted = reg.epoch_log[-1]
                expect = {"epoch": rec["epoch"], "kind": rec["kind"],
                          "name": rec["name"], **rec["attrs"]}
                if minted != expect:
                    raise JournalError(
                        f"replay divergence at epoch {rec['epoch']}: "
                        f"replay minted {minted!r} but the journal "
                        f"recorded {expect!r}",
                        path=journal.path, reason="replay-divergence",
                    )
                replayed += 1
                telemetry.inc("journal.replays")
            telemetry.event("journal", "recover", {
                "dir": str(directory),
                "epoch": reg.epoch,
                "snapshot_epoch": snap_epoch,
                "replayed": replayed,
                "torn_truncated": journal.torn_truncated,
            })
        finally:
            reg._replaying = False
        return reg

    # -- models -------------------------------------------------------------

    def register_model(self, name: str, model) -> None:
        if not hasattr(model, "predict"):
            raise InvalidParameters(
                f"model {name!r} has no predict(); got {type(model).__name__}"
            )
        model = _model_to(model, self.device)
        with self._lock:
            if self._journal_active():
                from .journal import _enc_array, encode_model

                self._journal_append(
                    "register", name, encode_model(model, _enc_array),
                    {"entity": "model"},
                )
            self.models[name] = model
            self._mint("register", name, model, entity="model")
            self._maybe_compact()

    def load_model(self, name: str, path: str):
        """Load a saved ``ml/model.py`` JSON model once; serve forever."""
        from ..ml.model import load_model

        model = load_model(path, device=self.device)
        self.register_model(name, model)
        return model

    def update_model(self, name: str, model=None, *, append=None,
                     drop=None, idem=None):
        """Live model update: swap wholesale (``model=``), or for a
        :class:`~..ml.model.KernelModel` append/drop training centers —
        predict is linear in the center rows, so the delta is exact
        concatenation/deletion.  Mints an epoch; the superseded model
        object is untouched (in-flight batches keep its bits)."""
        old = self.get_model(name)
        if sum(x is not None for x in (model, append, drop)) != 1:
            raise InvalidParameters(
                "update_model takes exactly one of model=, append=, drop="
            )
        if model is None:
            from ..ml.model import KernelModel

            if not isinstance(old, KernelModel):
                raise UnsupportedError(
                    f"model {name!r} ({type(old).__name__}) supports only "
                    "wholesale swap (model=); center deltas need a "
                    "KernelModel"
                )
            X_tr, A = old.X_train, old.A
            if append is not None:
                X_new, A_new = append
                X_new = on_device(X_new, X_tr.device, X_tr.dtype)
                if X_new.ndim < 2:
                    X_new = X_new.reshape(1, -1)
                A_new = on_device(A_new, A.device, A.dtype).reshape(
                    X_new.shape[0], *A.shape[1:]
                )
                X_tr = torch.cat([X_tr, X_new])
                A = torch.cat([A, A_new])
                delta = {"appended": int(X_new.shape[0])}
                # The NORMALIZED delta (post dtype-cast/reshape) is the
                # canonical journal payload: replay re-runs this exact
                # concatenation on identical bits.
                journal_payload = lambda enc: {  # noqa: E731
                    "append_X": enc(X_new), "append_A": enc(A_new),
                }
            else:
                keep = np.setdiff1d(
                    np.arange(X_tr.shape[0]), np.asarray(drop, np.int64)
                )
                dropped = int(X_tr.shape[0]) - int(keep.shape[0])
                keep_t = torch.as_tensor(keep, device=X_tr.device)
                X_tr, A = X_tr[keep_t], A[keep_t]
                delta = {"dropped": dropped}
                drop_ids = [int(i) for i in np.asarray(drop, np.int64)]
                journal_payload = lambda enc: {"drop": drop_ids}  # noqa: E731
            model = KernelModel(old.kernel, X_tr, A, classes=old.classes)
        elif not hasattr(model, "predict"):
            raise InvalidParameters(
                f"model {name!r} update has no predict(); got "
                f"{type(model).__name__}"
            )
        else:
            model = _model_to(model, self.device)
            delta = {"swapped": True}
            swapped = model

            def journal_payload(enc):
                from .journal import encode_model

                return {"model": encode_model(swapped, enc)}
        with self._lock:
            if self._journal_active():
                from .journal import _enc_array

                self._journal_append(
                    "model_update", name, journal_payload(_enc_array),
                    dict(delta), idem=idem,
                )
            self.models[name] = model
            rec = self._mint("model_update", name, model, **delta)
            self._record_idem(idem, rec)
            self._maybe_compact()
        return model, rec

    def get_model(self, name: str):
        try:
            return self.models[name]
        except KeyError:
            raise InvalidParameters(
                f"unknown model {name!r}; registered: {sorted(self.models)}"
            ) from None

    # -- LS systems ---------------------------------------------------------

    def register_system(
        self,
        name: str,
        A,
        *,
        context: SketchContext,
        sketch=None,
        sketch_type: str = "FJLT",
        sketch_size: int | None = None,
        capacity: int | None = None,
    ) -> LSSystem:
        """Register a least-squares design matrix (moved to the
        registry's device; a tensor already there is not copied).

        ``sketch`` may be a live transform, a serialized-sketch JSON
        string, or a dict; absent, a fresh ``sketch_type`` transform is
        drawn from ``context``.  ``capacity`` reserves sketch-domain rows
        beyond ``A``'s for later live appends.
        """
        A = on_device(A, self.device)
        m = int(A.shape[0])
        dom = int(capacity) if capacity else m
        if isinstance(sketch, str):
            sketch = sketch_base.from_json(sketch)
        elif isinstance(sketch, dict):
            sketch = sketch_base.from_dict(sketch)
        if sketch is None:
            n = int(A.shape[1]) if A.ndim == 2 else 1
            s = int(sketch_size or min(m, max(4 * n, n + 16)))
            sketch = sketch_base.create_sketch(sketch_type, dom, s, context)
        system = LSSystem(name, A, sketch, capacity=capacity, device=self.device)
        with self._lock:
            if self._journal_active():
                from .journal import _enc_array, encode_system

                self._journal_append(
                    "register", name, encode_system(system, _enc_array),
                    {"entity": "system"},
                )
            self.systems[name] = system
            self._mint("register", name, system, entity="system")
            self._maybe_compact()
        return system

    def append_system_rows(self, name: str, rows,
                           idem=None) -> tuple[LSSystem, dict]:
        """Live row append: publish a NEW version with ``rows`` folded
        into the retained ``S·A`` (exact ``apply_slice`` delta), mint an
        epoch, and leave the superseded version's bits untouched."""
        with self._lock:
            old = self.get_system(name)
            new = old.appended(rows)
            if self._journal_active():
                from .journal import _enc_array

                # The rows as the new version holds them (post cast):
                # the exact bits replay will append.
                self._journal_append(
                    "row_append", name,
                    {"rows": _enc_array(new.A[old.m:new.m])},
                    {"rows": int(new.m - old.m), "m": new.m}, idem=idem,
                )
            self.systems[name] = new
            rec = self._mint(
                "row_append", name, new,
                rows=int(new.m - old.m), m=new.m,
            )
            self._record_idem(idem, rec)
            self._maybe_compact()
        return new, rec

    def downdate_system_rows(self, name: str, indices,
                             idem=None) -> tuple[LSSystem, dict]:
        """Live row downdate (retirement): the mirror of append —
        subtract the rows' sketch contribution, re-QR, mint an epoch."""
        with self._lock:
            old = self.get_system(name)
            new = old.downdated(indices)
            if self._journal_active():
                self._journal_append(
                    "row_downdate", name,
                    {"drop": sorted({int(i) for i in indices})},
                    {"rows": len(new.retired) - len(old.retired),
                     "retired": len(new.retired)}, idem=idem,
                )
            self.systems[name] = new
            rec = self._mint(
                "row_downdate", name, new,
                rows=len(new.retired) - len(old.retired),
                retired=len(new.retired),
            )
            self._record_idem(idem, rec)
            self._maybe_compact()
        return new, rec

    def get_system(self, name: str) -> LSSystem:
        try:
            return self.systems[name]
        except KeyError:
            raise InvalidParameters(
                f"unknown system {name!r}; registered: {sorted(self.systems)}"
            ) from None

    # -- graphs -------------------------------------------------------------

    def register_graph(
        self,
        name: str,
        G,
        *,
        k: int = 8,
        context: SketchContext | None = None,
        params=None,
    ) -> GraphSystem:
        """Register a graph: the ASE embedding is computed here, once,
        on the registry's device, through the retained-sketch route (so
        the system is live — :meth:`fold_graph_edges`)."""
        gsys = GraphSystem(name, G, k=k, context=context, params=params,
                           device=self.device)
        with self._lock:
            if self._journal_active():
                from .journal import _enc_array, encode_graph

                self._journal_append(
                    "register", name, encode_graph(gsys, _enc_array),
                    {"entity": "graph"},
                )
            self.graphs[name] = gsys
            self._mint("register", name, gsys, entity="graph")
            self._maybe_compact()
        return gsys

    def fold_graph_edges(self, name: str, pairs,
                         idem=None) -> tuple[GraphSystem, dict]:
        """Live edge fold: publish a NEW version whose retained ``Ω·A``
        absorbed the batch, mint an epoch.  In-flight batches pinned to
        the old version keep its exact bits."""
        pairs = [(u, v) for u, v in pairs]
        with self._lock:
            old = self.get_graph(name)
            new, folded = old.folded(pairs)
            if self._journal_active():
                from .journal import _json_vertex

                self._journal_append(
                    "graph_fold", name,
                    {"edges": [[_json_vertex(u), _json_vertex(v)]
                               for u, v in pairs]},
                    {"edges": folded, "volume": int(new.G.volume)},
                    idem=idem,
                )
            self.graphs[name] = new
            rec = self._mint(
                "graph_fold", name, new,
                edges=folded, volume=int(new.G.volume),
            )
            self._record_idem(idem, rec)
            self._maybe_compact()
        return new, rec

    def get_graph(self, name: str) -> GraphSystem:
        try:
            return self.graphs[name]
        except KeyError:
            raise InvalidParameters(
                f"unknown graph {name!r}; registered: {sorted(self.graphs)}"
            ) from None

    def describe(self) -> dict:
        models = {}
        for name, model in self.models.items():
            models[name] = {
                "kind": type(model).__name__,
                "input_dim": getattr(model, "input_dim", None),
                "classes": getattr(model, "classes", None) is not None,
                "epoch": getattr(model, "epoch", 0),
            }
        return {
            "models": models,
            "systems": {k: s.describe() for k, s in self.systems.items()},
            "graphs": {k: g.describe() for k, g in self.graphs.items()},
            "epoch": self.epoch,
        }
