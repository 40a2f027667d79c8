"""Write-ahead journal for the serve registry — durable serve state (port
of ``libskylark_tpu/serve/journal.py``, in its file format: a state
directory written by either package recovers in the other).

The live registry made the serve plane mutable; this module makes
those mutations survive the process.  Every :meth:`Registry._mint` kind
(``register``, ``graph_fold``, ``row_append``, ``row_downdate``,
``model_update``) appends one CRC-framed, epoch-stamped JSONL record to
``<dir>/registry-journal.jsonl`` *before* the mutation publishes, riding
the same fsync-file-then-directory discipline ``utils/checkpoint.py``
uses for solver state.  A record's payload is the canonical update delta
(ndarrays inline via the dtype-faithful ``model.save`` encoding: dtype
name + shape + raw bytes), so replaying the journal re-executes the
exact deterministic code paths the live registry ran — the recovered
registry is **bitwise identical** to the never-crashed one: same entity
bits, same epoch counter, same ``epoch_log``.

Crash model and the two failure classes it separates:

- a **torn final line** is what a SIGKILL mid-append legitimately
  leaves.  Recovery truncates it, counts it (``journal.torn_tail``),
  and continues — exactly the tolerance ``read_progress`` extends to a
  torn elastic ledger.
- **mid-file damage** — a CRC-bad record with valid records after it,
  or an epoch gap between consecutive records — cannot be produced by
  the crash model and means the journal is not trustworthy: code-118
  :class:`~..utils.exceptions.JournalError`, never a silent partial
  replay.

Periodic **compaction** folds the journal into a
:class:`~..utils.checkpoint.CheckpointStore` snapshot slot
(``registry-snap-<epoch>.npz``) holding every entity's exact bits
(including the factorizations, so restore is a field copy — no re-QR,
no re-sketch) plus the epoch counter, ``epoch_log``, and the
idempotency-receipt window; the journal then truncates, so recovery
cost is one snapshot load plus the tail since the last compaction.

The **idempotency window** rides the journal: update records may carry
an ``idem`` pair ``(tenant, key)``; the registry records the minted
epoch receipt under it, and both snapshot and replay restore the
window — a failover-replayed update after a crash still returns the
original receipt instead of double-applying.
"""

from __future__ import annotations

import base64
import json
import os
import zlib

import numpy as np
import torch

from .. import telemetry
from ..ml.model import _dtype_name, _json_info
from ..sketch import base as sketch_base
from ..utils.checkpoint import CheckpointStore, _fsync_dir
from ..utils.exceptions import JournalError

__all__ = [
    "Journal",
    "JournalError",
    "RECORD_KINDS",
    "REPLAY_HANDLERS",
    "read_journal",
    "scan_journal",
]

JOURNAL_NAME = "registry-journal.jsonl"
SNAP_PREFIX = "registry-snap"


# -- framing ----------------------------------------------------------------


def _canon(rec) -> str:
    """Canonical JSON image of a record: sorted keys, no whitespace.
    ``json.dumps(json.loads(x))`` is a fixed point of this form, so the
    CRC computed at write time is recomputable from the parsed record."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _frame(rec) -> str:
    body = _canon(rec)
    return '{"crc": %d, "rec": %s}' % (zlib.crc32(body.encode()), body)


def _parse_frame(line: bytes):
    """Parsed record, or ``None`` when the line fails any integrity
    check (unparseable, wrong shape, CRC mismatch)."""
    try:
        obj = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None
    if not isinstance(obj, dict):
        return None
    rec, crc = obj.get("rec"), obj.get("crc")
    if not isinstance(rec, dict) or not isinstance(crc, int):
        return None
    if zlib.crc32(_canon(rec).encode()) != crc:
        return None
    if not isinstance(rec.get("epoch"), int) or not isinstance(
        rec.get("kind"), str
    ):
        return None
    return rec


def scan_journal(path):
    """Validate a journal file; returns ``(records, torn, valid_end)``.

    ``torn`` counts the CRC-bad/unparseable FINAL line (0 or 1) and
    ``valid_end`` is the byte offset the file should be truncated to so
    later appends extend a clean prefix.  A bad record with valid
    records after it — damage the crash model cannot explain — raises
    :class:`JournalError` (code 118)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return [], 0, 0
    pos = 0
    entries = []  # (1-based line number, byte offset, line)
    for i, ln in enumerate(raw.split(b"\n")):
        entries.append((i + 1, pos, ln))
        pos += len(ln) + 1
    nonempty = [e for e in entries if e[2].strip()]
    records = []
    valid_end = 0
    for j, (no, start, ln) in enumerate(nonempty):
        rec = _parse_frame(ln)
        if rec is None:
            if j == len(nonempty) - 1:
                return records, 1, start
            raise JournalError(
                f"{path}: corrupt journal record at line {no} with valid "
                "records after it — this is damage beyond a torn tail, "
                "refusing a silent partial replay",
                path=str(path), record=no, reason="crc",
            )
        records.append(rec)
        valid_end = min(start + len(ln) + 1, len(raw))
    return records, 0, valid_end if records else len(raw)


def read_journal(path):
    """``(records, torn)`` — the torn-tail-tolerant journal reader.
    Mid-file corruption raises :class:`JournalError` (118)."""
    records, torn, _ = scan_journal(path)
    return records, torn


# -- ndarray codec (the dtype-faithful ``model.save`` encoding) -------------


# Integer views of the dtypes numpy lacks (their raw bytes ride as these).
_RAW_VIEWS = {2: (np.int16, torch.int16), 1: (np.uint8, torch.uint8)}


def _raw(dtype: torch.dtype) -> bool:
    """bfloat16 and the fp8 types: numpy (without ``ml_dtypes``) has no
    such dtype, so their bits travel as an integer view."""
    return dtype.is_floating_point and dtype.itemsize <= 2 and dtype != torch.float16


def _host_bytes(a) -> tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a tensor or array, as the JAX
    package's ``ml_dtypes`` arrays store them."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        name = _dtype_name(t.dtype)
        if _raw(t.dtype):
            t = t.view(_RAW_VIEWS[t.dtype.itemsize][1])
        return name, list(t.shape), t.numpy().tobytes()
    a = np.asarray(a)
    return str(a.dtype), list(a.shape), np.ascontiguousarray(a).tobytes()


def _enc_array(a) -> dict:
    name, shape, data = _host_bytes(a)
    return {
        "__ndarray__": True,
        "dtype": name,
        "shape": [int(d) for d in shape],
        "data": base64.b64encode(data).decode("ascii"),
    }


def _dec_array(d) -> torch.Tensor:
    """The encoded array as a CPU tensor of its recorded dtype."""
    name = d["dtype"]
    buf = base64.b64decode(d["data"])
    shape = [int(x) for x in d["shape"]]
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype) and _raw(dt):
        raw = np.frombuffer(buf, _RAW_VIEWS[dt.itemsize][0]).copy()
        return torch.from_numpy(raw).view(dt).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(name)).copy().reshape(shape))


def _host(x) -> np.ndarray:
    """A decoded leaf as host numpy (graph CSR arrays, embeddings)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- entity codecs (shared by journal records and snapshot slots) -----------
#
# ``enc``/``dec`` abstract the array channel: journal records inline the
# bytes (base64) so each line is self-contained; snapshots park arrays as
# npz leaves (dtype-faithful via leaf_dtypes) and reference them by index.


def encode_system(system, enc) -> dict:
    return {
        "entity": "system",
        "sketch": json.loads(system.S.to_json()),
        "capacity": int(system.capacity),
        "m": int(system.m),
        "n": int(system.n),
        "retired": sorted(int(i) for i in system.retired),
        "epoch": int(system.epoch),
        "A": enc(system.A),
        "SA": enc(system.SA),
        "Qt": enc(system.Qt),
        "R": enc(system.R),
    }


def decode_system(name, d, dec, device=None):
    from .registry import LSSystem, on_device

    s = object.__new__(LSSystem)
    s.name = name
    s.S = sketch_base.from_dict(d["sketch"])
    s.capacity = int(d["capacity"])
    s.m, s.n = int(d["m"]), int(d["n"])
    s.retired = frozenset(int(i) for i in d["retired"])
    s.epoch = int(d["epoch"])
    s.A = on_device(dec(d["A"]), device)
    s.dtype = s.A.dtype
    s.SA = on_device(dec(d["SA"]), device)
    s.Qt = on_device(dec(d["Qt"]), device)
    s.R = on_device(dec(d["R"]), device)
    return s


def _json_vertex(v):
    if isinstance(v, str):
        return v
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    raise JournalError(
        f"graph vertex name {v!r} ({type(v).__name__}) is not "
        "JSON-representable; durable registries need int/str vertex names",
        reason="opaque-graph",
    )


def encode_graph(g, enc) -> dict:
    d = {
        "entity": "graph",
        "k": int(g.k),
        "streamed": bool(g._streamed),
        "epoch": int(g.epoch),
        "vertices": [_json_vertex(v) for v in g.G.vertices],
        "indptr": enc(g.G.indptr),
        "indices": enc(g.G.indices),
        "X": enc(g.X),
        "lam": enc(g.lam),
    }
    if g._S is not None:
        d["sketch"] = json.loads(g._S.to_json())
        d["sa"] = enc(g._sa)
    return d


def decode_graph(name, d, dec, device=None):
    from ..graph.graph import SimpleGraph
    from .registry import GraphSystem, on_device

    G = object.__new__(SimpleGraph)
    G.vertices = list(d["vertices"])
    G.index = {w: i for i, w in enumerate(G.vertices)}
    G.n = len(G.vertices)
    G.indptr = _host(dec(d["indptr"]))
    G.indices = _host(dec(d["indices"]))
    g = object.__new__(GraphSystem)
    g.name = name
    g.G = G
    g.k = int(d["k"])
    g._streamed = bool(d["streamed"])
    g.epoch = int(d["epoch"])
    if "sketch" in d:
        g._S = sketch_base.from_dict(d["sketch"])
        g._sa = on_device(dec(d["sa"]), device)
    else:
        g._S = None
        g._sa = None
    g.X = _host(dec(d["X"]))
    g.lam = _host(dec(d["lam"]))
    g._ppr_reports = {}
    return g


def encode_model(model, enc) -> dict:
    from ..ml.model import FeatureMapModel, KernelModel

    if isinstance(model, FeatureMapModel):
        return {
            "entity": "model",
            "model_type": "feature_map",
            "epoch": int(getattr(model, "epoch", 0)),
            "scale_maps": bool(model.scale_maps),
            "input_dim": model.input_dim,
            "classes": model.classes,
            "maps": [S.to_dict() for S in model.maps],
            "info": _json_info(model.info),
            "W": enc(model.W),
        }
    if isinstance(model, KernelModel):
        return {
            "entity": "model",
            "model_type": "kernel",
            "epoch": int(getattr(model, "epoch", 0)),
            "classes": model.classes,
            "kernel": model.kernel.to_dict(),
            "info": _json_info(model.info),
            "X_train": enc(model.X_train),
            "A": enc(model.A),
        }
    raise JournalError(
        f"model of type {type(model).__name__} has no journal codec — "
        "only the ml.model classes (FeatureMapModel, KernelModel) are "
        "durable; register it on a journal-less registry or add a codec",
        reason="opaque-model",
    )


def decode_model(d, dec, device=None):
    from ..ml.model import FeatureMapModel, KernelModel
    from .registry import on_device

    mtype = d.get("model_type")
    if mtype == "feature_map":
        model = FeatureMapModel(
            [sketch_base.from_dict(md) for md in d["maps"]],
            on_device(dec(d["W"]), device),
            scale_maps=d["scale_maps"],
            input_dim=d["input_dim"],
            classes=d["classes"],
        )
    elif mtype == "kernel":
        from ..ml.kernels import from_dict as kernel_from_dict

        model = KernelModel(
            kernel_from_dict(d["kernel"]),
            on_device(dec(d["X_train"]), device),
            on_device(dec(d["A"]), device),
            classes=d["classes"],
        )
    else:
        raise JournalError(
            f"journal model record has unknown model_type {mtype!r}",
            reason="opaque-model",
        )
    model.info = d["info"]
    model.epoch = int(d.get("epoch", 0))
    return model


_ENTITY_DECODERS = {
    "system": decode_system,
    "graph": decode_graph,
}


# -- snapshot (compaction target) -------------------------------------------


def snapshot_registry(registry):
    """``(leaves, metadata)`` for a CheckpointStore slot holding the
    registry's full durable state at its current epoch."""
    leaves: list = []

    def enc(a):
        leaves.append(a)
        return len(leaves) - 1

    entities = {"models": {}, "systems": {}, "graphs": {}}
    for name, m in registry.models.items():
        entities["models"][name] = encode_model(m, enc)
    for name, s in registry.systems.items():
        entities["systems"][name] = encode_system(s, enc)
    for name, g in registry.graphs.items():
        entities["graphs"][name] = encode_graph(g, enc)
    meta = {
        "skylark_journal_snapshot": 1,
        "epoch": int(registry.epoch),
        "epoch_log": [dict(r) for r in registry.epoch_log],
        "idem": [[t, k, dict(rec)] for (t, k), rec in registry._idem.items()],
        "entities": entities,
    }
    return leaves, meta


def restore_registry(registry, leaves, meta):
    """Field-copy restore of a snapshot into a (fresh) registry."""

    def dec(i):
        return leaves[int(i)]

    ents = meta["entities"]
    dev = registry.device
    for name, d in ents["systems"].items():
        registry.systems[name] = decode_system(name, d, dec, dev)
    for name, d in ents["graphs"].items():
        registry.graphs[name] = decode_graph(name, d, dec, dev)
    for name, d in ents["models"].items():
        registry.models[name] = decode_model(d, dec, dev)
    registry.epoch = int(meta["epoch"])
    registry.epoch_log[:] = [dict(r) for r in meta["epoch_log"]]
    for t, k, rec in meta.get("idem", []):
        registry._idem[(str(t), str(k))] = dict(rec)


# -- replay -----------------------------------------------------------------


def _rec_idem(rec):
    idem = rec.get("idem")
    return (str(idem[0]), str(idem[1])) if idem else None


def _replay_register(registry, rec):
    name, p = rec["name"], rec["payload"]
    entity = rec["attrs"]["entity"]
    if entity == "model":
        model = decode_model(p, _dec_array, registry.device)
        registry.register_model(name, model)
    else:
        obj = _ENTITY_DECODERS[entity](name, p, _dec_array, registry.device)
        target = registry.systems if entity == "system" else registry.graphs
        target[name] = obj
        registry._mint("register", name, obj, entity=entity)


def _replay_row_append(registry, rec):
    registry.append_system_rows(
        rec["name"], _dec_array(rec["payload"]["rows"]), idem=_rec_idem(rec)
    )


def _replay_row_downdate(registry, rec):
    registry.downdate_system_rows(
        rec["name"], [int(i) for i in rec["payload"]["drop"]],
        idem=_rec_idem(rec),
    )


def _replay_graph_fold(registry, rec):
    registry.fold_graph_edges(
        rec["name"], [tuple(p) for p in rec["payload"]["edges"]],
        idem=_rec_idem(rec),
    )


def _replay_model_update(registry, rec):
    p = rec["payload"]
    idem = _rec_idem(rec)
    if "model" in p:
        registry.update_model(
            rec["name"], model=decode_model(p["model"], _dec_array, registry.device),
            idem=idem,
        )
    elif "append_X" in p:
        registry.update_model(
            rec["name"],
            append=(_dec_array(p["append_X"]), _dec_array(p["append_A"])),
            idem=idem,
        )
    else:
        registry.update_model(
            rec["name"], drop=[int(i) for i in p["drop"]], idem=idem
        )


REPLAY_HANDLERS = {
    "register": _replay_register,
    "row_append": _replay_row_append,
    "row_downdate": _replay_row_downdate,
    "graph_fold": _replay_graph_fold,
    "model_update": _replay_model_update,
}

# The journal's durability contract: every Registry._mint kind has a
# record codec and a replay handler (pinned by a static contract test).
RECORD_KINDS = frozenset(REPLAY_HANDLERS)


# -- the journal ------------------------------------------------------------


class Journal:
    """Append-only CRC-framed JSONL WAL + CheckpointStore compaction.

    Opening validates the existing file: a torn final line (crash
    mid-append) is truncated and counted; mid-file corruption raises
    :class:`JournalError` immediately — better to refuse at open than
    to append after damage.  Callers serialize appends (the registry
    holds its RLock across journal-append + publish + mint).

    ``compact_every`` <= 0 disables compaction; default comes from
    ``SKYLARK_JOURNAL_COMPACT_EVERY`` (records between snapshots).
    ``faults`` takes a :class:`~..resilient.faults.JournalFaultPlan`
    for chaos drills (torn-write and die-after-append injection).
    """

    def __init__(self, directory, *, compact_every=None, keep_snapshots=2,
                 faults=None):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, JOURNAL_NAME)
        if compact_every is None:
            compact_every = int(
                os.environ.get("SKYLARK_JOURNAL_COMPACT_EVERY", "256")
            )
        self.compact_every = int(compact_every)
        self.faults = faults
        self.store = CheckpointStore(
            self.directory, keep_last=max(1, int(keep_snapshots)),
            prefix=SNAP_PREFIX,
        )
        records, torn, valid_end = scan_journal(self.path)
        self.torn_truncated = torn
        if torn:
            with open(self.path, "rb+") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
            telemetry.inc("journal.torn_tail", torn)
        self._pending = len(records)
        self._appends = 0
        self._f = open(self.path, "a", encoding="utf-8")
        _fsync_dir(self.directory)

    # -- write path ---------------------------------------------------------

    def append(self, rec: dict) -> None:
        """Durably append one record: write, flush, sync — the caller
        publishes the mutation only after this returns.  ``fdatasync``
        where the platform has it: appends need the data and the file
        size durable, not the mtime metadata a full ``fsync`` also
        flushes — this is the per-update hot path (the bench's
        journal-on/off QPS ratio charges exactly this call)."""
        line = _frame(rec)
        index = self._appends
        self._appends += 1
        sync = getattr(os, "fdatasync", os.fsync)
        if self.faults is not None and self.faults.torn_fires(index):
            # Simulate a SIGKILL mid-write: half a frame, no newline,
            # durably on disk — then die.
            self._f.write(line[: max(1, len(line) // 2)])
            self._f.flush()
            sync(self._f.fileno())
            self.faults.kill()
        self._f.write(line + "\n")
        self._f.flush()
        sync(self._f.fileno())
        self._pending += 1
        telemetry.inc("journal.appends")
        if self.faults is not None and self.faults.die_after_fires(index):
            self.faults.kill()

    # -- compaction ---------------------------------------------------------

    def due(self) -> bool:
        return self.compact_every > 0 and self._pending >= self.compact_every

    def compact(self, leaves, metadata, step: int) -> None:
        """Commit a snapshot slot (fsynced by ``save_solver_state``),
        then truncate the journal — crash-ordering-safe: the snapshot
        is durable before a single journal byte is dropped."""
        self.store.save(leaves, step=int(step), metadata=metadata)
        self._f.close()
        with open(self.path, "w", encoding="utf-8") as f:
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(self.directory)
        self._f = open(self.path, "a", encoding="utf-8")
        self._pending = 0
        telemetry.inc("journal.compactions")

    def load_snapshot(self):
        """``(leaves, metadata)`` of the newest valid snapshot slot, or
        ``None`` when the registry never compacted."""
        out = self.store.load_latest()
        if out is None:
            return None
        leaves, meta, _step = out
        return leaves, meta

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
