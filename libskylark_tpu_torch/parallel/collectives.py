"""Collectives and the explicit sharded sketch schedules (port of
``libskylark_tpu/parallel/collectives.py``): the cross-process merge of
the elastic path on ``torch.distributed``, and the in-process
``shard_map`` schedules over a mesh's slots.

The JAX package runs one ``jax.distributed`` process per host, each with
a mesh of its local devices; the port runs one process per card, each a
rank of a ``torch.distributed`` process group with one explicit device.
The caller initializes the group (``init_process_group``, as the JAX
caller runs ``jax.distributed.initialize()``); the backend is the
group's own (NCCL for CUDA ranks, gloo for CPU worlds and for several
ranks sharing one card) and nothing here switches it.

- :func:`cross_host_psum`: the merge of the elastic streaming engine and
  the distributed trainer, one ``all_reduce(SUM)`` per leaf of a dict of
  float tensors, on the rank's device, identical on every rank.  At
  world = 1 (no group, or a group of one) it returns its input: a
  bitwise no-op, so the single-process routes keep their bits.
- :class:`CollectiveWatchdog`: heartbeat files and a deadline around a
  collective: a peer that never arrives raises
  :class:`~libskylark_tpu_torch.utils.exceptions.CollectiveTimeoutError`
  (110) naming it; a peer at a higher epoch raises
  :class:`~libskylark_tpu_torch.utils.exceptions.StaleEpochError` (111).
  The collective is started with ``async_op=True`` and its ``Work``
  polled, which works for gloo and NCCL alike (an NCCL collective
  returns to the host at once; its ``Work`` completes when the card has
  run it).  A torch collective cannot be cancelled: past the deadline
  the rank raises and the pending work ends at the group's own
  ``timeout=``, so give the group one when deadlines matter.

A backend that has no implementation for a tensor's device type (NCCL
and a CPU tensor, or a gloo build without CUDA and a CUDA tensor) gets
an explicit copy to the device type it takes and back, counted in
``cross_host_psum.host_copies`` and the ``collective.host_copies``
counter; gloo takes CUDA tensors itself where it was built with CUDA
(it stages them through the host internally).

The explicit sharded schedules (``rowwise_sharded`` … ``ShardedBCOO``)
run each ``shard_map`` program of the JAX module slot by slot over a
:class:`~.mesh.Mesh`: an operand is placed as the program's ``in_specs``
place it (a :class:`~.mesh.Sharded` already split so is used as it is),
each slot runs the local body on its device with its own counter
windows, through the same kernels as the single-device route, and the
mesh's :func:`~.mesh.psum` / :func:`~.mesh.psum_scatter` /
:func:`~.mesh.all_to_all` stand in for the program's collectives, in
slot order.  A replicated result is one tensor on slot 0's device; a
sharded one is a :class:`~.mesh.Sharded`.  Sparse input is a 2-D
``torch.sparse_coo_tensor`` (the JAX BCOO), read as it is
(``_indices()``/``_values()``), so its entry order is the order the
schedules keep within a row block.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import telemetry
from ..sketch import dense as dense_mod
from ..sketch.base import Dimension
from ..sketch.hash import _segment_sum
from ..utils.exceptions import CollectiveTimeoutError, StaleEpochError
from .mesh import (Mesh, Sharded, _all_axes, all_to_all, psum, psum_scatter, shard,
                   sharding)

__all__ = [
    "cross_host_psum",
    "CollectiveWatchdog",
    "HEARTBEAT_DIR",
    "world_info",
    "gather_vectors",
    "gather_objects",
    "Pending",
    "rowwise_sharded",
    "columnwise_sharded",
    "batch_sharded_program",
    "columnwise_batch_sharded",
    "rowwise_sharded_sparse",
    "columnwise_sharded_sparse",
    "columnwise_sharded_sparse_2d",
    "columnwise_sharded_sparse_out",
    "columnwise_sharded_sparse_out_2d",
    "rowwise_sharded_sparse_out",
    "suggest_sparse_out_capacity",
    "ShardedBCOO",
]

HEARTBEAT_DIR = "heartbeats"


def world_info() -> tuple[int, int]:
    """``(rank, world_size)`` of this process: the initialized
    ``torch.distributed`` group's, ``(0, 1)`` without one (as the JAX
    package's ``streaming.elastic.world_info`` reads ``jax.distributed``)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return int(dist.get_rank()), int(dist.get_world_size())


def _takes() -> dict:
    """``{device type: backend}`` of the default group (``cpu:gloo,cuda:gloo``
    for a gloo group, ``cuda:nccl`` for NCCL)."""
    import torch.distributed as dist

    pairs = (p.split(":") for p in str(dist.get_backend_config()).split(","))
    return {dev.strip(): be.strip() for dev, be in (p for p in pairs if len(p) == 2)}


def _stage_device(device: torch.device) -> torch.device | None:
    """Where a tensor on ``device`` must go for the group's backend: None
    where the backend takes ``device`` itself, else a device it takes."""
    takes = _takes()
    if device.type in takes:
        return None
    if "cpu" in takes:
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


class Pending:
    """A started collective: its ``Work`` handles and a function that
    returns the result once they completed."""

    def __init__(self, works, result):
        self.works = list(works)
        self.result = result

    def completed(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.result()


class CollectiveWatchdog:
    """Deadline-bound a collective instead of hanging forever.

    - **heartbeats**: before a phase each rank atomically writes
      ``<root>/heartbeats/rank-<r:05d>.json`` (``{rank, epoch, phase,
      ts}``, the JAX format).  On timeout the rank reads its peers' files
      and names those whose heartbeat never reached the phase.
    - **deadline**: past ``deadline_s`` a
      :class:`~libskylark_tpu_torch.utils.exceptions.CollectiveTimeoutError`
      (110) carries the stragglers.
    - **epoch fencing**: a peer heartbeat at a HIGHER epoch means the
      world repartitioned without this rank:
      :class:`~libskylark_tpu_torch.utils.exceptions.StaleEpochError` (111)
      at once.

    ``deadline_s=None`` (default; ``SKYLARK_COLLECTIVE_TIMEOUT_S`` when
    set) waits for the collective inline, bit for bit the unguarded run.
    Single-process worlds never build one.
    """

    def __init__(self, root=None, *, rank: int = 0, world: int = 1, epoch: int = 0,
                 deadline_s: float | None = None, poll_s: float = 0.25):
        if deadline_s is None:
            env = os.environ.get("SKYLARK_COLLECTIVE_TIMEOUT_S")
            if env:
                try:
                    deadline_s = float(env)
                except ValueError:
                    deadline_s = None
        self.dir = os.path.join(str(root), HEARTBEAT_DIR) if root else None
        self.rank = int(rank)
        self.world = int(world)
        self.epoch = int(epoch)
        self.deadline_s = deadline_s
        self.poll_s = float(poll_s)

    def _path(self, rank: int) -> str:
        return os.path.join(self.dir, f"rank-{int(rank):05d}.json")

    def beat(self, phase: str) -> None:
        """Announce arrival at ``phase`` (atomic write, best effort: a full
        disk must not turn a healthy collective into a failure)."""
        if self.dir is None:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            payload = json.dumps({"rank": self.rank, "epoch": self.epoch, "phase": str(phase),
                                  "ts": round(time.time(), 6)})
            tmp = self._path(self.rank) + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
            os.replace(tmp, self._path(self.rank))
        except OSError:
            pass

    def peers(self) -> dict:
        """``{rank: heartbeat dict}`` for every readable peer file."""
        out = {}
        if self.dir is None:
            return out
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in sorted(names):
            if not (name.startswith("rank-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.dir, name), encoding="utf-8") as fh:
                    rec = json.load(fh)
                out[int(rec["rank"])] = rec
            except (OSError, json.JSONDecodeError, KeyError, ValueError, TypeError):
                continue
        return out

    def _check_stale(self) -> None:
        for rank, rec in self.peers().items():
            if int(rec.get("epoch", 0)) > self.epoch:
                raise StaleEpochError(
                    f"rank {self.rank} runs at elastic epoch {self.epoch} but rank {rank}'s "
                    f"heartbeat announces epoch {rec.get('epoch')}: the world repartitioned "
                    "past this process — its partials are stale",
                    expected=self.epoch, got=int(rec.get("epoch", 0)))

    def stragglers(self, phase: str) -> list:
        """Ranks whose heartbeat never reached ``phase`` (empty when no
        heartbeat root is configured)."""
        if self.dir is None:
            return []
        seen = self.peers()
        return [r for r in range(self.world)
                if r != self.rank and (r not in seen or seen[r].get("phase") != str(phase))]

    def guard(self, phase: str, start):
        """Run the collective ``start()`` begins (it returns a
        :class:`Pending`) bounded by the deadline; returns its result."""
        self.beat(phase)
        pending = start()
        if not self.deadline_s or self.deadline_s <= 0:
            return pending.wait()
        t0 = time.monotonic()
        deadline = t0 + float(self.deadline_s)
        next_stale = t0
        nap = 0.001
        while not pending.completed():
            now = time.monotonic()
            if now >= next_stale:
                self._check_stale()
                next_stale = now + self.poll_s
            if now >= deadline:
                self._timeout(phase)
            time.sleep(nap)
            nap = min(2 * nap, 0.05)
        return pending.wait()

    def _timeout(self, phase: str):
        stragglers = self.stragglers(phase)
        if telemetry.enabled():
            telemetry.inc("collective.timeouts")
            telemetry.event("collective", "timeout", {
                "phase": str(phase), "rank": self.rank, "world": self.world,
                "epoch": self.epoch, "deadline_s": float(self.deadline_s),
                "stragglers": stragglers})
        who = str(stragglers) if stragglers else "unknown (no heartbeat root)"
        raise CollectiveTimeoutError(
            f"collective {phase!r} did not complete within {self.deadline_s}s on rank "
            f"{self.rank} (world {self.world}, epoch {self.epoch}); ranks that never "
            f"arrived: {who}",
            phase=str(phase), deadline_s=float(self.deadline_s), stragglers=stragglers)


def _start_psum(leaves: dict) -> Pending:
    import torch.distributed as dist

    works, outs = [], {}
    for key, t in leaves.items():
        stage = _stage_device(t.device)
        if stage is None:
            buf = t.detach().clone()
        else:
            buf = t.detach().to(stage)
            cross_host_psum.host_copies += 2
            if telemetry.enabled():
                telemetry.inc("collective.host_copies", 2)
        works.append(dist.all_reduce(buf, op=dist.ReduceOp.SUM, async_op=True))
        outs[key] = (buf, t.device)

    def result():
        return {k: buf if buf.device == dev else buf.to(dev) for k, (buf, dev) in outs.items()}

    return Pending(works, result)


def cross_host_psum(tree, *, watchdog: CollectiveWatchdog | None = None, phase: str = "psum"):
    """Elementwise sum of a rank-local float tensor, or dict of them, over
    every rank of the process group: one ``all_reduce(SUM)`` per leaf,
    the result on each leaf's device, identical on every rank (the
    backend's summation order, fixed for one backend and world).

    World = 1 returns ``tree`` unchanged: a bitwise no-op.  Non-float
    leaves raise ``TypeError`` (merge bookkeeping ints locally).
    ``watchdog`` bounds the merge by its deadline (110 naming the
    stragglers); None waits, bit for bit the unguarded merge."""
    rank, world = world_info()
    if world == 1:
        return tree
    leaves = tree if isinstance(tree, dict) else {None: tree}
    for t in leaves.values():
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError("cross_host_psum sums floating-point tensors only (merge "
                            f"bookkeeping ints locally), got {getattr(t, 'dtype', type(t))}")
    t_wait = time.monotonic() if telemetry.enabled() else None
    if watchdog is not None:
        out = watchdog.guard(phase, lambda: _start_psum(leaves))
    else:
        out = _start_psum(leaves).wait()
    if t_wait is not None:
        # Straggler attribution: each rank times its own merge (arrive,
        # wait for peers, sum); the rank that arrived last waits least.
        wait_ms = (time.monotonic() - t_wait) * 1e3
        telemetry.observe_phase("collective_wait", wait_ms)
        telemetry.set_gauge("collective.last_wait_ms", round(wait_ms, 4))
        telemetry.set_gauge("collective.rank", rank)
    return out if isinstance(tree, dict) else out[None]


cross_host_psum.host_copies = 0


def gather_vectors(vec, *, watchdog: CollectiveWatchdog | None = None,
                   phase: str = "handshake") -> np.ndarray:
    """All-gather one int64 vector per rank: a ``(world, len)`` numpy
    array, row r rank r's.  The vector travels on the device the backend
    takes for host data (the host for gloo, the rank's card for NCCL)."""
    import torch.distributed as dist

    _, world = world_info()
    # The host where the backend takes host tensors (gloo), else the card.
    dev = _stage_device(torch.device("cpu")) or torch.device("cpu")
    mine = torch.as_tensor(np.asarray(vec, np.int64), device=dev)
    outs = [torch.empty_like(mine) for _ in range(world)]

    def start():
        work = dist.all_gather(outs, mine, async_op=True)
        return Pending([work], lambda: np.stack([o.cpu().numpy() for o in outs]))

    if watchdog is not None:
        return watchdog.guard(phase, start)
    return start().wait()


def gather_objects(obj) -> list:
    """``all_gather_object`` over the group: every rank's ``obj``, in rank
    order (``[obj]`` at world = 1)."""
    import torch.distributed as dist

    _, world = world_info()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# The explicit sharded schedules: shard_map programs of the JAX package,
# run over the slots of a mesh (parallel/mesh.py) in slot order.
# ---------------------------------------------------------------------------


def _coerce_float(A):
    if isinstance(A, Sharded):
        return A if A.dtype.is_floating_point else _map_shards(A, lambda t: t.float())
    A = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    return A if A.is_floating_point() else A.to(torch.float32)


def _map_shards(x: Sharded, fn) -> Sharded:
    return Sharded(x.mesh, x.spec, x.shape, [fn(t) for t in x.shards])


def _place(A, mesh: Mesh, *spec) -> Sharded:
    """``A`` split as ``spec`` over ``mesh`` (the ``in_specs`` of a
    ``shard_map``): a :class:`Sharded` already split so is used as it is,
    anything else is (re)split."""
    if isinstance(A, Sharded) and A.sharding == sharding(mesh, *spec):
        return A
    return shard(A, mesh, *spec)


def rowwise_sharded(S, A, mesh: Mesh):
    """A (m, N) sharded on rows → A·Omegaᵀ (m, S) sharded on rows.

    Zero communication: each slot applies the full sketch to its local
    rows (Omega realized in-slot).  Returns a :class:`Sharded`."""
    axes = _all_axes(mesh)
    A = _place(_coerce_float(A), mesh, axes, None)
    outs = [S.apply(a, Dimension.ROWWISE) for a in A.shards]
    return Sharded(mesh, (axes, None), (A.shape[0], S.s), outs)


def batch_sharded_program(local, mesh: Mesh):
    """Shard the BATCH axis: a function that runs ``local`` on column
    blocks of its 2-D operands, outputs re-joined on columns (a
    :class:`Sharded` with spec ``(None, axes)``, or a tuple of them).
    Communication-free by construction: the serving layer's
    device-parallel dispatch schedule, where the columns are independent
    coalesced requests.

    Contrast :func:`columnwise_sharded`, which shards the CONTRACTION
    axis and merges with a ``psum``: the psum reorders the accumulation,
    so its result is only approximately the single-device one.  Here no
    reduction crosses slots, so the result is bitwise the unsharded
    ``local`` PROVIDED (a) ``local`` is column-pure (each output column
    depends only on its input column) and (b) every slot's column block
    takes the route the whole batch takes (a batch-width gate such as
    ``HashSketch.batch_size_gates`` on the other side, or a GEMM that
    picks another algorithm at the narrower width, changes the
    arithmetic).  Callers gate on (b); this schedule just runs."""
    axes = _all_axes(mesh)

    def run(*args):
        placed = [_place(a, mesh, None, axes) for a in args]
        outs = [local(*(a.shards[k] for a in placed)) for k in range(mesh.size)]
        single = isinstance(outs[0], torch.Tensor)
        cols = [outs] if single else list(zip(*outs))
        res = [Sharded(mesh, (None, axes), (o[0].shape[0], o[0].shape[1] * mesh.size), o)
               for o in cols]
        return res[0] if single else tuple(res)

    return run


def columnwise_batch_sharded(S, B, mesh: Mesh):
    """B (N, k) of k independent right-hand-side columns → S·B (S.s, k),
    sharded on the batch (column) axis: each slot applies the FULL sketch
    to its column block (no counter windowing, unlike
    :func:`columnwise_sharded`'s contraction split).  Zero communication,
    and bitwise the unsharded columnwise apply under
    :func:`batch_sharded_program`'s proviso."""
    nshards = mesh.size
    B = _coerce_float(B)
    k = B.shape[1]
    if k % nshards:
        raise ValueError(f"batch columns {k} not divisible by mesh size {nshards}")
    return batch_sharded_program(lambda b: S.apply(b, Dimension.COLUMNWISE), mesh)(B)


def _window_product(S, a, off: int):
    """``Omega[:, off:off+k] @ a`` for a slot's (k, m) row block: one
    realized window, or above ``MAX_REALIZE_ELEMENTS`` the dense apply's
    panel loop over the window, so that a mesh of one is bitwise the
    unsharded apply."""
    dtype, dev, k = a.dtype, a.device, a.shape[0]
    if S.s * k <= dense_mod.MAX_REALIZE_ELEMENTS:
        return S.realize(dtype, offset=(0, off), shape=(S.s, k), device=dev) @ a
    panel = max(1, dense_mod.MAX_REALIZE_ELEMENTS // S.s)
    acc = torch.zeros((S.s,) + tuple(a.shape[1:]), dtype=dtype, device=dev)
    for p0 in range(0, k, panel):
        pc = min(panel, k - p0)
        w = S.realize(dtype, offset=(0, off + p0), shape=(S.s, pc), device=dev)
        acc = acc + w @ a[p0:p0 + pc]
    return acc


def _merge(parts, mesh: Mesh, scatter: bool, shape):
    """The end of a contraction split: one :func:`psum` onto slot 0's
    device (a replicated result, returned as that one tensor), or with
    ``scatter`` the row-sharded :func:`psum_scatter`."""
    if scatter:
        devices = [mesh.device(k) for k in range(mesh.size)]
        return Sharded(mesh, (_all_axes(mesh), None), shape, psum_scatter(parts, devices))
    return psum(parts, mesh.device(0))


def columnwise_sharded(S, A, mesh: Mesh, scatter: bool = False):
    """A (N, m) sharded on rows → S·A (S, m), for a dense sketch.

    Each slot multiplies its Omega column window (counter-derived,
    ``realize`` at the slot's offset) with its row block, then a
    :func:`~.mesh.psum` sums the partial products in slot order (a
    tensor on slot 0's device); ``scatter=True`` runs the
    ``psum_scatter`` instead and leaves the output row-sharded (the
    reference's reduce-scatter within grid columns)."""
    A = _coerce_float(A)
    nshards = mesh.size
    n = A.shape[0]
    if n % nshards:
        raise ValueError(f"rows {n} not divisible by mesh size {nshards}")
    block = n // nshards
    if S.s % nshards and scatter:
        raise ValueError(f"S={S.s} not divisible by mesh size for scatter")
    A = _place(A, mesh, _all_axes(mesh), None)
    parts = [_window_product(S, a, k * block) for k, a in enumerate(A.shards)]
    return _merge(parts, mesh, scatter, (S.s,) + tuple(A.shape[1:]))


# ---------------------------------------------------------------------------
# P6: explicit sharded SPARSE hash-sketch schedules.
#
# The reference distributes sparse matrices on a CombBLAS √p×√p grid and
# applies hash sketches block-locally, merging with an MPI reduce
# (``sketch/hash_transform_CombBLAS.hpp:136-302``).  As in the JAX package,
# COO nonzeros are split by row block (each block padded to equal nnz
# with zero-data entries), each slot draws its own bucket/value counter
# windows (no sketch data moves) and scatter-adds into a dense (S, m)
# accumulator through the single-device route's segment sum
# (``hash._segment_sum``: the segment_sum_flat kernel for f32/bf16/f16,
# an f64 ``index_add_`` otherwise), and one psum (or psum_scatter) merges.


def _coo_parts(A, name: str):
    if not (isinstance(A, torch.Tensor) and A.layout == torch.sparse_coo and A.ndim == 2):
        raise TypeError(f"{name} takes a 2-D sparse COO tensor, got "
                        f"{getattr(A, 'layout', type(A).__name__)}")
    idx = A._indices()
    return idx[0], idx[1], A._values()


def _split_entries(owner, nparts: int, fields):
    """Entries grouped by ``owner`` in [0, nparts), input order kept
    within a group (a stable sort), each group padded with zeros to the
    largest group: per group, one tensor per field."""
    counts = torch.bincount(owner, minlength=nparts)
    width = max(1, int(counts.max()))
    order = torch.sort(owner, stable=True).indices
    ends = torch.cumsum(counts, 0).tolist()
    out = []
    for g in range(nparts):
        lo, hi = (ends[g - 1] if g else 0), ends[g]
        sel = order[lo:hi]
        row = []
        for f in fields:
            buf = torch.zeros(width, dtype=f.dtype, device=f.device)
            buf[:hi - lo] = f[sel]
            row.append(buf)
        out.append(row)
    return out


def _shard_coo_rows(A, mesh: Mesh, block: int, name: str):
    """Split COO nonzeros into the mesh's row blocks: per slot, on its
    device, (data, local row, col) padded to equal nnz with zero-data
    entries (they scatter 0, harmless)."""
    rows, cols, data = _coo_parts(A, name)
    p = mesh.size
    owner = torch.div(rows, block, rounding_mode="floor")
    groups = _split_entries(owner, p, (data, (rows - owner * block).int(), cols.int()))
    return [tuple(t.to(mesh.device(k)) for t in g) for k, g in enumerate(groups)]


def _coo_dtype(data):
    return data.dtype if data.is_floating_point() else torch.float32


def _real_entries(d, *idx):
    """The entries whose data is not 0.  The rest (a split's padding, a
    sparse-out buffer's empty slots) add ±0 to a sum that starts at +0,
    which changes no bit; dropped, they do not pile onto one key (a
    4-slot exchange's buffers are mostly padding at (0, 0))."""
    keep = d != 0
    if bool(keep.all()):
        return (d,) + idx
    return (d[keep],) + tuple(t[keep] for t in idx)


def _hash_dense_block(S, d, lr, cc, m: int, off: int, block: int):
    """One slot's columnwise sparse → dense partial: ``acc (S, m)`` of its
    row block, hash windows ``[h·N + off, h·N + off + block)``."""
    dtype, dev = _coo_dtype(d), d.device
    d, lr, cc = _real_entries(d, lr, cc)
    d, lr = d.to(dtype), lr.long()
    acc = torch.zeros(S.s * m, dtype=dtype, device=dev)
    for h in range(S.nnz):
        b = S.buckets(h * S.n + off, block, device=dev).long()
        v = S.values(dtype, h * S.n + off, block, device=dev)
        key = (b[lr] * m + cc.long()).int()
        acc = acc + _segment_sum(d * v[lr], key, S.s * m).to(dtype)
    return acc.reshape(S.s, m)


def columnwise_sharded_sparse(S, A, mesh: Mesh, scatter: bool = False):
    """COO A (N, m), nonzeros owned by row block → dense S·A (S, m).

    Each slot hashes its row block with its own bucket/value counter
    windows (contiguous in the (nnz, N) flat layout, so slot-local) and
    scatter-adds into a local (S, m) accumulator; one ``psum`` merges
    (a tensor on slot 0's device; ``scatter=True`` leaves rows sharded)."""
    p = mesh.size
    n, m = A.shape
    if n != S.n:
        raise ValueError(f"columnwise apply needs A with {S.n} rows, got {tuple(A.shape)}")
    if n % p:
        raise ValueError(f"rows {n} not divisible by mesh size {p}")
    if scatter and S.s % p:
        raise ValueError(f"S={S.s} not divisible by mesh size for scatter")
    if n >= (1 << 32):
        raise ValueError(f"columnwise_sharded_sparse supports N < 2^32, got N={n}")
    block = n // p
    slots = _shard_coo_rows(A, mesh, block, "columnwise_sharded_sparse")
    return _columnwise_sparse_program(S, m, block, mesh, scatter, slots)


def _columnwise_sparse_program(S, m: int, block: int, mesh: Mesh, scatter: bool, slots):
    parts = [_hash_dense_block(S, d, lr, cc, m, k * block, block)
             for k, (d, lr, cc) in enumerate(slots)]
    return _merge(parts, mesh, scatter, (S.s, m))


def _shard_coo_grid(A, mesh: Mesh, rblock: int, cblock: int, name: str):
    """Split COO nonzeros onto a (pr, pc) grid by (row-block, col-block)
    ownership: per slot (flat order), (data, local row, local col)
    padded to equal nnz with zero-data entries."""
    rows, cols, data = _coo_parts(A, name)
    pr, pc = mesh.devices.shape
    oi = torch.div(rows, rblock, rounding_mode="floor")
    oj = torch.div(cols, cblock, rounding_mode="floor")
    groups = _split_entries(oi * pc + oj, pr * pc,
                            (data, (rows - oi * rblock).int(), (cols - oj * cblock).int()))
    return [tuple(t.to(mesh.device(k)) for t in g) for k, g in enumerate(groups)]


def _validate_grid_2d(S, A, mesh: Mesh, fn_name: str):
    """Shared preamble of the 2-D grid schedules: axis/shape/2^32
    validation and the grid split.  Returns ``(pr, pc, rblock, cblock,
    slots)``."""
    if len(mesh.axis_names) != 2:
        raise ValueError(f"{fn_name} needs a 2-axis mesh, got {mesh.axis_names}")
    pr, pc = mesh.devices.shape
    n, m = A.shape
    if n != S.n:
        raise ValueError(f"columnwise apply needs A with {S.n} rows, got {tuple(A.shape)}")
    if n % pr or m % pc:
        raise ValueError(f"shape {tuple(A.shape)} not divisible by mesh grid ({pr}, {pc})")
    if n >= (1 << 32):
        raise ValueError(f"supports N < 2^32, got N={n}")
    rblock, cblock = n // pr, m // pc
    return pr, pc, rblock, cblock, _shard_coo_grid(A, mesh, rblock, cblock, fn_name)


def columnwise_sharded_sparse_2d(S, A, mesh: Mesh):
    """COO A (N, m) on a 2-D grid → dense S·A (S, m), column-sharded.

    The 2-D answer to ``sketch/hash_transform_CombBLAS.hpp:136-302``'s
    √p×√p distribution, for matrices long in BOTH dimensions: nonzeros
    are owned by (row-block, column-block); each slot hashes its row
    window with in-slot counter windows and scatter-adds a LOCAL
    (S, m/pc) block; one ``psum`` over the mesh ROW axis merges the
    partial products, leaving the output sharded over mesh columns (a
    :class:`Sharded` with spec ``(None, cols axis)``; the sum of column
    block j is made on slot (0, j)'s device).  Needs a 2-axis mesh
    (e.g. ``make_mesh((pr, pc))``); N and m must divide the axis sizes."""
    _, _, rblock, cblock, slots = _validate_grid_2d(S, A, mesh, "columnwise_sharded_sparse_2d")
    ax_r, ax_c = mesh.axis_names
    parts = [_hash_dense_block(S, d, lr, lc, cblock, mesh.coords(k)[0] * rblock, rblock)
             for k, (d, lr, lc) in enumerate(slots)]
    outs = [None] * mesh.size
    for group in mesh.groups(ax_r):
        total = psum([parts[k] for k in group], mesh.device(group[0]))
        for k in group:
            outs[k] = total.to(mesh.device(k))
    return Sharded(mesh, (None, ax_c), (S.s, A.shape[1]), outs)


def rowwise_sharded_sparse(S, A, mesh: Mesh):
    """COO A (m, N), nonzeros owned by row block → dense A·Sᵀ (m, S),
    row-sharded.  Communication-free (≙ the ``[VC,*]`` rowwise
    invariant): the hashed axis is the replicated feature axis, so each
    slot sketches its own rows with the full bucket table."""
    p = mesh.size
    m, n = A.shape
    if n != S.n:
        raise ValueError(f"rowwise apply needs A with {S.n} columns, got {tuple(A.shape)}")
    if m % p:
        raise ValueError(f"rows {m} not divisible by mesh size {p}")
    block = m // p
    outs = []
    for d, lr, cc in _shard_coo_rows(A, mesh, block, "rowwise_sharded_sparse"):
        dtype, dev = _coo_dtype(d), d.device
        d, lr, cc = _real_entries(d, lr, cc)
        d, cc = d.to(dtype), cc.long()
        acc = torch.zeros(block * S.s, dtype=dtype, device=dev)
        for h in range(S.nnz):
            b = S.buckets(h * S.n, S.n, device=dev).long()
            v = S.values(dtype, h * S.n, S.n, device=dev)
            key = (lr.long() * S.s + b[cc]).int()
            acc = acc + _segment_sum(d * v[cc], key, block * S.s).to(dtype)
        outs.append(acc.reshape(block, S.s))
    return Sharded(mesh, (_all_axes(mesh), None), (m, S.s), outs)


# ---------------------------------------------------------------------------
# sparse -> SPARSE sharded output (SpParMat -> SpParMat)
# ---------------------------------------------------------------------------


class ShardedBCOO:
    """Row-block-sharded sparse sketch result with deferred duplicates.

    The port of the reference's distributed-sparse output
    (``sketch/hash_transform_CombBLAS.hpp:136-302``: SpParMat in,
    SpParMat out).  Slot k owns the contiguous row block ``[k·row_block,
    (k+1)·row_block)`` of the logical ``shape`` and holds its entries as
    flat (data, local row, col) arrays: ``data``, ``rows`` and ``cols``
    are :class:`Sharded` values of global shape (p, L) (2-D grid:
    (pr, pc, L)), one (1, L) row per slot.  Padding entries carry
    ``data == 0`` at (0, 0), harmless under the deferred-duplicate
    convention (they add zero).  Nothing here is densified;
    :meth:`to_bcoo`/:meth:`todense` are the explicit exits."""

    def __init__(self, data, rows, cols, shape, row_block, mesh, col_block: int | None = None):
        self.data, self.rows, self.cols = data, rows, cols
        self.shape, self.row_block, self.mesh = tuple(shape), row_block, mesh
        # 2-D grid results: cols are local to the slot's column block of
        # width col_block; None = global.
        self.col_block = col_block

    @property
    def dtype(self):
        return self.data.dtype

    def to_bcoo(self) -> torch.Tensor:
        """Gather to one coalesced sparse COO tensor on slot 0's device,
        duplicates summed (the finalize step of the local sparse apply).
        Zero-data padding entries (the capacity slack) are dropped first,
        so its nnz is entry-proportional, never buffer-sized."""
        dev = self.mesh.device(0)
        ds, rs, cs = [], [], []
        for k in range(self.mesh.size):
            c = self.mesh.coords(k)
            i, j = (c[0], c[1]) if self.col_block is not None else (k, 0)
            ds.append(self.data.shards[k].reshape(-1).to(dev))
            rs.append(self.rows.shards[k].reshape(-1).to(dev).long() + i * self.row_block)
            gc = self.cols.shards[k].reshape(-1).to(dev).long()
            cs.append(gc + j * self.col_block if self.col_block is not None else gc)
        d, r, c = torch.cat(ds), torch.cat(rs), torch.cat(cs)
        keep = d != 0
        idx = torch.stack([r[keep], c[keep]])
        return torch.sparse_coo_tensor(idx, d[keep], self.shape,
                                       check_invariants=False).coalesce()

    def todense(self) -> torch.Tensor:
        return self.to_bcoo().to_dense()

    def _slot_entries(self):
        return [(self.data.shards[k][0], self.rows.shards[k][0], self.cols.shards[k][0])
                for k in range(self.mesh.size)]

    def sketch_columnwise(self, S2, dense_output: bool = True, scatter: bool = False,
                          capacity: int | None = None):
        """Apply a second sketch to this sharded sparse result without
        leaving the slots: the per-slot (data, local row, col) arrays are
        exactly the row-block split the sharded columnwise schedules
        take, so chaining S2·(S1·A) costs no gather and no densified
        intermediate.  Duplicate entries are fine: hashing is linear in
        entries.

        ``dense_output=True`` runs the dense-merge schedule (one psum;
        ``scatter`` leaves rows sharded); ``False`` runs the sparse-out
        exchange and returns another :class:`ShardedBCOO`."""
        if self.col_block is not None:
            raise ValueError(
                "chaining from a 2-D grid result is not supported — its column indices "
                "are block-local; gather via to_bcoo() first")
        p = self.mesh.size
        n2, m2 = self.shape
        if S2.n != n2:
            raise ValueError(f"columnwise chain needs S2.n == {n2}, got {S2.n}")
        if n2 >= (1 << 32):
            raise ValueError(f"sparse schedules support N < 2^32, got {n2}")
        if (scatter or not dense_output) and S2.s % p:
            raise ValueError(f"chain needs S={S2.s} divisible by mesh size {p} "
                             "(sharded output rows)")
        slots = self._slot_entries()
        if dense_output:
            return _columnwise_sparse_program(S2, m2, self.row_block, self.mesh, scatter, slots)
        cap = S2.nnz * self.data.shape[1] if capacity is None else int(capacity)
        return _columnwise_sparse_out_program(S2, self.row_block, S2.s // p, cap, self.mesh,
                                              slots, (S2.s, m2))


def columnwise_sharded_sparse_out(S, A, mesh: Mesh, capacity: int | None = None):
    """COO A (N, m) → S·A (S, m) as a :class:`ShardedBCOO`, output
    ROW-BLOCK-SHARDED and never densified (the other sparse schedules
    merge into a dense (S, m) accumulator, the wrong asymptotic when S
    is large and the output stays sparse).

    Schedule: each slot hashes its row block with slot-local counter
    windows, relabels its nonzeros to (bucket, col, v·val) (deferred
    duplicates, exactly the local sparse apply) and routes every entry
    to the slot that owns its output row block through ONE tiled
    :func:`~.mesh.all_to_all` of fixed-capacity per-destination buffers.

    ``capacity`` is the per-(source, destination) buffer length.  The
    default (every entry of one source landing on one destination) can
    never drop; a smaller value SILENTLY DROPS the overflow entries: a
    source's entries are ordered by a stable sort on destination and
    those past ``capacity`` in that order are left out, as the JAX
    package's ``mode="drop"`` leaves them.  Only pass a value derived
    from a real count (:func:`suggest_sparse_out_capacity`).  Zero-value
    padding entries go to the sentinel destination p and never take a
    slot, so the count that matters is the largest per-(source,
    destination) number of REAL entries."""
    p = mesh.size
    n, m = A.shape
    if n != S.n:
        raise ValueError(f"columnwise apply needs A with {S.n} rows, got {tuple(A.shape)}")
    if n % p:
        raise ValueError(f"rows {n} not divisible by mesh size {p}")
    if S.s % p:
        raise ValueError(f"sparse-out needs S={S.s} divisible by mesh size {p} "
                         "(output is row-block-sharded)")
    if n >= (1 << 32):
        raise ValueError(f"sparse schedules support N < 2^32, got N={n}")
    block, out_block = n // p, S.s // p
    slots = _shard_coo_rows(A, mesh, block, "columnwise_sharded_sparse_out")
    cap = S.nnz * slots[0][0].shape[0] if capacity is None else int(capacity)
    return _columnwise_sparse_out_program(S, block, out_block, cap, mesh, slots, (S.s, m))


def _hash_entries(S, d, lr, off: int, block: int):
    """One slot's relabelled entries over every hash: (values, global
    output rows), hash-major, as the JAX program concatenates them."""
    dtype, dev = _coo_dtype(d), d.device
    d, lr = d.to(dtype), lr.long()
    vals, rows = [], []
    for h in range(S.nnz):
        b = S.buckets(h * S.n + off, block, device=dev)
        v = S.values(dtype, h * S.n + off, block, device=dev)
        vals.append(d * v[lr])
        rows.append(b[lr])
    return torch.cat(vals), torch.cat(rows)


def _exchange_entries(entries, devices, out_block: int, cap: int):
    """Route each source's (val, row, col) entries to the peer owning row
    block ``row // out_block`` through ONE tiled :func:`~.mesh.all_to_all`
    of fixed-capacity per-destination buffers.  ``entries[src]`` is on
    ``devices[src]``; returns, per destination, (values, LOCAL rows,
    cols), each (p, cap) in source order.

    Zero-value entries (block padding; the hash values are nonzero, so
    val == 0 iff the padded data slot was 0) go to the out-of-range
    sentinel destination p: they never take a capacity slot.  A source's
    entries are ordered by a stable sort on destination; those past
    ``cap`` in a destination's run are dropped (``mode="drop"``)."""
    p = len(devices)
    bufs = []
    for val, row, col in entries:
        dev = val.device
        dest = torch.div(row, out_block, rounding_mode="floor").long()
        dest = torch.where(val == 0, torch.full_like(dest, p), dest)
        sd, order = torch.sort(dest, stable=True)
        starts = torch.searchsorted(sd, torch.arange(p, device=dev))
        pos = torch.arange(sd.shape[0], device=dev) - starts[torch.clamp(sd, max=p - 1)]
        keep = (sd < p) & (pos < cap)
        at = (sd[keep], pos[keep])
        o = order[keep]
        bv = torch.zeros((p, cap), dtype=val.dtype, device=dev)
        br = torch.zeros((p, cap), dtype=torch.int32, device=dev)
        bc = torch.zeros((p, cap), dtype=torch.int32, device=dev)
        bv[at], br[at], bc[at] = val[o], row[o].int(), col[o].int()
        bufs.append((bv, br, bc))
    out = []
    for me, (rv, rr, rc) in enumerate(all_to_all(bufs, devices)):
        # Received rows are global; relabel to this slot's row block.
        # Padding entries (value 0) clip to local row 0, harmless.
        lrows = torch.clamp(rr - me * out_block, 0, out_block - 1)
        out.append((rv, lrows, rc))
    return out


def suggest_sparse_out_capacity(S, A, mesh: Mesh) -> int:
    """Exact per-(source, destination) REAL-entry capacity for
    :func:`columnwise_sharded_sparse_out` on this (sketch, matrix, mesh):
    the smallest value that cannot drop (padding never counts: it rides
    the sentinel destination).  Hashes the nonzero global rows once with
    the same counter-derived buckets the schedule uses, on A's device.

    1-D meshes only: the row block (n/p) and destination routing here
    assume every slot sits on one axis.  On a 2-D grid rows split over
    the ROW axis only, so this count would be wrong for
    :func:`columnwise_sharded_sparse_out_2d`: rejected rather than
    silently under- or over-sized."""
    if len(mesh.axis_names) > 1:
        raise ValueError(
            "suggest_sparse_out_capacity is 1-D only: mesh has axes "
            f"{tuple(mesh.axis_names)}; its n/p row blocks and p-way destination counts "
            "do not match the 2-D grid's row-axis exchange (see "
            "columnwise_sharded_sparse_out_2d)")
    rows, _, data = _coo_parts(A, "suggest_sparse_out_capacity")
    p = mesh.size
    n = A.shape[0]
    block, out_block = n // p, S.s // p
    buckets = S.buckets(device=rows.device).long()  # (nnz·N,) flat layout
    need = 1
    for src in range(p):
        gl = rows[(torch.div(rows, block, rounding_mode="floor") == src) & (data != 0)]
        if not gl.numel():
            continue
        # All hash functions of one source share the destination buffer.
        dests = torch.cat([buckets[h * S.n + gl] // out_block for h in range(S.nnz)])
        need = max(need, int(torch.bincount(dests, minlength=p).max()))
    return need


def _entries_sharded(mesh: Mesh, spec, per_slot, shape) -> tuple:
    """Per-slot (values, rows, cols) as the three :class:`Sharded` fields
    of a :class:`ShardedBCOO` of global entry-array ``shape``, each
    slot's entries flattened to one row of it."""
    lead = (1,) * (len(shape) - 1)
    return tuple(Sharded(mesh, spec, shape, [t[f].reshape(lead + (-1,)) for t in per_slot])
                 for f in range(3))


def _columnwise_sparse_out_program(S, block: int, out_block: int, cap: int, mesh: Mesh,
                                   slots, out_shape):
    """The slot half of :func:`columnwise_sharded_sparse_out` (one
    all-to-all, no psum, no (S, m) dense accumulator)."""
    p = mesh.size
    entries = []
    for k, (d, lr, cc) in enumerate(slots):
        val, row = _hash_entries(S, d, lr, k * block, block)
        entries.append((val, row, cc.repeat(S.nnz)))
    devices = [mesh.device(k) for k in range(p)]
    got = _exchange_entries(entries, devices, out_block, cap)
    dv, rv, cv = _entries_sharded(mesh, (_all_axes(mesh), None), got, (p, p * cap))
    return ShardedBCOO(dv, rv, cv, out_shape, out_block, mesh)


def columnwise_sharded_sparse_out_2d(S, A, mesh: Mesh, capacity: int | None = None):
    """COO A (N, m) on a 2-D grid → S·A (S, m) as a :class:`ShardedBCOO`
    on the SAME grid, never densified: the full SpParMat → SpParMat
    analogue (``sketch/hash_transform_CombBLAS.hpp:136-302``).

    Nonzeros are owned by (row-block, column-block).  An entry's output
    column block is its INPUT column block (columnwise sketching leaves
    columns alone), so routing is column-local: each slot relabels its
    entries to (bucket, local col, v·val) with in-slot counter windows
    and exchanges them with its mesh-COLUMN peers through one tiled
    all-to-all over the mesh ROW axis.  Output: slot (i, j) owns rows
    ``[i·S/pr, (i+1)·S/pr)`` × cols ``[j·m/pc, (j+1)·m/pc)``.

    ``capacity`` as in :func:`columnwise_sharded_sparse_out` (the
    default cannot drop; a smaller one silently drops the overflow).
    :func:`suggest_sparse_out_capacity` is the 1-D helper and refuses 2-D
    meshes: here entries route over the ROW axis only (pr peers, row
    block n/pr), so a tight 2-D capacity counts per-(row-block,
    destination) maxima on that axis instead."""
    pr, pc, rblock, cblock, slots = _validate_grid_2d(S, A, mesh,
                                                      "columnwise_sharded_sparse_out_2d")
    if S.s % pr:
        raise ValueError(f"sparse-out needs S={S.s} divisible by mesh rows {pr} "
                         "(output rows are block-sharded over the row axis)")
    ax_r, ax_c = mesh.axis_names
    out_rblock = S.s // pr
    cap = S.nnz * slots[0][0].shape[0] if capacity is None else int(capacity)
    got = [None] * mesh.size
    for group in mesh.groups(ax_r):
        entries = []
        for i, k in enumerate(group):
            d, lr, lc = slots[k]
            val, row = _hash_entries(S, d, lr, i * rblock, rblock)
            entries.append((val, row, lc.repeat(S.nnz)))
        recv = _exchange_entries(entries, [mesh.device(k) for k in group], out_rblock, cap)
        for k, r in zip(group, recv):
            got[k] = r
    dv, rv, cv = _entries_sharded(mesh, (ax_r, ax_c, None), got, (pr, pc, pr * cap))
    return ShardedBCOO(dv, rv, cv, (S.s, A.shape[1]), out_rblock, mesh, col_block=cblock)


def rowwise_sharded_sparse_out(S, A, mesh: Mesh):
    """COO A (m, N), row-sharded → A·Sᵀ (m, S) as a :class:`ShardedBCOO`,
    row-sharded, never densified.  Communication-FREE (the hashed axis is
    the replicated feature axis): each slot relabels its own rows' column
    indices with the full bucket table and keeps its entries; the output
    row owner is the input row owner."""
    p = mesh.size
    m, n = A.shape
    if n != S.n:
        raise ValueError(f"rowwise apply needs A with {S.n} columns, got {tuple(A.shape)}")
    if m % p:
        raise ValueError(f"rows {m} not divisible by mesh size {p}")
    block = m // p
    per_slot = []
    for d, lr, cc in _shard_coo_rows(A, mesh, block, "rowwise_sharded_sparse_out"):
        dtype, dev = _coo_dtype(d), d.device
        d, cc = d.to(dtype), cc.long()
        vals, cols = [], []
        for h in range(S.nnz):
            b = S.buckets(h * S.n, S.n, device=dev)
            v = S.values(dtype, h * S.n, S.n, device=dev)
            vals.append(d * v[cc])
            cols.append(b[cc])
        per_slot.append((torch.cat(vals), lr.repeat(S.nnz), torch.cat(cols)))
    dv, rv, cv = _entries_sharded(mesh, (_all_axes(mesh), None), per_slot,
                                  (p, per_slot[0][0].numel()))
    return ShardedBCOO(dv, rv, cv, (m, S.s), block, mesh)
