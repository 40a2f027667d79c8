"""Cross-process collectives of the elastic path on ``torch.distributed``
(port of the ``cross_host_psum`` / ``CollectiveWatchdog`` half of
``libskylark_tpu/parallel/collectives.py``).

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

The explicit sharded schedules of the JAX module (``rowwise_sharded``
... ``ShardedBCOO``) are ROADMAP Queue A item 9b; their names raise
``UnsupportedError`` (``parallel/__init__.py``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import telemetry
from ..utils.exceptions import CollectiveTimeoutError, StaleEpochError

__all__ = ["cross_host_psum", "CollectiveWatchdog", "HEARTBEAT_DIR", "world_info",
           "gather_vectors", "gather_objects", "Pending"]

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
