"""Meshes of slots, sharded values and the in-process collectives (port
of ``libskylark_tpu/parallel/mesh.py``).

The reference's matrix distributions map onto named meshes and
partition specs as in the JAX package:

=================  ==========================================
Elemental          port
=================  ==========================================
``[MC,MR]``        2-D mesh, spec ``(ROWS, COLS)``
``[VC,*]/[VR,*]``  1-D (or flattened 2-D) mesh, ``(ROWS, None)``
``[*,VC]/[*,VR]``  ``(None, COLS)``
``[*,*]``          fully replicated, ``()``
``[CIRC,CIRC]``    gathered (only at API boundaries)
=================  ==========================================

A :class:`Mesh` is an n-dimensional grid of **slots** with axis names;
each slot holds one shard and is bound to a ``torch.device``.  It
departs from ``jax.sharding.Mesh`` in one way, on purpose: several
slots may share one device.  So the JAX tests' 8-shard schedules run on
the one CPU device, and a 2- or 4-slot mesh runs the real schedule
logic on one card.  Slots on one device run one after another on its
current stream: such a mesh measures a schedule's correctness and its
overhead, never a parallel speed-up.

A sharded value is a :class:`Sharded`: the mesh, the spec, the global
shape and one local tensor per slot, on the slot's device, in the
mesh's flat (row-major) slot order.  Replicated slots on one device may
share one tensor, which nothing here writes in place.

The three collectives the schedules need run in the calling process
over the slots' tensors: :func:`psum` adds in slot order 0 … p−1 on
the destination's device (a fixed order, so a result is reproducible
bit for bit and a mesh of one is the unsharded value itself),
:func:`psum_scatter` is that sum split over the slots along dim 0, and
:func:`all_to_all` moves buffer ``[src][dst]`` to slot ``dst``.  A copy
between slots on different devices is an explicit ``.to(device)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .._device import ShardedValue, resolve_device

__all__ = [
    "ROWS",
    "COLS",
    "Mesh",
    "NamedSharding",
    "Sharded",
    "make_mesh",
    "default_mesh",
    "sharding",
    "shard",
    "reshard",
    "row_sharding",
    "shard_rows",
    "constrain_rows",
    "shard_rows_padded",
    "shard_cols",
    "replicate",
    "fully_replicated",
    "psum",
    "psum_scatter",
    "all_to_all",
]

# Canonical axis names: ROWS shards the long/sample dimension (≙ [VC,*]
# row distribution / MC grid rows), COLS the feature dimension (≙ MR).
ROWS = "rows"
COLS = "cols"


class Mesh:
    """An n-dimensional grid of slots with axis names, each slot bound to
    a ``torch.device`` (several slots may share one).

    ``devices`` is a numpy object array of ``torch.device`` of the mesh's
    shape; ``shape`` maps axis names to sizes (as ``jax.sharding.Mesh``'s
    does) and ``size`` is the number of slots.  ``explicit`` records the
    flag :func:`make_mesh` was given (see there)."""

    def __init__(self, devices, axis_names: Sequence[str], explicit: bool = False):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs {devices.ndim} axis "
                             f"names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names must be distinct, got {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one slot")
        self.devices = devices
        self.axis_names = axis_names
        self.explicit = bool(explicit)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, slot: int) -> torch.device:
        """The device of flat slot ``slot``."""
        return self.devices.flat[slot]

    def coords(self, slot: int) -> tuple:
        """The grid coordinates of flat slot ``slot``."""
        return tuple(int(c) for c in np.unravel_index(slot, self.devices.shape))

    def groups(self, axis: str) -> list:
        """Flat slot lists along ``axis``, one list per position on the
        other axes; each list in the axis's order."""
        k = self.axis_names.index(axis)
        slots = np.moveaxis(np.arange(self.size).reshape(self.devices.shape), k, -1)
        return [list(map(int, g)) for g in slots.reshape(-1, self.devices.shape[k])]

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def _slot_device(device) -> torch.device:
    """``resolve_device``, with a bare ``"cuda"`` pinned to the current
    card so that slot devices compare equal to their tensors'."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_cards() -> list:
    resolve_device("cuda")  # raises where there is no card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = (ROWS, COLS),
    explicit: bool = False,
    devices=None,
) -> Mesh:
    """A mesh of the given shape.

    ``devices=None`` takes the first ``prod(shape)`` visible CUDA devices
    in order, as ``jax.make_mesh`` takes the first devices (it raises
    where there are fewer, or no card).  A single device (``"cpu"``,
    ``"cuda:0"``) puts every slot on it; a sequence gives one device per
    slot in flat order, repeats allowed.

    ``explicit`` is recorded as ``Mesh.explicit`` and means nothing else
    here: torch has no sharding propagation to make typed.  It is kept
    because :func:`~libskylark_tpu_torch.linalg.streaming_approximate_svd`
    refuses explicit meshes, as the JAX package does."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be positive, got {shape}")
    n = math.prod(shape)
    if devices is None:
        cards = _visible_cards()
        if n > len(cards):
            raise ValueError(
                f"a mesh of {n} slots needs {n} devices, {len(cards)} visible; pass "
                "devices= to put several slots on one device")
        devs = cards[:n]
    elif isinstance(devices, (str, torch.device)):
        devs = [_slot_device(devices)] * n
    else:
        devs = [_slot_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a mesh of {n} slots needs {n} devices, got {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axis_names, explicit=explicit)


def default_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """Near-square 2-D (ROWS, COLS) mesh (≙ Elemental's default
    approximately-square process grid, ``El::Grid(comm)``).

    ``device=None`` spreads ``n_devices`` slots (default: one per
    visible card) over the visible cards, and raises where there is no
    card: it never falls back to the CPU.  A ``device`` puts every slot
    on it (``default_mesh(8, device="cpu")`` is the JAX tests' 2 × 4 mesh
    on the CPU).  One slot is a 1 × 1 mesh, so every code path is
    mesh-agnostic."""
    if device is None:
        n = len(_visible_cards()) if n_devices is None else int(n_devices)
    else:
        n = 1 if n_devices is None else int(n_devices)
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return make_mesh((r, n // r), (ROWS, COLS), devices=device)


class NamedSharding:
    """A mesh and a partition spec (one entry per leading dim: None, an
    axis name, or a tuple of axis names split in row-major order)."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)
        for entry in self.spec:
            for ax in _axes_of(entry):
                if ax not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {ax!r}, not in "
                                     f"{mesh.axis_names}")

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and _norm(self.spec) == _norm(other.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _norm(spec) -> tuple:
    spec = tuple(_axes_of(e) for e in spec)
    while spec and not spec[-1]:
        spec = spec[:-1]
    return spec


def _blocks(mesh: Mesh, spec, shape) -> list:
    """Per slot, the tuple of slices of the global array it holds."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the array's {len(shape)} dims")
    sizes = mesh.shape
    parts = []
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        count = math.prod(sizes[a] for a in axes)
        if shape[d] % count:
            raise ValueError(f"dim {d} of shape {tuple(shape)} is not divisible by the "
                             f"{count} shards of spec entry {entry!r}")
        parts.append((axes, count, shape[d] // count))
    out = []
    for slot in range(mesh.size):
        c = dict(zip(mesh.axis_names, mesh.coords(slot)))
        sl = []
        for axes, _, width in parts:
            k = 0
            for a in axes:
                k = k * sizes[a] + c[a]
            sl.append(slice(k * width, (k + 1) * width))
        out.append(tuple(sl))
    return out


class Sharded(ShardedValue):
    """A global array split over a mesh: ``mesh``, ``spec``, the global
    ``shape`` and ``shards``, one local tensor per slot (flat slot order)
    on the slot's device.  The port's ``jax.Array`` with a
    ``NamedSharding``; :func:`fully_replicated` gathers it."""

    def __init__(self, mesh: Mesh, spec, shape, shards):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(int(s) for s in shape)
        self.shards = list(shards)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {mesh.size} slots")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def linear_ops(self):
        """``(matvec, rmatvec)`` slot by slot (``routes.linear_ops``), for
        ``utils.linear_ops`` and the solvers that take an operator."""
        from .routes import linear_ops

        return linear_ops(self)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={self.mesh!r})")


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def shard(x, mesh: Mesh, *spec) -> Sharded:
    """Place ``x`` with the given partition-spec entries: each slot gets
    its block, contiguous, on its device (a block already there and
    contiguous is a view of ``x``, never written here).  A
    :class:`Sharded` ``x`` is resharded (:func:`reshard`): no slot
    gathers the whole array."""
    if isinstance(x, Sharded):
        return reshard(x, mesh, *spec)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    blocks = _blocks(mesh, spec, x.shape)
    shards = [x[sl].contiguous().to(mesh.device(k)) for k, sl in enumerate(blocks)]
    return Sharded(mesh, spec, x.shape, shards)


def reshard(x: Sharded, mesh: Mesh, *spec) -> Sharded:
    """``x`` laid out as ``spec`` over ``mesh`` without gathering it:
    each target slot's block is assembled from the pieces of the source
    shards that overlap it, each piece copied once to the target slot's
    device (the all-to-all a GSPMD reshard runs).  A target block that
    is a source shard on the same device is that shard."""
    blocks = _blocks(mesh, spec, x.shape)
    src = _blocks(x.mesh, x.spec, x.shape)
    shards = []
    for k, tgt in enumerate(blocks):
        dev = mesh.device(k)
        same = [j for j, sl in enumerate(src) if sl == tgt and x.shards[j].device == dev]
        if same:
            shards.append(x.shards[same[0]])
            continue
        out = torch.empty(tuple(b.stop - b.start for b in tgt), dtype=x.dtype, device=dev)
        covered = set()
        for j, sl in enumerate(src):
            inter = [slice(max(a.start, b.start), min(a.stop, b.stop)) for a, b in zip(sl, tgt)]
            if any(i.start >= i.stop for i in inter) or tuple(inter) in covered:
                continue  # no overlap, or a replica of a piece already copied
            covered.add(tuple(inter))
            piece = x.shards[j][tuple(slice(i.start - a.start, i.stop - a.start)
                                      for i, a in zip(inter, sl))]
            out[tuple(slice(i.start - b.start, i.stop - b.start)
                      for i, b in zip(inter, tgt))] = piece.to(dev)
        shards.append(out)
    return Sharded(mesh, spec, x.shape, shards)


def _all_axes(mesh: Mesh):
    return mesh.axis_names[0] if len(mesh.axis_names) == 1 else tuple(mesh.axis_names)


def row_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """The canonical ``[VC,*]`` sharding: dim 0 over the whole mesh."""
    return NamedSharding(mesh, (_all_axes(mesh),) + (None,) * (ndim - 1))


def shard_rows(x, mesh: Mesh) -> Sharded:
    """Distribute dim 0 over the whole mesh (≙ ``[VC,*]``)."""
    return shard(x, mesh, *row_sharding(mesh, _ndim(x)).spec)


def constrain_rows(x, mesh: Mesh) -> Sharded:
    """Row-shard ``x`` (a tensor or a :class:`Sharded`) over ``mesh``:
    a value already row-sharded there is returned as it is, anything
    else is split (a container gathered first).  The JAX package's
    constraint inside ``jit``; torch runs it eagerly."""
    if isinstance(x, Sharded) and x.sharding == row_sharding(mesh, x.ndim):
        return x
    return shard_rows(x, mesh)


def shard_cols(x, mesh: Mesh) -> Sharded:
    """Distribute the last dim over the whole mesh (≙ ``[*,VR]``)."""
    return shard(x, mesh, *([None] * (_ndim(x) - 1) + [_all_axes(mesh)]))


def replicate(x, mesh: Mesh) -> Sharded:
    """Fully replicate (≙ ``[*,*]``)."""
    return shard(x, mesh)


def shard_rows_padded(x, mesh: Mesh, pad_value=0.0):
    """``shard_rows`` for any row count: pads dim 0 with ``pad_value`` up
    to a multiple of the mesh size.  Returns ``(sharded, n_orig)``;
    callers whose math tolerates the padded rows trim row-shaped outputs
    back to ``n_orig``."""
    if isinstance(x, Sharded):
        x = fully_replicated(x)
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    n = x.shape[0]
    pad = (-n) % mesh.size
    if pad:
        fill = torch.full((pad,) + tuple(x.shape[1:]), pad_value, dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, fill])
    return shard_rows(x, mesh), n


def fully_replicated(x):
    """Gather a :class:`Sharded` into one tensor on slot 0's device; any
    other value passes through unchanged (as the JAX function leaves an
    unsharded array alone).  Where one slot holds the whole array (a
    replicated value, a mesh of one) that slot's tensor is returned."""
    if not isinstance(x, Sharded):
        return x
    dev = x.mesh.device(0)
    blocks = _blocks(x.mesh, x.spec, x.shape)
    whole = tuple(slice(0, s) for s in x.shape)
    for k, sl in enumerate(blocks):
        if sl == whole:
            return x.shards[k].to(dev)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for k, sl in enumerate(blocks):
        out[sl] = x.shards[k].to(dev)
    return out


def _ndim(x) -> int:
    return x.ndim if isinstance(x, (torch.Tensor, Sharded)) else np.ndim(x)


# -- collectives over the slots ----------------------------------------------


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``parts[0] + parts[1] + … + parts[p-1]``, added in that (slot)
    order on ``device``; one part is returned as it is (moved)."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out


def psum_scatter(parts: Sequence[torch.Tensor], devices: Sequence) -> list:
    """The tiled reduce-scatter along dim 0: slot ``j`` gets rows
    ``[j·c, (j+1)·c)`` of :func:`psum` (``c = rows / p``), summed in slot
    order on ``devices[j]``, bitwise that block of the full sum."""
    p = len(parts)
    rows = parts[0].shape[0]
    if rows % p:
        raise ValueError(f"psum_scatter needs dim 0 ({rows}) divisible by {p}")
    c = rows // p
    return [psum([t[j * c:(j + 1) * c] for t in parts], devices[j]) for j in range(p)]


def all_to_all(bufs: Sequence, devices: Sequence) -> list:
    """The tiled all-to-all along dim 0: ``bufs[src]`` is ``(p, …)`` (a
    tensor, or a tuple of tensors moved together); slot ``dst`` receives
    ``stack(bufs[src][dst] for src in slot order)`` on ``devices[dst]``."""
    p = len(bufs)

    def take(src, dst, dev):
        b = bufs[src]
        return tuple(t[dst].to(dev) for t in b) if isinstance(b, tuple) else b[dst].to(dev)

    out = []
    for dst in range(p):
        got = [take(src, dst, devices[dst]) for src in range(p)]
        if isinstance(bufs[0], tuple):
            out.append(tuple(torch.stack(col) for col in zip(*got)))
        else:
            out.append(torch.stack(got))
    return out
