"""Device-parallel dispatch: one coalesced batch over several devices
(port of ``libskylark_tpu/serve/dispatch.py``).

The executors (``batcher.py``) run each batch on the worker's device.
Where a batch's padded rung clears the gates, the heavy half of the
executor runs as a program over a mesh of the devices the gates pick
(``parallel.mesh``), split on the batch axis:

- LS-solve: the (m, kb) right-hand sides split on columns
  (``parallel.collectives.batch_sharded_program``), each slot applying
  the full sketch to its columns;
- predict: the (kb, d) queries split on rows, each slot computing its
  rows' outputs (the feature maps and the coefficient product, or the
  Gram block against the training set).

Communication-free: no sum crosses slots.  Each slot computes in the
executors' fixed blocks of :data:`~.batcher.BLOCK` columns or rows, the
scheme that holds coalesced ≡ serial, so a slot's bits are the single
device's wherever its blocks see the same kernels.  That is verified,
not assumed: the first dispatch of every (anchor, rung, devices, dtype)
program is a parity probe that runs both routes on the live batch and
compares the bits on the host.  A match serves the reference bits and
keeps the program (``serve.sharded_verified``, trace event
``sharded_probe``); a mismatch tombstones it (``serve.sharded_rejected``)
and the executor keeps its single-device path.  Later dispatches of a
kept program count ``serve.sharded_dispatch`` (event ``sharded``).

The gates are the JAX package's:

- :func:`supported`: hard feasibility — at least two devices, the device
  count divides the rung, and each shard width stays on the batcher's
  lane-uniform sub-ladder (a multiple of the base rung 8);
- :func:`worthwhile`: amortization — enough flops in the heavy half
  (``SKYLARK_SERVE_SHARD_MIN_FLOPS``, default 3e7);
- :func:`shard_devices`: the largest feasible split of the local CUDA
  devices, or ``None``; ``SKYLARK_SERVE_SHARD=1`` forces the route past
  :func:`worthwhile`, ``=0`` turns it off.

On one card the gates pick none and the executor runs its own path.
Several entries of one device (a virtual split of one card) run the
same programs slot after slot.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import telemetry

__all__ = [
    "supported",
    "worthwhile",
    "shard_devices",
    "maybe_sketch_sharded",
    "maybe_feature_sharded",
    "maybe_kernel_sharded",
    "clear_cache",
]

# Default amortization floor: below ~3e7 flops in the heavy half, the
# per-shard dispatch + resharding overhead eats the win.
_MIN_FLOPS = 3e7

_AXIS = "serve_batch"

# (id(anchor), kind, kb, d, dtype) -> [anchor, verdict].  The anchor
# (sketch / model) is held so that its id is never recycled; verdict
# None = unprobed, True = parity held (serve sharded), False =
# tombstoned (single-device from then on).
_PROGRAMS: dict = {}


def clear_cache() -> None:
    """Drop every program and its verdict."""
    _PROGRAMS.clear()


def supported(kb: int, d: int) -> bool:
    """Can a kb-wide rung split over d devices without leaving the
    lane-uniform sub-ladder (shard width a multiple of the base rung)?"""
    return d >= 2 and kb % d == 0 and (kb // d) % 8 == 0


def worthwhile(flops: float) -> bool:
    """Amortization gate for the AUTO route (forced mode skips it)."""
    floor = _MIN_FLOPS
    env = os.environ.get("SKYLARK_SERVE_SHARD_MIN_FLOPS")
    if env:
        try:
            floor = float(env)
        except ValueError:
            pass
    return flops >= floor


def _local_devices(device: torch.device) -> list:
    """The devices a batch on ``device`` could shard over: every local
    card for a CUDA batch, none for a CPU one."""
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_devices(kb: int, flops: float, device=None):
    """The device list a kb-wide dispatch on ``device`` would shard
    over, or ``None`` when the gates say the single-device path runs.
    Largest feasible split wins."""
    mode = os.environ.get("SKYLARK_SERVE_SHARD", "")
    if mode == "0":
        return None
    if mode != "1" and not worthwhile(flops):
        return None
    devs = _local_devices(torch.device(device if device is not None else "cpu"))
    for d in range(len(devs), 1, -1):
        if supported(kb, d):
            return devs[:d]
    return None


def _host(t: torch.Tensor, rows) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a if rows is None else a[:rows]


def _dispatch_sharded(anchor, kind, kb, devs, dtype, local, x, axis, reference, rows,
                      entries):
    """Shared probe-then-serve core: ``local`` runs on each slot's block
    of ``x`` (split on ``axis``: 1 for columns, 0 for rows).  Returns the
    result the caller uses, or ``None`` (a tombstoned program) meaning
    "run your single-device path yourself"."""
    from ..parallel.mesh import Sharded, fully_replicated, make_mesh, shard

    key = (id(anchor), kind, kb, len(devs), str(dtype))
    slot = _PROGRAMS.setdefault(key, [anchor, None])
    if slot[1] is False:
        return None
    mesh = make_mesh((len(devs),), (_AXIS,), devices=devs)
    # Explicit reshard first: the worker hands over a batch on its own
    # device, and each slot's block goes to the slot's device.
    spec = (None, _AXIS) if axis == 1 else (_AXIS, None)
    xs = shard(x, mesh, *spec)
    outs = [local(t) for t in xs.shards]
    shape = list(outs[0].shape)
    shape[axis] *= len(devs)
    out = fully_replicated(Sharded(mesh, spec, shape, outs)).to(x.device)
    if slot[1] is None:
        ref = reference()
        match = bool(np.array_equal(_host(out, rows), _host(ref, rows)))
        slot[1] = match
        telemetry.inc("serve.sharded_verified" if match else "serve.sharded_rejected")
        telemetry.event("serve", "sharded_probe",
                        {"kind": kind, "bucket": kb, "devices": len(devs), "match": match})
        for e in entries or ():
            e.trace["events"].append({"kind": "sharded_probe", "op": kind,
                                      "devices": len(devs), "match": match})
        # Parity held: the sharded bits ARE the reference bits; hand back
        # the reference itself on the probe call.
        return ref if match else None
    telemetry.inc("serve.sharded_dispatch")
    for e in entries or ():
        e.trace["events"].append({"kind": "sharded", "op": kind, "devices": len(devs)})
    return out


def maybe_sketch_sharded(S, B, kb: int, entries=None, reference=None):
    """S·B with B's kb columns (the coalesced RHS batch) split over the
    devices the gates pick, each slot in blocks of 8 columns as the
    executor; ``None`` when the gates (or a failed parity probe) say
    stay single-device.  ``reference()`` computes the single-device S·B
    for the probe."""
    devs = shard_devices(kb, 2.0 * B.shape[0] * S.s * kb, B.device)
    if devs is None:
        return None
    from .. import plans
    from .batcher import _by_blocks

    def local(b):
        return _by_blocks(lambda blk: plans.apply(S, blk, "columnwise"), b, 1)

    return _dispatch_sharded(S, "ls", kb, devs, B.dtype, local, B, 1, reference, None,
                             entries)


def maybe_feature_sharded(model, Xp, true_rows: int, entries=None,
                          reference=None):
    """The (kb, k) outputs of a feature-map predict batch, its rows
    (requests) split over the devices the gates pick, each slot in blocks
    of 8 rows (the maps, then the coefficient product, as the executor);
    ``None`` when gated off or tombstoned.  The probe compares the true
    rows only."""
    maps = getattr(model, "maps", None)
    if not maps:
        return None
    kb, d_in = Xp.shape
    devs = shard_devices(kb, 2.0 * kb * d_in * sum(s.s for s in maps), Xp.device)
    if devs is None:
        return None
    from .batcher import _by_blocks, _feature_z

    def block(xb):
        Z = _feature_z(model, xb)
        return Z @ model.W.to(device=Z.device, dtype=Z.dtype)

    return _dispatch_sharded(model, "predict", kb, devs, Xp.dtype,
                             lambda x: _by_blocks(block, x, 0), Xp, 0, reference,
                             true_rows, entries)


def maybe_kernel_sharded(model, Xp, true_rows: int, entries=None,
                         reference=None):
    """Gram-matrix predict with the query rows split over the devices
    the gates pick, each slot in blocks of 8 rows; ``None`` when gated
    off or tombstoned.  Returns the full padded (kb, t) output."""
    if not hasattr(model, "kernel"):
        return None
    kb, d_in = Xp.shape
    n_train = model.X_train.shape[0]
    devs = shard_devices(kb, 2.0 * kb * n_train * d_in, Xp.device)
    if devs is None:
        return None
    from .batcher import _by_blocks

    return _dispatch_sharded(model, "kernel", kb, devs, Xp.dtype,
                             lambda x: _by_blocks(model.predict, x, 0), Xp, 0, reference,
                             true_rows, entries)
