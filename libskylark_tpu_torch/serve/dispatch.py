"""Device-parallel dispatch gates (port of ``libskylark_tpu/serve/dispatch.py``).

The JAX package reroutes the heavy half of a coalesced batch (the sketch
apply for LS-solve, the feature-map or Gram block for predict) through
a program sharded over the batch axis of every local device, once a
parity probe has shown it bitwise the single-device program.  The gates
that decide it are ported as they are:

- :func:`supported`: hard feasibility — at least two devices, the device
  count divides the rung, and each shard width stays on the batcher's
  lane-uniform sub-ladder (a multiple of the base rung 8);
- :func:`worthwhile`: amortization — enough flops in the heavy half
  (``SKYLARK_SERVE_SHARD_MIN_FLOPS``, default 3e7);
- :func:`shard_devices`: the largest feasible split of the local CUDA
  devices, or ``None``; ``SKYLARK_SERVE_SHARD=1`` forces the route past
  :func:`worthwhile`, ``=0`` turns it off.

The sharded programs and their parity probe wait for ROADMAP Queue A
item 9c (they run the executors' solves on a sharded batch, which the
JAX package leaves to GSPMD).  So where the gates pick two or more devices, the
``maybe_*`` entry points raise :class:`UnsupportedError` naming that
item instead of quietly running the single-device path; where they pick
none (one card, a CPU registry, a rung too narrow to split) they return
``None`` and the executor runs its own single-device path.  They keep
the JAX package's signatures; ``entries`` and ``reference`` (the
probe's inputs) wait for item 9c too.
"""

from __future__ import annotations

import os

import torch

from ..utils.exceptions import UnsupportedError

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

ITEM9 = "ROADMAP Queue A item 9c: sharded serve programs and their parity probe"


def clear_cache() -> None:
    """Drop the sharded programs (none exist until item 9c brings them)."""


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


def _refuse(kind: str, kb: int, devs) -> None:
    raise UnsupportedError(
        f"serve {kind} batch of rung {kb} would shard over {len(devs)} devices; "
        f"the sharded serve programs are not ported yet ({ITEM9})"
    )


def maybe_sketch_sharded(S, B, kb: int, entries=None, reference=None):
    """``None`` (run the single-device S·B) unless the gates pick two or
    more devices for the (m, kb) block ``B``, which raises."""
    devs = shard_devices(kb, 2.0 * B.shape[0] * S.s * kb, B.device)
    if devs is not None:
        _refuse("ls", kb, devs)
    return None


def maybe_feature_sharded(model, Xp, true_rows: int, entries=None,
                          reference=None):
    """``None`` (run the single-device feature block) unless the gates
    pick two or more devices for the (kb, d) block ``Xp``, which raises."""
    maps = getattr(model, "maps", None)
    if not maps:
        return None
    kb, d_in = Xp.shape
    devs = shard_devices(kb, 2.0 * kb * d_in * sum(s.s for s in maps), Xp.device)
    if devs is not None:
        _refuse("predict", kb, devs)
    return None


def maybe_kernel_sharded(model, Xp, true_rows: int, entries=None,
                         reference=None):
    """``None`` (run the single-device Gram predict) unless the gates
    pick two or more devices for the (kb, d) block ``Xp``, which raises."""
    if not hasattr(model, "kernel"):
        return None
    kb, d_in = Xp.shape
    n_train = model.X_train.shape[0]
    devs = shard_devices(kb, 2.0 * kb * n_train * d_in, Xp.device)
    if devs is not None:
        _refuse("kernel", kb, devs)
    return None
