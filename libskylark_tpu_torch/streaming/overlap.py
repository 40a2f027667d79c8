"""Where the streaming fold waits for the card (port of
``libskylark_tpu/streaming/overlap.py``).

PyTorch queues CUDA work and returns, so while the fold of chunk k runs
on the card the prefetch thread copies chunk k+1 on its own stream
(``pipeline``).  The engine's job is to place the waits:

- **overlap mode** (default): the fold never waits mid-chunk; one
  :func:`chunk_sync` at each chunk boundary, before the guard's
  finiteness probe reads the accumulator and before the runner can
  checkpoint the state;
- **serial mode** (``SKYLARK_NO_OVERLAP=1`` or
  ``StreamParams(overlap=False)``): :func:`step_sync` after every step,
  so transfer and compute alternate.

Both fold the same blocks in the same order with the same operations;
only the host's waits move, so overlapped ≡ serial is bitwise.  A wait
is on the current stream of each card the accumulator lies on, not the
whole card: a copy in flight on the copy stream goes on.
"""

from __future__ import annotations

import os

import torch

__all__ = ["enabled", "step_sync", "chunk_sync"]


def enabled(flag: bool | None = None) -> bool:
    """The overlap knob: ``SKYLARK_NO_OVERLAP=1`` wins, then an explicit
    ``StreamParams(overlap=)``, then the default, on."""
    if os.environ.get("SKYLARK_NO_OVERLAP", "0") == "1":
        return False
    return True if flag is None else bool(flag)


def _wait(tree) -> None:
    devices = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def step_sync(acc):
    """Serial mode's wait: the step's accumulator is computed before the
    next batch is touched."""
    _wait(acc)
    return acc


def chunk_sync(acc):
    """Overlap mode's one wait per chunk."""
    _wait(acc)
    return acc
