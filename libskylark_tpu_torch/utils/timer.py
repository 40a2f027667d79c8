"""Phase timers (port of ``libskylark_tpu/utils/timer.py``).

≙ ``SKYLARK_TIMER_{DECLARE,INITIALIZE,RESTART,ACCUMULATE,PRINT}``
(``utility/timer.hpp:6-70``): named accumulating wall timers.  PyTorch
queues CUDA work and returns, so a phase that assigns its handle's
``result`` waits at phase exit for the card that holds it
(``torch.cuda.synchronize(device)``, the reference's barrier); a result
on the CPU is already computed.  The cross-process min/max/avg report
(``timer_report(..., distributed=True)``) waits for the port's
multi-device layer (ROADMAP Queue A item 9); :func:`aggregate_report`
formats gathered totals already.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from .exceptions import UnsupportedError

__all__ = ["PhaseTimer", "timer_report", "aggregate_report"]


class _PhaseHandle:
    """Set ``.result`` inside the phase so device work is synced on exit."""

    result = None


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in a nest of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class PhaseTimer:
    """Accumulating named phase timers (one instance per algorithm run).

    Usage::

        t = PhaseTimer()
        with t.phase("transform") as ph:
            ph.result = S.apply(X)   # synced on at phase exit
        print(t.report())

    Without assigning ``ph.result`` a phase over CUDA work records only
    the time to queue it.
    """

    def __init__(self, sync: bool = True):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextmanager
    def phase(self, name: str):
        handle = _PhaseHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if self.sync and handle.result is not None:
                for device in _cuda_devices(handle.result, set()):
                    torch.cuda.synchronize(device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, distributed: bool = False) -> str:
        return timer_report(self.totals, self.counts, distributed=distributed)


def timer_report(totals, counts=None, distributed: bool = False) -> str:
    """Local total/calls/avg table (≙ timer.hpp PRINT on one rank)."""
    if distributed:
        raise UnsupportedError(
            "timer_report(distributed=True) is not ported yet (ROADMAP Queue A "
            "item 9: multi-device)")
    lines = [f"{'phase':<24}{'total(s)':>12}{'calls':>8}{'avg(s)':>12}"]
    for name in sorted(totals):
        total = totals[name]
        n = (counts or {}).get(name, 1) or 1
        lines.append(f"{name:<24}{total:>12.4f}{n:>8}{total / n:>12.4f}")
    return "\n".join(lines)


def aggregate_report(names, stacked, counts2d=None) -> str:
    """min/max/avg-over-ranks table from ``stacked`` (P, k) phase totals
    (≙ the MPI_Reduce triple of ``utility/timer.hpp:44-66``)."""
    P = stacked.shape[0]
    lines = [
        f"{'phase':<24}{'min(s)':>12}{'max(s)':>12}{'avg(s)':>12}"
        f"{'calls':>8}  (over {P} process{'es' if P != 1 else ''})"
    ]
    for j, name in enumerate(names):
        col = stacked[:, j]
        calls = int(counts2d[:, j].max()) if counts2d is not None else 1
        lines.append(
            f"{name:<24}{col.min():>12.4f}{col.max():>12.4f}"
            f"{col.mean():>12.4f}{calls:>8}"
        )
    return "\n".join(lines)
