"""Device-level tracing (port of ``libskylark_tpu/utils/profiling.py``).

``PhaseTimer`` (``utils.timer``) covers the wall-clock side; this module
wraps ``torch.profiler`` for op-level traces (host ops and, on the card,
CUDA kernels) written as Chrome traces, viewable in Perfetto or
``chrome://tracing``.  :func:`annotate` names a region in such a trace
and, on the card, in an NVTX range as well.
"""

from __future__ import annotations

import contextlib
import os
from contextlib import contextmanager

import torch

__all__ = ["trace", "annotate"]


@contextmanager
def trace(logdir: str):
    """Capture a trace into ``logdir`` (``trace-<pid>.json``, a Chrome
    trace): host activity always, CUDA activity where a card is present.

    Usage::

        with profiling.trace("build/skylark-trace"):
            model = solver.train(X, y)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(str(logdir), f"trace-{os.getpid()}.json"))


class annotate(contextlib.ContextDecorator):
    """Named region inside a trace (≙ the reference's per-phase timer
    labels): a ``torch.profiler.record_function`` and, once CUDA is in
    use, an NVTX range.  Usable as decorator or context manager."""

    def __init__(self, name: str):
        self.name = name
        self._record = None
        self._nvtx = False

    def _recreate_cm(self):
        # A decorated function may recurse or run on two threads: each
        # call gets its own region.
        return annotate(self.name)

    def __enter__(self):
        self._record = torch.profiler.record_function(self.name)
        self._record.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._record.__exit__(exc_type, exc, tb)
        return False
