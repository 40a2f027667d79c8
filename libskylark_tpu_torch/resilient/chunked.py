"""The chunked-execution contract between solvers and the loop that runs them
(port of ``libskylark_tpu/resilient/chunked.py``).

A solve is a host loop over *chunks* of at most k device iterations.
``step_chunk(state, k)`` enqueues k masked steps and reads nothing back:
a step whose solver has converged (or reached its iteration limit)
leaves the state as it was, by ``torch.where`` on a device-side flag, so
the host syncs once per chunk (``is_done``), never once per iteration.
The one-shot entry points (``lsqr`` and the rest) drive the same chunks
until ``is_done``; a caller that runs chunks of any size gets bitwise
the same state, because every step is the same sequence of operations
wherever the chunk boundaries fall.

- ``init_state()`` is deterministic given the factory's inputs
  (counter-based randomness, no clock, no fresh generator state).
- ``step_chunk(state, k)`` is a pure function of ``state``.
- ``state`` is a dict of tensors (plus Python ints where no device
  predicate needs them); anything else lives in the factory's closure.

A step over a dense CUDA matrix is ~60 small launches, so run eagerly
the host's dispatch, not the card, sets its time.  :func:`stepper` then
captures one step as a CUDA graph (:class:`StepGraph`) and replays it:
the same kernels on the same buffers, so the states are bitwise the
eager ones, at one graph launch per step.

A solver that names its ``kind`` (one of
``telemetry.spans.CHUNKED_KINDS``) gets the span ``<kind>.capture``
around its step's capture and, from its host loop (:func:`chunk_span`),
``<kind>.chunk`` around each chunk with its convergence read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import telemetry
from ..telemetry.spans import CHUNKED_KINDS

__all__ = ["ChunkedSolver", "StepGraph", "stepper", "graphable", "chunk_span"]

#: Whether :func:`graphable` operands replay their steps as CUDA graphs
#: (False runs every step eagerly: the same states, bitwise).
CUDA_GRAPHS = True

_STREAMS: dict = {}

# kind -> its (capture, chunk) span names, made once.
_SPAN_NAMES = {kind: (f"{kind}.capture", f"{kind}.chunk") for kind in CHUNKED_KINDS}


def _span(kind: str | None, which: int):
    names = _SPAN_NAMES.get(kind)
    return telemetry.span(names[which]) if names else telemetry.NOOP_SPAN


def chunk_span(kind: str | None):
    """The ``<kind>.chunk`` span of one chunk of ``kind``'s host loop
    (a no-op for a kind without spans)."""
    return _span(kind, 1)


def graphable(*operands) -> bool:
    """Whether a step over these operands may be captured: each a dense
    (strided) CUDA tensor, and graphs on.  Sparse products and
    caller-given functions run eagerly."""
    return CUDA_GRAPHS and all(
        isinstance(t, torch.Tensor) and t.is_cuda and t.layout == torch.strided
        for t in operands)


def _capture_stream(device: torch.device):
    """A side stream per device to capture on (a graph cannot be captured
    on the default stream), its cuBLAS handle and workspace made once,
    outside any capture."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            x = torch.ones(2, 2, device=device)
            x @ x
        _STREAMS[device] = stream
    return stream


class StepGraph:
    """One step ``state -> state`` (a dict of CUDA tensors) captured as a
    CUDA graph that overwrites a static copy of the state in place.

    ``advance(state, k)`` copies ``state`` in (unless it is the static
    copy itself), replays the graph k times on the current stream and
    returns the static copy; nothing is read back.
    """

    def __init__(self, step: Callable[[dict], dict], state: dict):
        device = next(iter(state.values())).device
        self.step = step  # keeps the tensors the graph reads alive
        self.state = {k: v.clone() for k, v in state.items()}
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                new = step(self.state)
                for k, v in self.state.items():
                    v.copy_(new[k])
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)

    def advance(self, state: dict, k: int) -> dict:
        if state is not self.state:
            for key, v in self.state.items():
                v.copy_(state[key])
        for _ in range(k):
            self.graph.replay()
        return self.state


def stepper(step: Callable[[dict], dict], graphed: bool, kind: str | None = None):
    """``advance(state, k)``: k applications of ``step``.  Where
    ``graphed``, the first call with k > 0 captures ``step`` as a
    :class:`StepGraph` (the span ``<kind>.capture``) and every call
    replays it, returning the graph's static state (which the next call
    updates in place)."""
    graph = []

    def advance(state, k: int):
        k = max(int(k), 0)
        if graphed and k:
            if not graph:
                with _span(kind, 0):
                    graph.append(StepGraph(step, state))
            return graph[0].advance(state, k)
        for _ in range(k):
            state = step(state)
        return state

    return advance


@dataclass
class ChunkedSolver:
    """Host-driveable solver: state-out/state-in chunks of device work.

    ``iteration``/``is_done`` read the state's counters (one host sync
    each, paid once per chunk rather than once per iteration).
    """

    init_state: Callable[[], Any]
    step_chunk: Callable[[Any, int], Any]
    extract_result: Callable[[Any], Any]
    is_done: Callable[[Any], bool]
    iteration: Callable[[Any], int]
    #: stable tag of the solver kind (the JAX package records it in
    #: checkpoint metadata).
    kind: str = "chunked_solver"
    #: ``step_chunk`` that may return the state's buffers updated in
    #: place (the one-shot entry points' form: no copy of the state per
    #: chunk); None where ``step_chunk`` is already that.
    advance: Callable[[Any, int], Any] | None = None
