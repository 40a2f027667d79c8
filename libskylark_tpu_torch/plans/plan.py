"""Sketch-apply plans: captured CUDA graphs behind a cache (port of
``libskylark_tpu/plans/plan.py``).

The eager sketch path launches the counter-stream realization plus the
matmul or scatter as dozens to hundreds of small kernels, so the host's
dispatch, not the card, sets the pace of a small apply or a stream
chunk.  A *plan* is the port's counterpart of the JAX package's fused
``jax.jit`` executable: on the card the apply is captured once as a
``torch.cuda.CUDAGraph`` and every later call replays it; the plans sit
in the process-wide cache (``cache.PLAN_CACHE``), keyed on the
serialized sketch and the input signature, so repeated applies (every
batch of a streaming pass, every sketch-and-solve call, every sketch
rebuilt from the same JSON) share one graph.

Three plan kinds, as in the JAX package:

- ``apply``: the full ``S.apply(A, dim)``, bitwise the eager apply (the
  same kernels on the same values);
- ``slice``: the streaming COLUMNWISE step ``acc + Omega[:, start:
  start+k] @ block`` with ``start`` a 0-d int64 tensor on the device
  (the slice kernels read it without a host sync) and the block padded
  up to the bucket ladder, so ONE graph serves every batch of a bucket;
  only where the transform's eager step is launch-bound
  (``SketchTransform.slice_steps_launch_bound``: a hash sketch whose
  windows are drawn per step), elsewhere the step stays eager;
- ``rowwise``: the streaming ROWWISE sketch of a bucketed block.

How a plan runs (:class:`SketchPlan`):

- On the card its first call runs the body eagerly once (the warm-up,
  timed through a synchronize as the plan's ``compile_seconds``), then
  captures it on a side stream (one ``trace``); the captured body ends
  by copying its results into static output buffers.  Every call copies
  its inputs into the plan's static buffers, replays the graph on the
  current stream and returns a clone of the static outputs, so a caller
  never holds a buffer that the next replay overwrites, and no plan
  updates an argument in place.  A capture that fails raises; nothing
  falls back to the eager body.
- On the CPU the body is the same eager callable, built once per plan
  and counted as its trace, so the counters read the same.
- The body runs on the plans' own copy of the sketch, rebuilt from the
  key's JSON and shared by the plans of that sketch: its memos (RFT
  shifts, hoisted operands, constants) are filled by a warm-up and
  live as long as a plan holds
  the copy, so a graph never reads a memo that its caller's sketch
  later drops or replaces.
- A capture shares the graph memory pool of the device's live plans,
  and plans share one static buffer per (input or output, argument,
  shape, dtype): replays are serialized, every static buffer lies
  outside the pool and stays referenced, and a graph's intermediates
  (its body's own results among them) are dead once its replay ends.
  The pool keeps the largest body's intermediates for as long as a
  plan lives; ``clear()`` gives them back.
- The cache bounds what the plans hold by bytes (``cache.MAX_BYTES``,
  1 GiB): a call whose plan would hold more than
  the bound (its static input and output) runs eagerly, as a bypass,
  so a large apply costs no second copy of its input on the card.
- The plans compute on a contiguous copy of their input, and a
  bucketed ROWWISE batch runs its GEMM at the bucket's row count:
  cuBLAS may take another algorithm there than at the ragged count, so
  those rows match the eager ragged apply to rounding, not bitwise
  (row-independent kernels, the rfut and hash ones, match bitwise).
- The kernel wrappers count launches in Python (``sketch._launch``): a
  capture's counts are taken back and added once per replay.

``SKYLARK_NO_PLANS=1`` bypasses everything (the entry points run the
eager path and count a ``bypass``).

With telemetry on, a plan's first call is a ``plan`` / ``compile``
event and each planned slice and rowwise step a ``plan`` / ``slice`` or
``rowwise`` event, all outside the captured body, as the JAX package has
them outside ``jit``.  Every :func:`apply`, planned or not, is the span
``sketch.apply``; on the card a plan's capture (its warm-up included)
is ``plans.capture`` and a call's copy-in, replay and copy-out
``plans.replay``.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import weakref

import torch

from .. import telemetry
from .._device import as_tensor, is_sharded
from ..policy.record import _dtype_name, note_plan
from ..sketch import _launch
from ..sketch.base import Dimension, from_json, sketch_registry
from .bucketing import bucket_for, pad_rows
from .cache import PLAN_CACHE

__all__ = [
    "enabled",
    "donation_enabled",
    "fused_enabled",
    "SketchPlan",
    "apply",
    "accumulate_slice",
    "apply_rowwise_bucketed",
    "donating_jit",
    "pad_rows_to_bucket",
    "copy_for_donation",
]


def enabled() -> bool:
    """Plans are on unless ``SKYLARK_NO_PLANS=1`` (read per call, so
    tests and operators can flip it at run time)."""
    return os.environ.get("SKYLARK_NO_PLANS", "").lower() not in ("1", "true")


def fused_enabled() -> bool:
    """Fused stream-chunk steps (``apply_slice_kernel_acc``: the hash
    sketches fold the accumulator add into the row scatter's emit) are
    on unless ``SKYLARK_NO_FUSED_CHUNKS=1``.  Read per call; the flag is
    part of the slice-plan key, so flipping it re-plans."""
    return os.environ.get("SKYLARK_NO_FUSED_CHUNKS", "").lower() not in ("1", "true")


# The hash sketches' routing limits, which a caller may also set on one
# instance; the plan's own copy of the sketch takes the instance's.
_INSTANCE_KNOBS = ("_ONEHOT_LIMIT", "_SLICE_MEMO_LIMIT")


def _instance_knobs(S) -> tuple:
    return tuple((k, S.__dict__[k]) for k in _INSTANCE_KNOBS if k in S.__dict__)


# The env knobs of the GEMM routes (FJLT's subsampled Hadamard, Fastfood's
# realized W, PPT's matmul DFT), read per call by their gates.
_ROUTE_ENV = ("SKYLARK_NO_SRHT_GEMM", "SKYLARK_FRFT_GEMM", "SKYLARK_NO_FRFT_GEMM",
              "SKYLARK_PPT_DFT", "SKYLARK_NO_PPT_DFT")


def _kernel_env_token(S) -> tuple:
    """The routing knobs a captured body bakes in (``S``'s one-hot and
    memo limits where it has them, the rfut kernels' smallest NB, the
    dense engine's realization limit, the GEMM routes' env knobs).  Part
    of every plan key, so a change at run time re-plans rather than
    replaying a graph of the old route; the JAX package keys its slice
    plans on its kernel env knobs the same way."""
    from ..sketch import dense, kernels_fut

    return tuple(getattr(S, k, None) for k in _INSTANCE_KNOBS) + (
        kernels_fut.MIN_NB, dense.MAX_REALIZE_ELEMENTS) + tuple(
        os.environ.get(k, "") for k in _ROUTE_ENV)


def donation_enabled(device=None) -> bool:
    """False: no plan of the port updates an argument in place.  A
    replay's result is copied out of the graph's static output either
    way (a clone, or a copy into a donated accumulator: the same bytes),
    so donating would save nothing.  The name stays for the JAX
    package's API, whose consumers snapshot donated state with
    :func:`copy_for_donation` where it returns True."""
    return False


def _token(S) -> str:
    """The sketch's cache-key identity: its JSON (~100 bytes, fully
    determines the counter streams), memoized per instance."""
    tok = S.__dict__.get("_plan_token")
    if tok is None:
        tok = S.__dict__["_plan_token"] = S.to_json()
    return tok


def _plannable(S) -> bool:
    """A sketch a plan can rebuild from its JSON."""
    return sketch_registry().get(S.sketch_type) is type(S)


def _float_dtype(x) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _tensor_bytes(tree) -> int:
    """The bytes of the tensors in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return 0
    return sum(_tensor_bytes(v) for v in tree)


# -- graph plumbing ---------------------------------------------------------

_RUN_LOCK = threading.RLock()   # copy-in, replay and copy-out of one call
_LIVE: dict = {}                # device -> the captured plans alive there (a WeakSet)
# (device, slot, shape, dtype) -> static buffer, alive while a plan holds it
_STATIC: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _pool(device: torch.device):
    """``(plan, pool)``: a captured plan alive on ``device`` and its graph
    memory pool, to share; ``(None, None)`` (a new pool) when there is
    none.  The caller holds the plan until its capture ends: a pool whose
    graphs are all gone cannot be shared again (it is released to the
    device by ``torch.cuda.empty_cache``)."""
    for plan in _LIVE.get(device, ()):
        return plan, plan.graph.pool()
    return None, None


def _static(device: torch.device, slot, shape, dtype) -> torch.Tensor:
    """The shared static buffer of ``slot`` (``("in", i)``, ``("out",
    i)``) at this shape and dtype (made outside any capture)."""
    key = (device, slot, tuple(shape), dtype)
    buf = _STATIC.get(key)
    if buf is None:
        buf = _STATIC[key] = torch.zeros(tuple(shape), dtype=dtype, device=device)
    return buf


def _copy_in(dst: torch.Tensor, src) -> None:
    """``dst <- src``: a Python int fills a 0-d buffer; a block with fewer
    rows than ``dst`` (a ragged batch into its bucket's buffer) fills
    the leading rows and the rest is zeroed."""
    if isinstance(src, int):
        dst.fill_(src)
    elif src.ndim and src.shape[0] < dst.shape[0]:
        k = src.shape[0]
        dst[:k].copy_(src)
        dst[k:].zero_()
    else:
        dst.copy_(src)


# (token, instance knobs) -> the plans' own copy of that sketch, alive
# while a plan holds it
_SKETCHES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _own_sketch(S, token: str):
    """The plans' own copy of ``S``, one per sketch JSON and routing knobs
    set on the instance (so the plans of its buckets share its memos):
    rebuilt from the JSON with those knobs, or a deep copy where the
    JSON does not rebuild it exactly (NURST renormalizes its
    probabilities)."""
    knobs = _instance_knobs(S)
    R = _SKETCHES.get((token, knobs))
    if R is None:
        R = from_json(token)
        if R.to_json() != token:
            R = copy.deepcopy(S)
        R.__dict__.update(knobs)
        _SKETCHES[(token, knobs)] = R
    return R


class SketchPlan:
    """One planned body ``fn(S, *args)``, ``S`` the plan's own copy of the
    sketch; ``fn`` returns a tensor or a tuple of them.  ``shapes`` and
    ``dtypes`` are the argument signature the plan is keyed on: a block
    may arrive with fewer rows (it is zero-padded), and a 0-d int64 slot
    takes a Python int (the slice start, the true row count).
    Counters: ``calls``, ``traces`` (one capture, or one CPU build),
    ``compile_seconds`` (the first call: the card's eager warm-up, or the
    CPU's first run).  ``held`` maps the buffers the plan keeps (its
    static inputs and outputs, its sketch's memos) to their bytes, for
    the cache's byte bound; on the CPU it lists what the card would
    hold.
    """

    def __init__(self, key, S, token: str, fn, device, shapes, dtypes):
        self.key = key
        self.sketch = _own_sketch(S, token)
        self.fn = fn
        self.device = torch.device(device)
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = list(dtypes)
        self.calls = 0
        self.traces = 0
        self.compile_seconds = 0.0
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.replay_launches: dict = {}
        self.held = {(self.device, ("in", i), s, d): _nbytes(s, d)
                     for i, (s, d) in enumerate(zip(self.shapes, self.dtypes))}
        self._lock = threading.Lock()

    def _first(self, seconds: float, outs) -> None:
        self.compile_seconds = seconds
        PLAN_CACHE.bump("compiles")
        PLAN_CACHE.bump("compile_seconds", seconds)
        if telemetry.enabled():
            telemetry.event("plan", "compile", {"plan": self.key[0], "seconds": round(seconds, 6)})
        self.held.update({(self.device, ("out", i), tuple(o.shape), o.dtype):
                          _nbytes(o.shape, o.dtype) for i, o in enumerate(outs)})
        self.held[("sketch", id(self.sketch))] = _tensor_bytes(self.sketch.__dict__)
        PLAN_CACHE.settle()

    def _traced(self) -> None:
        self.traces += 1
        PLAN_CACHE.bump("traces")

    def _run_cpu(self, args, first: bool):
        t0 = time.perf_counter()
        ins = [torch.tensor(a, dtype=d) if isinstance(a, int)
               else pad_rows(a, s[0]) if a.ndim and a.shape[0] < s[0] else a
               for a, s, d in zip(args, self.shapes, self.dtypes)]
        out = self.fn(self.sketch, *ins)
        if first:
            self._traced()
            self._first(time.perf_counter() - t0, out if isinstance(out, tuple) else (out,))
        return out

    def _capture(self) -> None:
        """Warm up eagerly on the static inputs (the compile), make the
        static outputs, then capture on a side stream into the shared
        pool; the capture's launch counts are taken back and kept as one
        replay's."""
        from ..resilient.chunked import _capture_stream

        dev = self.device
        t0 = time.perf_counter()
        out = self.fn(self.sketch, *self.static_in)
        torch.cuda.synchronize(dev)
        self._tuple = isinstance(out, tuple)
        outs = out if self._tuple else (out,)
        self.static_out = [_static(dev, ("out", i), o.shape, o.dtype)
                           for i, o in enumerate(outs)]
        del out, outs
        self._first(time.perf_counter() - t0, self.static_out)
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        before = _launch.launch_counts()
        owner, pool = _pool(dev)
        with torch.cuda.stream(side):
            # Thread-local: the prefetch pipeline's thread copies the next
            # batch (and waits on its event) while this thread captures.
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = self.fn(self.sketch, *self.static_in)
                for dst, src in zip(self.static_out, out if self._tuple else (out,)):
                    dst.copy_(src)
                del out
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:  # the capture the error above invalidated
                    pass
                raise
            graph.capture_end()
        del owner
        torch.cuda.current_stream(dev).wait_stream(side)
        self.replay_launches = _launch.launch_delta(before, _launch.launch_counts())
        _launch.add_launches(self.replay_launches, -1)
        self.graph = graph
        _LIVE.setdefault(dev, weakref.WeakSet()).add(self)
        self._traced()

    def __call__(self, *args):
        with self._lock:
            first = self.calls == 0
            self.calls += 1
        if self.device.type != "cuda":
            return self._run_cpu(args, first)
        with _RUN_LOCK, telemetry.span("plans.replay"):
            if self.static_in is None:
                self.static_in = [_static(self.device, ("in", i), s, d) for i, (s, d)
                                  in enumerate(zip(self.shapes, self.dtypes))]
            for dst, src in zip(self.static_in, args):
                _copy_in(dst, src)
            if self.graph is None:
                with telemetry.span("plans.capture"):
                    self._capture()
            self.graph.replay()
            _launch.add_launches(self.replay_launches)
            outs = tuple(o.clone() for o in self.static_out)
        return outs if self._tuple else outs[0]


def _get_plan(key, S, token, fn, device, shapes, dtypes) -> SketchPlan:
    return PLAN_CACHE.get_or_build(
        key, lambda: SketchPlan(key, S, token, fn, device, shapes, dtypes))


# -- the three plan kinds ----------------------------------------------------


def apply(S, A, dim: Dimension | str = Dimension.COLUMNWISE):
    """Plan-cached ``S.apply(A, dim)``, bitwise the eager apply.

    Takes the eager apply (counting a ``bypass``) when plans are off,
    when ``A`` is sparse (its output structure depends on the data), when
    the sketch cannot be rebuilt from its JSON, or when the plan would
    hold more than the cache's byte bound (a static copy of ``A`` and of
    the sketch).  A non-tensor ``A`` moves to the default device first,
    as ``S.apply`` moves it.
    """
    with telemetry.span("sketch.apply"):
        return _apply(S, A, Dimension.of(dim))


def _apply(S, A, dim: Dimension):
    if is_sharded(A):  # slot by slot, never captured
        PLAN_CACHE.bump("bypasses")
        return S.apply(A, dim)
    A = as_tensor(A)
    if A.layout == torch.strided:
        axis = 0 if dim is Dimension.COLUMNWISE or A.ndim == 1 else A.ndim - 1
        out_shape = A.shape[:axis] + (S.s,) + A.shape[axis + 1:]
        nbytes = _nbytes(A.shape, A.dtype) + _nbytes(out_shape, _float_dtype(A))
    if (not enabled() or A.layout != torch.strided or not _plannable(S)
            or not PLAN_CACHE.fits(nbytes)):
        PLAN_CACHE.bump("bypasses")
        return S.apply(A, dim)
    token = _token(S)
    key = ("apply", token, dim.value, tuple(A.shape), _dtype_name(A.dtype), str(A.device),
           _kernel_env_token(S))
    note_plan("apply", S, dim=dim.value, shape=tuple(A.shape), dtype=_dtype_name(A.dtype))
    plan = _get_plan(key, S, token, lambda S_, A_: S_.apply(A_, dim), A.device,
                     [A.shape], [A.dtype])
    return plan(A)


def _eager_slice(S, acc, block, start, fused: bool):
    """The unplanned streaming step: dense 2-D blocks of a transform with
    a slice kernel take ``apply_slice_kernel_acc`` (``fused``) or the
    composite ``acc + apply_slice_kernel``, bitwise the same; sparse
    blocks take ``apply_slice``."""
    if (block.layout != torch.strided or block.ndim != 2
            or not getattr(S, "supports_slice_kernel", False)):
        return acc + S.apply_slice(block, int(start), Dimension.COLUMNWISE).to(acc.dtype)
    if fused:
        return S.apply_slice_kernel_acc(acc, block, start)
    return acc + S.apply_slice_kernel(block, start).to(acc.dtype)


def plans_slices(S) -> bool:
    """Whether :func:`accumulate_slice` captures ``S``'s dense 2-D steps
    (plans on, a slice kernel whose eager step is launch-bound, N under
    2^31, a sketch its JSON rebuilds); the warm start replays only
    such slice records."""
    return (enabled() and getattr(S, "supports_slice_kernel", False) and S.n < 1 << 31
            and _plannable(S) and S.slice_steps_launch_bound())


def accumulate_slice(S, acc, block, start, *, donate: bool | None = None,
                     true_rows: int | None = None, fused: bool | None = None):
    """One streaming COLUMNWISE step, planned: ``acc + S.apply_slice(block,
    start)`` (cast to ``acc.dtype``) through one graph per bucket with
    ``start`` on the device, returned as a new tensor.

    The block is zero-padded up to the bucket ladder; the slice kernel
    zeroes any operand window past the sketch domain and padded rows are
    exact zeros, so the padded contribution is exactly 0.  A block
    already padded by ``pipeline.bucketed_placer`` passes its real row
    count as ``true_rows``.  ``fused`` (default :func:`fused_enabled`)
    takes ``S.apply_slice_kernel_acc``, bitwise the composite.
    ``donate`` is taken for the JAX package's signature and ignored
    (:func:`donation_enabled`).  The eager step (a ``bypass``) serves
    sparse blocks, transforms whose step :func:`plans_slices` does not
    capture, plans off, and a plan over the cache's byte bound.
    """
    if fused is None:
        fused = fused_enabled()
    k = block.shape[0]
    dense = block.layout == torch.strided and block.ndim == 2
    if dense:
        shape = (bucket_for(k),) + tuple(block.shape[1:])
        nbytes = 2 * _nbytes(acc.shape, acc.dtype) + _nbytes(shape, block.dtype)
    if not dense or not plans_slices(S) or not PLAN_CACHE.fits(nbytes):
        PLAN_CACHE.bump("bypasses")
        if true_rows is not None and true_rows != k:
            block = block[:true_rows]
        return _eager_slice(S, acc, block, start, fused)
    token = _token(S)
    key = ("slice", token, shape, _dtype_name(block.dtype), _dtype_name(acc.dtype),
           str(acc.device), bool(fused), _kernel_env_token(S))
    note_plan("slice", S, shape=shape, dtype=_dtype_name(block.dtype),
              acc_dtype=_dtype_name(acc.dtype))

    def fn(S_, acc_, block_, start_):
        return _eager_slice(S_, acc_, block_, start_, fused)

    plan = _get_plan(key, S, token, fn, acc.device, [acc.shape, shape, ()],
                     [acc.dtype, block.dtype, torch.int64])
    if telemetry.enabled():
        telemetry.event("plan", "slice", {"bucket": shape[0], "rows": k, "fused": bool(fused)})
    return plan(acc, block, int(start))


def apply_rowwise_bucketed(S, block, *, pad_out: bool = False, true_rows: int | None = None):
    """One streaming ROWWISE batch, planned: the block's rows padded up to
    the bucket ladder, one graph per bucket, and the true rows returned.

    ``pad_out=False`` returns the ``(k, S)`` sketch of the true rows:
    row-independent kernels make every real row bitwise the eager ragged
    apply (bucketing never crosses a transform's ``batch_size_gates``,
    so the algorithm matches too); a GEMM at the bucket's row count may
    round its rows differently (the module docstring).  ``pad_out=True`` returns ``(Z, k)``
    with the padded rows of ``Z`` zeroed: the fixed-shape form consumers
    feed their own updates (the streaming KRR Gram).  A block already
    padded host-side passes its real row count as ``true_rows``.  Plans
    off, a sparse or non-2-D block, a sketch its JSON does not rebuild
    and a plan over the cache's byte bound take the eager apply (a
    ``bypass``).
    """
    k = block.shape[0] if true_rows is None else int(true_rows)
    dense = block.layout == torch.strided and block.ndim == 2
    if dense:
        kb = bucket_for(k, getattr(S, "batch_size_gates", ()))
        shape = (kb,) + tuple(block.shape[1:])
        nbytes = _nbytes(shape, block.dtype) + _nbytes((kb, S.s), _float_dtype(block))
    if not enabled() or not dense or not _plannable(S) or not PLAN_CACHE.fits(nbytes):
        PLAN_CACHE.bump("bypasses")
        if k != block.shape[0]:
            block = block[:k]
        ops = S.hoistable_operands(_float_dtype(block), block.device)
        Z = S.apply_with_operands(ops, block, Dimension.ROWWISE)
        return (Z, k) if pad_out else Z
    if block.shape[0] not in (k, kb):
        # Host padding that disagrees with this transform's gates: keep the
        # real rows and bucket them under the right gates.
        block = block[:k]
    token = _token(S)
    key = ("rowwise", token, shape, _dtype_name(block.dtype), str(block.device),
           bool(pad_out), _kernel_env_token(S))
    note_plan("rowwise", S, shape=shape, dtype=_dtype_name(block.dtype))

    def fn(S_, block_, k_):
        ops = S_.hoistable_operands(_float_dtype(block_), block_.device)
        Z = S_.apply_with_operands(ops, block_, Dimension.ROWWISE)
        if not pad_out:
            return Z
        valid = torch.arange(kb, device=Z.device) < k_
        return torch.where(valid[:, None], Z, torch.zeros((), dtype=Z.dtype, device=Z.device))

    plan = _get_plan(key, S, token, fn, block.device, [shape, ()], [block.dtype, torch.int64])
    if telemetry.enabled():
        telemetry.event("plan", "rowwise", {"bucket": kb, "rows": k})
    Z = plan(block, k)
    if pad_out:
        return Z, k
    return Z if k == kb else Z[:k]


def donating_jit(fn, donate_argnums: tuple = ()):
    """``fn`` itself: torch has no jit to donate buffers to.  Kept for the
    JAX package's signature (its consumers wrap accumulator updates)."""
    return fn


def pad_rows_to_bucket(block, gates: tuple = ()):
    """``(padded_block, true_rows)`` on the ladder."""
    k = int(block.shape[0])
    return pad_rows(block, bucket_for(k, gates)), k


def copy_for_donation(tree):
    """A copy of every tensor leaf of a nest of dicts, lists and tuples:
    the snapshot a consumer keeps of state that a donating step will
    update in place (the streaming engine's chunk-entry accumulator,
    which the guard's replay reads again)."""
    if isinstance(tree, dict):
        return {k: copy_for_donation(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(copy_for_donation(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree
