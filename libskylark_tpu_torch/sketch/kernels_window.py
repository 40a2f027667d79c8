"""Row scatter-accumulate and scaled row gather (port of
``libskylark_tpu/sketch/pallas_window.py``).

``scatter_rows`` (hash sketches, dense apply, scatter branch) and
``gather_scaled_rows`` (FJLT columnwise epilogue) are CUDA C++ kernels
in ``csrc/window.cu``.  Each wrapper launches its kernels for a CUDA
tensor and counts the call in its ``launches`` attribute; a CPU tensor
takes the plain PyTorch version beside it.

``scatter_rows`` adds each output row's entries in the JAX kernel's
order (entry ``e = i·nnz + h``: row i ascending, hash h innermost) with
no float atomics, in two passes.  Pass 1 (:func:`scatter_partition`)
orders the entries stably by bucket: an LSD radix partition in passes
of at most 8 bucket bits (:func:`_plan`), each a count kernel, an int32
``torch.cumsum`` of its (digits, tiles) table and a place kernel that
ranks a tile of ``_TILE`` entries in shared memory; a last kernel finds
where each bucket starts and cuts buckets of more than ``_L`` entries
into pieces.  Pass 2 walks each piece's rows in order and adds
``v·A[i, :]`` in registers (a block per piece for wide rows, a warp per
piece and column for narrow ones), so A is read once per hash and the
bucket ids once in all.  Where no bucket exceeds ``_L`` entries the
result is bitwise :func:`scatter_rows_plain` on CPU copies of the
inputs; a longer bucket's pieces are added in piece order.

``gather_scaled_rows`` is one launch: a block per output row and 1024
columns where a row has at least 256 elements, else a thread per output
element (m = 1 for the LS solve's b).

No VMEM-style gate applies on the card: both kernels serve any shape
below the int32 index limits checked here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _launch

__all__ = [
    "scatter_rows",
    "scatter_rows_plain",
    "scatter_partition",
    "scatter_partition_plain",
    "gather_scaled_rows",
    "gather_scaled_rows_plain",
]

_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = _launch.P, _launch.I, _launch.F
_SIGNATURES = {
    "skylark_scatter_count": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "skylark_scatter_place": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "skylark_scatter_seg_start": [_P, _P, _I, _I, _P, _P, _P],
    **{f"skylark_scatter_walk_{s}": [_P] * 8 + [_I] * 6 + [_P] for s in _SUFFIX.values()},
    **{f"skylark_gather_scaled_rows_{s}": [_P, _P, _P, _I, _I, _I, _F, _P]
       for s in _SUFFIX.values()},
}
_INT32_MAX = (1 << 31) - 1
_MAX_COL_TILES = 65535  # the kernels put column tiles on grid.y
_TILE = 2048            # entries per pass-1 tile: PT_TILE in csrc/window.cu
_DIGIT_BITS = 8         # bucket bits per pass-1 pass, at most (PT_DIGITS = 256)
_L = 4096               # entries per pass-2 piece, at most


class _Plan(NamedTuple):
    digits: tuple   # (shift, digit count) of each LSD pass, low bits first
    tiles: int      # pass-1 tiles of _TILE entries
    pieces: int     # pass-2 pieces, at most: S + E // _L
    parts: int      # workspace rows for pieces >= 1 of cut buckets: max(1, E // _L)


def _plan(entries: int, num_segments: int) -> _Plan:
    """Sizes of both passes for E = entries >= 1 into S = num_segments
    >= 1 buckets.  The bucket's (S - 1).bit_length() bits are cut into
    the fewest passes of at most ``_DIGIT_BITS``, as even as possible;
    each count table holds digits x tiles <= 256 * ceil(E / _TILE) ints.
    A bucket of n entries takes max(1, ceil(n / _L)) pieces, at most
    1 + n // _L, so S + E // _L bounds them all and E // _L the pieces
    after the first of the buckets cut into several, which are kept in
    a workspace."""
    bits = (num_segments - 1).bit_length()
    passes = max(1, -(-bits // _DIGIT_BITS))
    per = -(-bits // passes)
    digits = tuple((p * per, 1 << min(per, bits - p * per)) for p in range(passes))
    return _Plan(digits=digits, tiles=-(-entries // _TILE),
                 pieces=num_segments + entries // _L, parts=max(1, entries // _L))


def _stacked(b, v):
    if b.ndim == 1:
        b, v = b[None, :], v[None, :]
    if b.shape != v.shape:
        raise ValueError(f"b/v shape mismatch: {tuple(b.shape)} vs {tuple(v.shape)}")
    return b, v


def scatter_rows_plain(A, b, v, num_segments: int, *, acc=None):
    """Plain version of :func:`scatter_rows`: the f32 rows ``v·A`` in the
    JAX kernel's entry order (row i ascending, hash h innermost) added
    by ``index_add_``.  Entries with buckets outside [0, num_segments)
    are dropped, as the kernel drops them."""
    b, v = _stacked(b, v)
    m = A.shape[1]
    rows = (v.T.to(torch.float32)[:, :, None] * A.to(torch.float32)[:, None, :]).reshape(-1, m)
    flat = b.T.reshape(-1).long()
    keep = (flat >= 0) & (flat < num_segments)
    out = torch.zeros((num_segments, m), dtype=torch.float32, device=A.device)
    out.index_add_(0, flat[keep], rows[keep])
    return out if acc is None else acc + out


def scatter_partition_plain(b, num_segments: int):
    """Plain version of :func:`scatter_partition`: a stable ``torch.sort``
    on the bucket of the entries e = i·nnz + h with buckets in range.
    The sorted arrays are E long; past ``seg_start[S]`` they hold
    zeros."""
    if b.ndim == 1:
        b = b[None, :]
    flat = b.T.reshape(-1)
    n_all = flat.shape[0]
    keep = (flat >= 0) & (flat < num_segments)
    ents = torch.arange(n_all, dtype=torch.int32, device=b.device)[keep]
    keys = flat[keep]
    order = torch.sort(keys, stable=True).indices
    sorted_keys = torch.zeros(n_all, dtype=torch.int32, device=b.device)
    sorted_ents = torch.zeros(n_all, dtype=torch.int32, device=b.device)
    sorted_keys[:keys.shape[0]] = keys[order]
    sorted_ents[:keys.shape[0]] = ents[order]
    counts = torch.bincount(keys.long(), minlength=num_segments)
    seg_start = torch.zeros(num_segments + 1, dtype=torch.int32, device=b.device)
    seg_start[1:] = torch.cumsum(counts, 0)
    return sorted_keys, sorted_ents, seg_start


def _check(b, num_segments: int, dev):
    _launch.check(b, "b", device=dev, dtypes=(torch.int32,), ndim=2)
    entries = b.numel()
    if (not 1 <= num_segments < _INT32_MAX or entries > _INT32_MAX - _TILE
            or num_segments + entries // _L >= _INT32_MAX):
        raise ValueError(f"scatter_rows kernel does not take {entries} entries into "
                         f"{num_segments} buckets")


def _partition(b, num_segments: int, plan: _Plan):
    """Pass 1 on (nnz, k) int32 ``b``: ``(sorted_keys, sorted_ents,
    seg_start, pieces)``."""
    dev = b.device
    nnz, k = b.shape
    entries = nnz * k
    lib = _launch.library("window", _SIGNATURES)
    keys, ents, total = b, None, None
    for shift, nd in plan.digits:
        counts = torch.empty(nd * plan.tiles, dtype=torch.int32, device=dev)
        args = (keys.data_ptr(), _launch.ptr(ents), _launch.ptr(total), entries, k, nnz,
                num_segments, shift, nd, plan.tiles)
        _launch.run(lib.skylark_scatter_count, dev, *args, counts.data_ptr())
        cum = torch.cumsum(counts, 0, dtype=torch.int32)
        out_keys = torch.empty(entries, dtype=torch.int32, device=dev)
        out_ents = torch.empty(entries, dtype=torch.int32, device=dev)
        _launch.run(lib.skylark_scatter_place, dev, *args, cum.data_ptr(),
                    out_keys.data_ptr(), out_ents.data_ptr())
        keys, ents, total = out_keys, out_ents, cum[-1:]  # total: the kept count
    seg_start = torch.empty(num_segments + 1, dtype=torch.int32, device=dev)
    pieces = torch.empty(num_segments, dtype=torch.int32, device=dev)
    _launch.run(lib.skylark_scatter_seg_start, dev, keys.data_ptr(), total.data_ptr(),
                num_segments, _L, seg_start.data_ptr(), pieces.data_ptr())
    return keys, ents, seg_start, pieces


def scatter_partition(b: torch.Tensor, num_segments: int):
    """Pass 1 of :func:`scatter_rows` alone: ``(sorted_keys, sorted_ents,
    seg_start)``, the entries e = i·nnz + h of ``b`` ((k,) or (nnz, k)
    int32) with buckets in [0, num_segments), ordered stably by bucket,
    and where each bucket starts (S + 1 int32).  The sorted arrays are E
    long; past ``seg_start[S]`` their contents are unspecified.  A CPU
    tensor takes :func:`scatter_partition_plain`.  It is public so that
    its time can be read apart from pass 2's; it does not count
    launches."""
    if b.device.type == "cpu":
        return scatter_partition_plain(b, num_segments)
    if b.ndim == 1:
        b = b[None, :]
    b = b.contiguous()
    _check(b, num_segments, b.device)
    if b.numel() == 0:
        dev = b.device
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(num_segments + 1, dtype=torch.int32, device=dev))
    return _partition(b, num_segments, _plan(b.numel(), num_segments))[:3]


def scatter_rows(A: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                 num_segments: int, *, acc: torch.Tensor | None = None):
    """``out[t, :] = Σ_{h,i: b[h,i]==t} v[h,i]·A[i, :]`` in f32, the terms
    of each row added in the order e = i·nnz + h, identical run to run.
    ``A`` (k, m) f32/bf16; ``b`` int32 and ``v`` f32, (k,) or stacked
    (nnz, k); buckets outside [0, num_segments) are dropped by the
    kernel.  ``acc`` (num_segments, m) f32, when given, is folded into
    the emit: the result is bitwise ``acc + scatter_rows(A, b, v,
    num_segments)``."""
    if acc is not None and acc.dtype != torch.float32:
        raise TypeError(f"fused acc must be float32, got {acc.dtype}")
    b, v = _stacked(b, v)
    if A.device.type == "cpu":
        return scatter_rows_plain(A, b, v, num_segments, acc=acc)
    dev = A.device
    _launch.check(A, "A", device=dev, dtypes=_DTYPES, ndim=2)
    b, v = b.contiguous(), v.contiguous()
    _launch.check(v, "v", device=dev, dtypes=(torch.float32,), ndim=2)
    k, m = A.shape
    nnz = b.shape[0]
    if b.shape[1] != k:
        raise ValueError(f"b has {b.shape[1]} entries per hash, A has {k} rows")
    if acc is not None:
        _launch.check(acc, "acc", device=dev, dtypes=(torch.float32,), ndim=2)
        if tuple(acc.shape) != (num_segments, m):
            raise ValueError(f"acc must be ({num_segments}, {m}), got "
                             f"{tuple(acc.shape)}")
    if num_segments == 0 or m == 0:
        return torch.empty((num_segments, m), dtype=torch.float32, device=dev)
    _check(b, num_segments, dev)
    if -(-m // 512) > _MAX_COL_TILES:  # the wide walk's 512-column tiles
        raise ValueError(f"scatter_rows kernel does not take m={m}")
    if nnz * k == 0:  # nothing to add
        out = torch.zeros((num_segments, m), dtype=torch.float32, device=dev)
        return out if acc is None else acc + out
    plan = _plan(nnz * k, num_segments)
    _, sents, seg_start, pieces = _partition(b, num_segments, plan)
    piece_cum = torch.cumsum(pieces, 0, dtype=torch.int32)
    out = torch.empty((num_segments, m), dtype=torch.float32, device=dev)
    parts = torch.empty((plan.parts, m), dtype=torch.float32, device=dev)
    lib = _launch.library("window", _SIGNATURES)
    fn = getattr(lib, f"skylark_scatter_walk_{_SUFFIX[A.dtype]}")
    _launch.run(fn, dev, A.data_ptr(), v.data_ptr(), sents.data_ptr(), seg_start.data_ptr(),
                piece_cum.data_ptr(), _launch.ptr(acc), out.data_ptr(), parts.data_ptr(),
                k, m, nnz, num_segments, _L, plan.pieces)
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


def gather_scaled_rows_plain(T, idx, scale: float):
    """Plain version of :func:`gather_scaled_rows`."""
    return T.index_select(0, idx.long()) * torch.tensor(scale, dtype=T.dtype,
                                                        device=T.device)


def gather_scaled_rows(T: torch.Tensor, idx: torch.Tensor, scale: float):
    """``out[j, :] = scale · T[idx[j], :]`` with ``scale`` rounded to
    T's dtype — bitwise equal to ``T.index_select(0, idx) * scale``.
    ``T`` (nrows, m) f32/bf16, ``idx`` int32 (S,) in [0, nrows); on the
    card an index outside that range gives a row of NaN."""
    if T.device.type == "cpu":
        return gather_scaled_rows_plain(T, idx, scale)
    dev = T.device
    _launch.check(T, "T", device=dev, dtypes=_DTYPES, ndim=2)
    _launch.check(idx, "idx", device=dev, dtypes=(torch.int32,), ndim=1)
    nrows, m = T.shape
    s = idx.shape[0]
    if max(nrows, m, s) > _INT32_MAX:
        raise ValueError(f"gather kernel does not take T {tuple(T.shape)}, S={s}")
    out = torch.empty((s, m), dtype=T.dtype, device=dev)
    if s == 0 or m == 0:
        return out
    scale_t = float(torch.tensor(scale, dtype=T.dtype))
    lib = _launch.library("window", _SIGNATURES)
    fn = getattr(lib, f"skylark_gather_scaled_rows_{_SUFFIX[T.dtype]}")
    _launch.run(fn, dev, T.data_ptr(), idx.data_ptr(), out.data_ptr(),
                nrows, m, s, scale_t)
    gather_scaled_rows.launches += 1
    return out


gather_scaled_rows.launches = 0
