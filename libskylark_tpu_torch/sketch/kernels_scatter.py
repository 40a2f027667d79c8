"""Flat segment sum (port of ``libskylark_tpu/sketch/pallas_scatter.py``).

``segment_sum_flat`` is the scatter-add behind every sparse hash sketch
(``hash._apply_sparse_dense_out``) and the graph adjacency fold: ``out[t]
= Σ vals[keys == t]`` over 10^7 to 10^8 entries.  On a CUDA tensor it
launches the CUDA C++ kernels in ``csrc/scatter.cu`` and counts the call
in its ``launches`` attribute; a CPU tensor takes the plain version
beside it, an f32 ``index_add_``.

It replaces the TPU kernel's two passes (``_partition_kernel``,
``_accumulate_kernel``).  What bounds it on the H100 is bytes: 8 per
entry read and 4 per slot written, over 3.35 TB/s.  The kernel has to be
identical run to run, so it uses no float atomics.  Pass 1
(:func:`partition`) orders the entries stably by slot range of ``_V``
slots (sized to a block's shared memory).  A one-level partition into
~10^4 ranges scatters every entry, so it runs in two levels, each a
count kernel, an integer ``torch.cumsum`` of the count table and a place
kernel that ranks a tile of ``_TILE`` entries in shared memory and
writes each digit's run contiguously: first by coarse bucket (at most
``_MAX_BUCKETS``), then by range within each bucket, with tiles that
never cross a bucket.  :func:`_plan` sizes both levels; grids are upper
bounds, so nothing waits on the host.  Pass 2 gives each partition one
block, which adds each slot's entries in input order, group by group,
with no sort, and writes its slots once.  The TPU gate ``supported()``
(VMEM size, amortising two passes) has no counterpart: on the card the
kernel serves every size within the int32 limits checked here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _launch

__all__ = ["segment_sum_flat", "segment_sum_flat_plain", "partition", "partition_plain"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_P, _I, _L = _launch.P, _launch.I, ctypes.c_longlong
_SIGNATURES = {
    "skylark_segment_count_coarse": [_P, _L, _I, _I, _I, _I, _P, _P],
    **{f"skylark_segment_place_coarse_{s}": [_P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P]
       for s in _SUFFIX.values()},
    "skylark_segment_count_fine": [_P, _I, _I, _P, _I, _I, _P, _P],
    "skylark_segment_place_fine": [_P, _P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P],
    "skylark_segment_accumulate": [_P, _P, _P, _I, _I, _I, _P, _P],
}
_INT32_MAX = (1 << 31) - 1
_V = 16384            # slots per partition: SS_V in csrc/scatter.cu
_TILE = 8192          # entries per pass-1 tile: PT_TILE
_MAX_BUCKETS = 256    # coarse buckets of level 1, at most


class _Plan(NamedTuple):
    parts: int      # P: partitions of _V slots
    shift: int      # a key's coarse bucket is key >> shift
    buckets: int    # coarse buckets, at most _MAX_BUCKETS
    fine: int       # partitions per coarse bucket, 2^shift / _V
    tiles1: int     # level-1 tiles of _TILE entries
    tiles2: int     # level-2 tiles, at most (each bucket is cut on its own)


def _plan(nnz: int, num_segments: int) -> _Plan:
    """Sizes of both pass-1 levels for nnz >= 1 entries into T =
    num_segments >= 1 slots.  The coarse bucket spans 2^shift slots, a
    multiple of ``_V``, the least that leaves at most ``_MAX_BUCKETS``
    buckets; the count tables hold buckets x tiles1 and fine x tiles2
    ints.  A bucket of n entries has max(1, ceil(n / _TILE)) level-2
    tiles, so tiles2 = tiles1 + buckets bounds their sum."""
    shift = max(_V.bit_length() - 1,
                (num_segments - 1).bit_length() - (_MAX_BUCKETS.bit_length() - 1))
    buckets = ((num_segments - 1) >> shift) + 1
    tiles1 = -(-nnz // _TILE)
    return _Plan(parts=-(-num_segments // _V), shift=shift, buckets=buckets,
                 fine=1 << (shift - (_V.bit_length() - 1)), tiles1=tiles1,
                 tiles2=tiles1 + buckets)


def segment_sum_flat_plain(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """Plain version of :func:`segment_sum_flat` (f32 ``index_add_``)."""
    out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
    out.index_add_(0, keys.long(), vals.to(torch.float32))
    return out.to(vals.dtype) if vals.dtype in _SUFFIX else out


def partition_plain(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """Plain version of :func:`partition`: a stable ``torch.sort`` on
    ``key // V`` of the entries with keys in range.  The sorted arrays
    are nnz long; past ``part_start[P]`` they hold zeros."""
    nnz = keys.shape[0]
    keep = (keys >= 0) & (keys < num_segments)
    k, v = keys[keep], vals[keep].to(torch.float32)
    part = k.long() // _V
    order = torch.sort(part, stable=True).indices
    sorted_keys = torch.zeros(nnz, dtype=torch.int32, device=keys.device)
    sorted_vals = torch.zeros(nnz, dtype=torch.float32, device=keys.device)
    sorted_keys[:k.shape[0]] = k[order]
    sorted_vals[:k.shape[0]] = v[order]
    counts = torch.bincount(part, minlength=-(-num_segments // _V))
    part_start = torch.zeros(counts.shape[0] + 1, dtype=torch.int32, device=keys.device)
    part_start[1:] = torch.cumsum(counts, 0)
    return sorted_keys, sorted_vals, part_start


def _check(vals, keys, num_segments: int):
    dev = vals.device
    _launch.check(vals, "vals", device=dev, dtypes=tuple(_SUFFIX), ndim=1)
    _launch.check(keys, "keys", device=dev, dtypes=(torch.int32,), ndim=1)
    if keys.shape != vals.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and vals {tuple(vals.shape)} differ")
    if not 0 <= num_segments <= _INT32_MAX or vals.shape[0] > _INT32_MAX:
        raise ValueError(f"segment_sum_flat kernel does not take nnz={vals.shape[0]}, "
                         f"num_segments={num_segments}")


def _level1(vals, keys, num_segments: int, plan: _Plan):
    """Coarse level: ``(keys1, vals1, cum1)``, the entries in range
    ordered stably by ``key >> shift`` and the inclusive cumsum of the
    (buckets, tiles1) count table, where each bucket starts."""
    dev, nnz = vals.device, vals.shape[0]
    lib = _launch.library("scatter", _SIGNATURES)
    counts = torch.empty(plan.buckets * plan.tiles1, dtype=torch.int32, device=dev)
    _launch.run(lib.skylark_segment_count_coarse, dev, keys.data_ptr(), nnz, num_segments,
                plan.shift, plan.buckets, plan.tiles1, counts.data_ptr())
    cum1 = torch.cumsum(counts, 0, dtype=torch.int32)
    keys1 = torch.empty(nnz, dtype=torch.int32, device=dev)
    vals1 = torch.empty(nnz, dtype=torch.float32, device=dev)
    fn = getattr(lib, f"skylark_segment_place_coarse_{_SUFFIX[vals.dtype]}")
    _launch.run(fn, dev, keys.data_ptr(), vals.data_ptr(), nnz, num_segments, plan.shift,
                plan.buckets, plan.tiles1, cum1.data_ptr(), keys1.data_ptr(), vals1.data_ptr())
    return keys1, vals1, cum1


def _level2(keys1, vals1, cum1, plan: _Plan):
    """Fine level: :func:`partition`'s result from :func:`_level1`'s."""
    dev, nnz = keys1.device, keys1.shape[0]
    lib = _launch.library("scatter", _SIGNATURES)
    counts = torch.empty(plan.fine * plan.tiles2, dtype=torch.int32, device=dev)
    _launch.run(lib.skylark_segment_count_fine, dev, keys1.data_ptr(), plan.tiles1,
                plan.buckets, cum1.data_ptr(), plan.fine, plan.tiles2, counts.data_ptr())
    cum2 = torch.cumsum(counts, 0, dtype=torch.int32)
    skeys = torch.empty(nnz, dtype=torch.int32, device=dev)
    svals = torch.empty(nnz, dtype=torch.float32, device=dev)
    part_start = torch.empty(plan.parts + 1, dtype=torch.int32, device=dev)
    _launch.run(lib.skylark_segment_place_fine, dev, keys1.data_ptr(), vals1.data_ptr(),
                plan.tiles1, plan.buckets, cum1.data_ptr(), plan.fine, plan.tiles2,
                cum2.data_ptr(), plan.parts, skeys.data_ptr(), svals.data_ptr(),
                part_start.data_ptr())
    return skeys, svals, part_start


def partition(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """Pass 1 alone: ``(sorted_keys, sorted_vals_f32, part_start)``, the
    entries with keys in range ordered stably by partition (``key //
    V``) and where each partition starts (P + 1 int32).  The sorted
    arrays are nnz long; past ``part_start[P]`` their contents are
    unspecified.  A CPU tensor takes :func:`partition_plain`.
    :func:`segment_sum_flat` runs it; it is public so that its time can
    be read apart from pass 2's, and it does not count launches."""
    if vals.device.type == "cpu":
        return partition_plain(vals, keys, num_segments)
    _check(vals, keys, num_segments)
    nnz = vals.shape[0]
    if nnz == 0 or num_segments == 0:  # nothing to place
        dev = vals.device
        return (torch.empty(nnz, dtype=torch.int32, device=dev),
                torch.empty(nnz, dtype=torch.float32, device=dev),
                torch.zeros(-(-num_segments // _V) + 1, dtype=torch.int32, device=dev))
    plan = _plan(nnz, num_segments)
    return _level2(*_level1(vals, keys, num_segments, plan), plan)


def segment_sum_flat(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """``out[t] = Σ vals[keys == t]`` for 1-D ``vals`` (f32/bf16/f16) and
    int32 ``keys`` in [0, num_segments) of equal length, accumulated in
    f32 and returned in vals' dtype (the f32-accumulate boundary cast of
    ``pallas_scatter.py:233-238``).  Identical run to run on the card:
    each slot adds, group by group, the in-order sum of its entries.
    Keys outside the range are dropped by the kernel; the plain version
    raises on them."""
    if vals.device.type == "cpu":
        return segment_sum_flat_plain(vals, keys, num_segments)
    _check(vals, keys, num_segments)
    dev = vals.device
    out = torch.empty(num_segments, dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out.to(vals.dtype)
    if vals.shape[0] == 0:
        return out.zero_().to(vals.dtype)
    skeys, svals, part_start = partition(vals, keys, num_segments)
    lib = _launch.library("scatter", _SIGNATURES)
    _launch.run(lib.skylark_segment_accumulate, dev, skeys.data_ptr(), svals.data_ptr(),
                part_start.data_ptr(), num_segments, _V, part_start.shape[0] - 1,
                out.data_ptr())
    segment_sum_flat.launches += 1
    return out.to(vals.dtype)


segment_sum_flat.launches = 0
