"""Flat segment sum (port of ``libskylark_tpu/sketch/pallas_scatter.py``).

``segment_sum_flat`` is the scatter-add behind every sparse hash sketch
(``hash._apply_sparse_dense_out``) and the graph adjacency fold: ``out[t]
= Σ vals[keys == t]`` over 10^7 to 10^8 entries.  On a CUDA tensor it
launches the CUDA C++ kernel in ``csrc/scatter.cu`` and counts the call
in its ``launches`` attribute; a CPU tensor takes the plain version
beside it, an f32 ``index_add_``.

It replaces the TPU kernel's two passes (``_partition_kernel``,
``_accumulate_kernel``).  What bounds it on the H100 is bytes: 8 per
entry read and 4 per slot written, over 3.35 TB/s.  The kernel has to be
identical run to run, so it uses no float atomics.  Pass 1 partitions
the entries stably by slot range (V slots, sized to a block's shared
memory), with an integer count table prefix-summed by ``torch.cumsum``
in between; pass 2 gives each partition one block, which adds its
entries into shared memory in input order and writes its slots once.
The TPU gate ``supported()`` (VMEM size, amortising two passes) has no
counterpart: on the card the kernel serves every size within the int32
limits checked here.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch

__all__ = ["segment_sum_flat", "segment_sum_flat_plain", "partition"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_P, _I, _L = _launch.P, _launch.I, ctypes.c_longlong
_SIGNATURES = {
    "skylark_segment_count": [_P, _L, _I, _I, _I, _I, _P, _P],
    **{f"skylark_segment_place_{s}": [_P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P]
       for s in _SUFFIX.values()},
    "skylark_segment_accumulate": [_P, _P, _P, _I, _I, _I, _P, _P],
}
_INT32_MAX = (1 << 31) - 1
_V = 16384          # slots per partition: SS_V in csrc/scatter.cu
_MIN_CHUNK = 4096   # entries per pass-1 warp, at least


def _plan(nnz: int, num_segments: int) -> tuple[int, int, int]:
    """``(P, C, K)``: partitions of ``_V`` slots, entries per pass-1 chunk
    and chunks.  C grows with P so that the (P, K) count table holds at
    most about nnz / 2 ints."""
    P = -(-num_segments // _V)
    C = max(_MIN_CHUNK, -(-2 * P // 32) * 32)
    return P, C, -(-nnz // C)


def segment_sum_flat_plain(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """Plain version of :func:`segment_sum_flat` (f32 ``index_add_``)."""
    out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
    out.index_add_(0, keys.long(), vals.to(torch.float32))
    return out.to(vals.dtype) if vals.dtype in _SUFFIX else out


def _check(vals, keys, num_segments: int):
    dev = vals.device
    _launch.check(vals, "vals", device=dev, dtypes=tuple(_SUFFIX), ndim=1)
    _launch.check(keys, "keys", device=dev, dtypes=(torch.int32,), ndim=1)
    if keys.shape != vals.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and vals {tuple(vals.shape)} differ")
    if not 0 <= num_segments <= _INT32_MAX or vals.shape[0] > _INT32_MAX:
        raise ValueError(f"segment_sum_flat kernel does not take nnz={vals.shape[0]}, "
                         f"num_segments={num_segments}")


def partition(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """Pass 1 alone, on CUDA tensors: ``(sorted_keys, sorted_vals_f32,
    part_start)``, the entries with keys in range ordered stably by
    partition (``key // V``) and where each partition starts (P + 1
    int32).  :func:`segment_sum_flat` runs it; it is public so that its
    time can be read apart from pass 2's."""
    _check(vals, keys, num_segments)
    dev = vals.device
    nnz = vals.shape[0]
    P, C, K = _plan(nnz, num_segments)
    lib = _launch.library("scatter", _SIGNATURES)
    counts = torch.zeros(P * K, dtype=torch.int32, device=dev)
    _launch.run(lib.skylark_segment_count, dev, keys.data_ptr(), nnz, num_segments,
                _V, C, K, counts.data_ptr())
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    total = offs[-1:].clone()
    offs.sub_(counts)  # exclusive: offs[p*K + k] is chunk k's start in partition p
    part_start = torch.cat([offs.view(P, K)[:, 0], total])
    skeys = torch.empty(nnz, dtype=torch.int32, device=dev)
    svals = torch.empty(nnz, dtype=torch.float32, device=dev)
    fn = getattr(lib, f"skylark_segment_place_{_SUFFIX[vals.dtype]}")
    _launch.run(fn, dev, keys.data_ptr(), vals.data_ptr(), nnz, num_segments, _V, C, K,
                offs.data_ptr(), skeys.data_ptr(), svals.data_ptr())
    return skeys, svals, part_start


def segment_sum_flat(vals: torch.Tensor, keys: torch.Tensor, num_segments: int):
    """``out[t] = Σ vals[keys == t]`` for 1-D ``vals`` (f32/bf16/f16) and
    int32 ``keys`` in [0, num_segments) of equal length, accumulated in
    f32 and returned in vals' dtype (the f32-accumulate boundary cast of
    ``pallas_scatter.py:233-238``).  Identical run to run on the card:
    each slot adds its entries in input order.  Keys outside the range
    are dropped by the kernel; the plain version raises on them."""
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
