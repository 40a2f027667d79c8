"""Row scatter-accumulate and scaled row gather (port of
``libskylark_tpu/sketch/pallas_window.py``).

``scatter_rows`` (hash sketches, dense apply, scatter branch) and
``gather_scaled_rows`` (FJLT columnwise epilogue) are CUDA C++ kernels
in ``csrc/window.cu``.  Each wrapper launches its kernel for a CUDA
tensor and counts the launch in its ``launches`` attribute; a CPU
tensor takes the plain PyTorch version beside it.

No VMEM-style gate applies on the card: the scatter kernel tiles the
output over segments and columns, the gather kernel copies row by row,
and both serve any shape below the int32 index limits checked here.
"""

from __future__ import annotations

import torch

from . import _launch

__all__ = [
    "scatter_rows",
    "scatter_rows_plain",
    "gather_scaled_rows",
    "gather_scaled_rows_plain",
]

_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = _launch.P, _launch.I, _launch.F
_SIGNATURES = {
    **{f"skylark_scatter_rows_{s}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
       for s in _SUFFIX.values()},
    **{f"skylark_gather_scaled_rows_{s}": [_P, _P, _P, _I, _I, _I, _F, _P]
       for s in _SUFFIX.values()},
}
_INT32_MAX = (1 << 31) - 1
_MAX_COL_TILES = 65535  # the kernels put column tiles on grid.y
# Scatter kernel geometry (csrc/window.cu): a block owns 32 segments x 128
# columns and stages 1024 entries per pass.
_SC_SEGS, _SC_COLS, _SC_CHUNK = 32, 128, 1024
_SC_TARGET_BLOCKS = 132 * 8  # ~8 resident 4-warp blocks on each H100 SM
_SC_MIN_CHUNKS = 8           # entries per split: at least 8 staged passes


def scatter_splits(entries: int, num_segments: int, m: int) -> int:
    """How many contiguous pieces the scatter kernel cuts its ordered
    entry range into: enough blocks to fill the card, at least
    ``_SC_MIN_CHUNKS`` staged passes per piece.  A function of the shape
    alone, so a given shape always sums in the same order."""
    tiles = -(-num_segments // _SC_SEGS) * -(-m // _SC_COLS)
    chunks = -(-entries // _SC_CHUNK)
    return max(1, min(-(-_SC_TARGET_BLOCKS // tiles), chunks // _SC_MIN_CHUNKS, 65535))


def _stacked(b, v):
    if b.ndim == 1:
        b, v = b[None, :], v[None, :]
    if b.shape != v.shape:
        raise ValueError(f"b/v shape mismatch: {tuple(b.shape)} vs {tuple(v.shape)}")
    return b, v


def scatter_rows_plain(A, b, v, num_segments: int, *, acc=None):
    """Plain version of :func:`scatter_rows` (f32 ``index_add_``)."""
    b, v = _stacked(b, v)
    m = A.shape[1]
    rows = (v.to(torch.float32)[:, :, None] * A.to(torch.float32)[None]).reshape(-1, m)
    out = torch.zeros((num_segments, m), dtype=torch.float32, device=A.device)
    out.index_add_(0, b.reshape(-1).long(), rows)
    return out if acc is None else acc + out


def scatter_rows(A: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                 num_segments: int, *, acc: torch.Tensor | None = None):
    """``out[t, :] = Σ_{h,i: b[h,i]==t} v[h,i]·A[i, :]`` in f32,
    deterministic run to run.  ``A`` (k, m) f32/bf16; ``b`` int32 and
    ``v`` f32, (k,) or stacked (nnz, k), with any out-of-domain values
    already zeroed by the caller.  ``acc`` (num_segments, m) f32, when
    given, is folded into the emit: the result is bitwise
    ``acc + scatter_rows(A, b, v, num_segments)``."""
    if acc is not None and acc.dtype != torch.float32:
        raise TypeError(f"fused acc must be float32, got {acc.dtype}")
    b, v = _stacked(b, v)
    if A.device.type == "cpu":
        return scatter_rows_plain(A, b, v, num_segments, acc=acc)
    dev = A.device
    _launch.check(A, "A", device=dev, dtypes=_DTYPES, ndim=2)
    b, v = b.contiguous(), v.contiguous()
    _launch.check(b, "b", device=dev, dtypes=(torch.int32,), ndim=2)
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
    if nnz * k > _INT32_MAX - _SC_CHUNK or -(-m // _SC_COLS) > _MAX_COL_TILES:
        raise ValueError(f"scatter_rows kernel does not take nnz={nnz}, "
                         f"k={k}, m={m}")
    out = torch.empty((num_segments, m), dtype=torch.float32, device=dev)
    if num_segments == 0 or m == 0:
        return out
    splits = scatter_splits(nnz * k, num_segments, m)
    parts = (torch.empty((splits, num_segments, m), dtype=torch.float32, device=dev)
             if splits > 1 else None)
    lib = _launch.library("window", _SIGNATURES)
    fn = getattr(lib, f"skylark_scatter_rows_{_SUFFIX[A.dtype]}")
    _launch.run(fn, dev, A.data_ptr(), b.data_ptr(), v.data_ptr(),
                _launch.ptr(acc), out.data_ptr(), _launch.ptr(parts), k, m, nnz,
                num_segments, splits)
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
    ``T`` (nrows, m) f32/bf16, ``idx`` int32 (S,) in [0, nrows)."""
    if T.device.type == "cpu":
        return gather_scaled_rows_plain(T, idx, scale)
    dev = T.device
    _launch.check(T, "T", device=dev, dtypes=_DTYPES, ndim=2)
    _launch.check(idx, "idx", device=dev, dtypes=(torch.int32,), ndim=1)
    nrows, m = T.shape
    s = idx.shape[0]
    if nrows > _INT32_MAX or -(-m // 1024) > _MAX_COL_TILES or s > _INT32_MAX:
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
