"""Fused RFUT kernels (port of ``libskylark_tpu/sketch/pallas_fut.py``).

``rfut_rowwise`` and ``rfut_rowwise_sampled`` are CUDA C++ kernels in
``csrc/rfut.cu`` (one block per row, the padded row in shared memory,
an in-place butterfly: one read of x, one write of the output).  Each
wrapper launches its kernel for a CUDA tensor and counts the launch in
its ``launches`` attribute; a CPU tensor takes the plain PyTorch
version beside it, which the tests compare with the JAX kernel.

Gates.  NB is a power of 2 in [512, 2^15], as on the TPU.  The TPU's
VMEM row-tile budgets do not carry over: one block holds one padded row
of NB float32, 128 KiB at NB = 2^15, under the 227 KB a Hopper block may
use, and any row count works (one block per row).  The sampled variant
keeps JAX's ``S ≥ 128, S % 128 == 0`` condition, so both kernels stay on
a path; its sample indices are read from global memory (L2), so S adds
nothing to the shared-memory need.
"""

from __future__ import annotations

import math

import torch

from . import _launch
from .fut import wht

__all__ = [
    "MIN_NB",
    "MAX_NB",
    "supported",
    "supported_sampled",
    "rfut_rowwise",
    "rfut_rowwise_plain",
    "rfut_rowwise_sampled",
    "rfut_rowwise_sampled_plain",
]

MIN_NB = 512
MAX_NB = 1 << 15
_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I = _launch.P, _launch.I
_SIGNATURES = {
    **{f"skylark_rfut_rowwise_{s}": [_P, _P, _P, _I, _I, _I, _P]
       for s in _SUFFIX.values()},
    **{f"skylark_rfut_rowwise_sampled_{s}": [_P, _P, _P, _P, _I, _I, _I, _I, _P]
       for s in _SUFFIX.values()},
}


def supported(m: int, n: int, nb: int) -> bool:
    """Shape gate of both kernels."""
    return (
        nb & (nb - 1) == 0
        and MIN_NB <= nb <= MAX_NB
        and 1 <= n <= nb
        and m >= 1
    )


def supported_sampled(m: int, n: int, nb: int, s: int) -> bool:
    return s >= 128 and s % 128 == 0 and supported(m, n, nb)


def _transform_plain(x: torch.Tensor, d: torch.Tensor, nb: int) -> torch.Tensor:
    """f32 orthonormal WHT of pad(x ⊙ d), the product taken in x's dtype
    as the kernel does."""
    xd = (x * d.to(x.dtype)).to(torch.float32)
    xd = torch.nn.functional.pad(xd, (0, nb - x.shape[1]))
    return wht(xd, axis=1)


def rfut_rowwise_plain(x, d, nb: int) -> torch.Tensor:
    """Plain version of :func:`rfut_rowwise`."""
    return _transform_plain(x, d, nb).to(x.dtype)


def rfut_rowwise_sampled_plain(x, d, nb: int, idx) -> torch.Tensor:
    """Plain version of :func:`rfut_rowwise_sampled`."""
    z = _transform_plain(x, d, nb).index_select(1, idx.long())
    return (z * math.sqrt(nb / idx.shape[0])).to(x.dtype)


def _check(x, d, nb):
    _launch.check(x, "x", device=x.device, dtypes=_DTYPES, ndim=2)
    _launch.check(d, "d", device=x.device, dtypes=(x.dtype,), ndim=1)
    m, n = x.shape
    if d.shape[0] != n:
        raise ValueError(f"d has {d.shape[0]} entries, x has {n} columns")
    if not supported(m, n, nb):
        raise ValueError(
            f"rfut kernel does not take m={m}, n={n}, nb={nb}; check supported"
        )


def rfut_rowwise(x: torch.Tensor, d: torch.Tensor, nb: int) -> torch.Tensor:
    """out (m, NB) = orthonormal WHT of pad(x ⊙ d) per row, natural
    Sylvester order, in x's dtype (f32 inside).  x (m, n) f32/bf16,
    d (n,) in x's dtype."""
    if x.device.type == "cpu":
        return rfut_rowwise_plain(x, d, nb)
    _check(x, d, nb)
    m, n = x.shape
    out = torch.empty((m, nb), dtype=x.dtype, device=x.device)
    lib = _launch.library("rfut", _SIGNATURES)
    fn = getattr(lib, f"skylark_rfut_rowwise_{_SUFFIX[x.dtype]}")
    _launch.run(fn, x.device, x.data_ptr(), d.data_ptr(), out.data_ptr(), m, n, nb)
    rfut_rowwise.launches += 1
    return out


rfut_rowwise.launches = 0


def rfut_rowwise_sampled(x: torch.Tensor, d: torch.Tensor, nb: int,
                         idx: torch.Tensor) -> torch.Tensor:
    """out (m, S) = the S sampled lanes ``idx`` of :func:`rfut_rowwise`'s
    transform, rescaled by √(NB/S) (one 1/√S multiply of the
    un-normalized transform).  ``idx`` int32 (S,) in [0, NB)."""
    if x.device.type == "cpu":
        return rfut_rowwise_sampled_plain(x, d, nb, idx)
    _check(x, d, nb)
    _launch.check(idx, "idx", device=x.device, dtypes=(torch.int32,), ndim=1)
    m, n = x.shape
    s = idx.shape[0]
    if not supported_sampled(m, n, nb, s):
        raise ValueError(f"sampled rfut kernel does not take S={s}; check "
                         "supported_sampled")
    out = torch.empty((m, s), dtype=x.dtype, device=x.device)
    lib = _launch.library("rfut", _SIGNATURES)
    fn = getattr(lib, f"skylark_rfut_rowwise_sampled_{_SUFFIX[x.dtype]}")
    _launch.run(fn, x.device, x.data_ptr(), d.data_ptr(), idx.data_ptr(),
                out.data_ptr(), m, n, nb, s)
    rfut_rowwise_sampled.launches += 1
    return out


rfut_rowwise_sampled.launches = 0
