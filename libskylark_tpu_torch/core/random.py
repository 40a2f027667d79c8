"""Counter-based, random-access random numbers (port of
``libskylark_tpu/core/random.py``).

Sample *i* of a stream is a pure function of ``(seed, lane, base + i)``:
Threefry-2x32 with 20 rounds, keyed by ``(seed_lo32, seed_hi32 ^
lane·0x9E3779B9)``, applied to the 64-bit counter split into its
``(hi, lo)`` words.  The words match JAX's ``threefry_2x32`` bit for bit
(``docs/counter_contract.md``), so a sketch realized here equals the one
the JAX package realizes from the same JSON.  The counter stream *is*
the generator: there is no ``torch.Generator`` and no global state.

torch has no uint32 arithmetic (add, shifts and compares are missing),
so every 32-bit word lives in an int64 tensor and is masked with
``& 0xFFFFFFFF`` after each operation that can carry past bit 31.
Products of two 32-bit words would overflow int64, so they go through
16-bit limbs exactly as the reference's ``_mul_u32`` does.  On the card
this is plain tensor code, as it was XLA code in JAX.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .._device import resolve_device

__all__ = ["raw_bits", "window_bits", "sample", "sample_window", "chi2_lanes",
           "DISTRIBUTIONS"]

_GOLDEN = 0x9E3779B9  # 32-bit golden-ratio constant for lane mixing.
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _key(seed: int, lane: int) -> tuple[int, int]:
    seed = int(seed) % (1 << 64)
    k0 = seed & _MASK32
    k1 = ((seed >> 32) ^ (lane * _GOLDEN)) & _MASK32
    return k0, k1


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words
    (the same schedule as JAX's ``_threefry2x32_lowering``).  Updates
    ``x0``/``x1`` in place."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(_MASK32)
    x1.add_(ks[1]).bitwise_and_(_MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK32)
            x1.copy_(((x1 << r) | (x1 >> (32 - r))) & _MASK32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK32)
    return x0, x1


def _add64(a_hi, a_lo, b_hi, b_lo):
    """64-bit add on (hi, lo) word pairs, wrapping at 2^64."""
    lo = a_lo + b_lo
    hi = (a_hi + b_hi + (lo >> 32)) & _MASK32
    return hi, lo & _MASK32


def _mul_u32(a_hi, a_lo, c: int):
    """(64-bit value) * (32-bit constant c), low 64 bits kept."""
    c = int(c) & _MASK32
    c_lo, c_hi = c & 0xFFFF, c >> 16
    p_lo = a_lo * c_lo                       # < 2^48
    p_hi = a_lo * c_hi                       # < 2^48, weighted 2^16
    t = p_lo + ((p_hi & 0xFFFF) << 16)       # < 2^49
    lo = t & _MASK32
    hi = (t >> 32) + (p_hi >> 16)
    # a_hi * c mod 2^32, again in limbs so nothing overflows int64.
    hi = hi + a_hi * c_lo + (((a_hi * c_hi) & 0xFFFF) << 16)
    return hi & _MASK32, lo


def raw_bits(seed: int, base: int, num: int, lane: int = 0, offset=0,
             device=None):
    """64 random bits for counters ``base+offset .. base+offset+num`` as
    two int64 tensors of uint32 words ``(hi, lo)``.  ``offset`` is a host
    int, or a 0-d int64 tensor below 2^32 on the device (read without a
    host sync)."""
    if isinstance(offset, torch.Tensor):
        dev = offset.device
        start = int(base) % (1 << 64)
        idx = torch.arange(num, dtype=torch.int64, device=dev) + offset
    else:
        dev = resolve_device(device)
        start = (int(base) + int(offset)) % (1 << 64)
        idx = torch.arange(num, dtype=torch.int64, device=dev)
    hi, lo = _add64(start >> 32, start & _MASK32, 0, idx)
    return _threefry2x32(*_key(seed, lane), hi, lo)


def _index(x):
    """A window offset as it enters the counter arithmetic: a host int,
    or a 0-d int64 tensor left on its device."""
    return x if isinstance(x, torch.Tensor) else int(x)


def window_bits(seed: int, base: int, full_cols: int, row0, col0,
                rows: int, cols: int, lane: int = 0, device=None):
    """Bits for a (rows, cols) window of a row-major logical array:
    element (i, j) uses counter ``base + (row0+i)*full_cols + (col0+j)``,
    with the reference's 32-bit wrap of ``row0+i`` and ``col0+j``.
    ``row0``/``col0`` are host ints or 0-d int64 tensors on the device."""
    dev = next((x.device for x in (row0, col0) if isinstance(x, torch.Tensor)), None)
    dev = resolve_device(device) if dev is None else dev
    i = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    r_hi, r_lo = _mul_u32(0, (i + _index(row0)) & _MASK32, full_cols)
    hi, lo = _add64(r_hi, r_lo, 0, (j + _index(col0)) & _MASK32)
    b = int(base) % (1 << 64)
    hi, lo = _add64(hi, lo, b >> 32, b & _MASK32)
    return _threefry2x32(*_key(seed, lane), hi.contiguous(), lo.contiguous())


# ---------------------------------------------------------------------------
# bits -> distribution values
# ---------------------------------------------------------------------------


def _uniform01(hi, lo, dtype):
    """Uniform in (0, 1): ``(k + 0.5)·2^-bits``, exact in floating point,
    f32 (and narrower) leading with hi's top 24 bits, f64 with 52."""
    if dtype == torch.float64:
        k = ((hi >> 7) << 27 | (lo >> 5)).to(torch.float64)
        return (k + 0.5) * (2.0 ** -52)
    k = (hi >> 8).to(torch.float32)
    return ((k + 0.5) * (2.0 ** -24)).to(dtype)


def _const(x: float, dtype, device=None):
    """``x`` rounded to ``dtype`` (a 0-d tensor on ``device``), as JAX
    rounds a weakly typed Python float.  torch would apply a bare Python
    float to an f16 or bf16 tensor in f32 and round the result once,
    which differs from the JAX value; at f32 and f64 the two are the
    same.  The port's constants that meet a tensor all pass through
    here."""
    return torch.tensor(x, dtype=dtype, device=device)


def _uniform(hi, lo, dtype, low=0.0, high=1.0):
    return _uniform01(hi, lo, dtype) * _const(high - low, dtype) + _const(low, dtype)


def _normal(hi, lo, dtype):
    """Box-Muller from the counter's two words (u1: hi, u2: lo)."""
    if dtype == torch.float64:
        u1 = (hi.to(torch.float64) + 0.5) * (2.0 ** -32)
        u2 = (lo.to(torch.float64) + 0.5) * (2.0 ** -32)
    else:
        u1 = ((hi >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
        u2 = ((lo >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)


def _cauchy(hi, lo, dtype):
    u = _uniform01(hi, lo, dtype)
    return torch.tan((u - 0.5) * _const(math.pi, dtype)).to(dtype)


def _rademacher(hi, lo, dtype):
    return ((lo & 1) * 2 - 1).to(dtype)


def _exponential(hi, lo, dtype):
    return -torch.log(_uniform01(hi, lo, dtype)).to(dtype)


def _levy(hi, lo, dtype):
    z = _normal(hi, lo, dtype)
    return (1.0 / (z * z)).to(dtype)


def _uniform_int(hi, lo, dtype, low=0, high=None):
    """Uniform integer in [low, high] inclusive by the 64-bit
    multiply-shift ``floor(x·span / 2^64)``, x the counter's 64 bits."""
    if high is None:
        raise ValueError("uniform_int requires an explicit 'high' bound")
    low, high = int(low), int(high)
    if high < low:
        raise ValueError(f"uniform_int needs low <= high, got [{low}, {high}]")
    span = high - low + 1
    if span > (1 << 32):
        raise ValueError(f"uniform_int span {span} exceeds 2^32")
    p1_hi, p1_lo = _mul_u32(0, hi, span)
    p2_hi, _ = _mul_u32(0, lo, span)
    s_hi, _ = _add64(p1_hi, p1_lo, 0, p2_hi)
    return (s_hi + low).to(dtype)


def chi2_lanes(seed: int, base: int, size: int, dof: int, dtype=torch.float32,
               device=None):
    """χ²(dof) samples as a sum of ``dof`` squared-normal lanes over one
    reserved counter block (lanes 1..dof; lane 0 left for the caller),
    added in lane order in ``dtype`` as the JAX package adds them.  Used
    by the Matérn feature maps' row correction ``sqrt(2ν/χ²_{2ν})``."""
    if dof < 1 or int(dof) != dof:
        raise ValueError(f"chi2_lanes needs a positive integer dof, got {dof}")
    acc = torch.zeros((size,), dtype=dtype, device=resolve_device(device))
    for lane in range(int(dof)):
        z = sample("normal", seed, base, size, dtype=dtype, lane=lane + 1,
                   device=acc.device)
        acc = acc + z * z
    return acc


DISTRIBUTIONS = {
    "uniform": _uniform,
    "normal": _normal,
    "cauchy": _cauchy,
    "rademacher": _rademacher,
    "exponential": _exponential,
    "levy": _levy,
    "uniform_int": _uniform_int,
}


def sample(dist: str, seed: int, base: int, num: int, dtype=torch.float32,
           lane: int = 0, offset=0, device=None, **params: Any):
    """1-D stream sample: values for counters ``base+offset ..
    base+offset+num`` (``offset`` as :func:`raw_bits` takes it)."""
    hi, lo = raw_bits(seed, base, num, lane, offset=offset, device=device)
    return DISTRIBUTIONS[dist](hi, lo, dtype, **params)


def sample_window(dist: str, seed: int, base: int, full_shape: tuple[int, int],
                  dtype=torch.float32, offset: tuple[int, int] = (0, 0),
                  shape: tuple[int, int] | None = None, lane: int = 0,
                  device=None, **params: Any):
    """Window of a logical row-major 2-D random array; any sub-window is
    bit-identical to the same slice of the full matrix."""
    rows_full, cols_full = full_shape
    if shape is None:
        shape = (rows_full - offset[0], cols_full - offset[1])
    hi, lo = window_bits(seed, base, cols_full, offset[0], offset[1],
                         shape[0], shape[1], lane, device=device)
    return DISTRIBUTIONS[dist](hi, lo, dtype, **params)
