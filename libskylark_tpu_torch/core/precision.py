"""Precision utilities (port of ``libskylark_tpu/core/precision.py``).

An f32 value splits exactly into three bf16-representable parts by
masking mantissa bits: ``x = hi + lo + lo2``.  Contracting each part
against a bf16-exact operand (±1 / small-integer sketch matrices) with
f32 accumulation reproduces full f32 precision.  The split masks bits
and never round-trips through a cast, as the reference insists: a
compiler may elide an ``f32→bf16→f32`` convert pair and zero ``lo``.
"""

from __future__ import annotations

import torch

__all__ = ["bf16_split3", "f32_accumulable", "fp8_dtype", "fp8_available"]


def fp8_dtype():
    """The fp8 sketch-apply element type, e4m3 (4 exponent, 3 mantissa
    bits: the accuracy-side fp8, against e5m2's range-side), or None on
    a torch build without it.  No caller uses it yet: the fp8 rung of
    the precision ladder belongs to the policy layer."""
    return getattr(torch, "float8_e4m3fn", None)


def fp8_available() -> bool:
    """True when this torch build can represent e4m3 at all (whether the
    device multiplies it profitably is the policy layer's call)."""
    return fp8_dtype() is not None


def f32_accumulable(dtype, *, demote_f64: bool = False) -> bool:
    """True when ``dtype`` may ride an f32-accumulating kernel with
    casts at the boundary: f32, bf16 and f16 always; f64 only when the
    caller accepts the demotion."""
    if dtype in (torch.float32, torch.bfloat16, torch.float16):
        return True
    if dtype == torch.float64:
        return bool(demote_f64)
    return False


def _mask_top(x: torch.Tensor) -> torch.Tensor:
    """Sign, exponent and top 7 mantissa bits of f32 ``x`` — exactly
    representable in bf16."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def bf16_split3(x: torch.Tensor):
    """``(hi, lo, lo2)`` bf16 tensors with ``hi + lo + lo2 ≈ x`` to
    ~2^-24 relative (for ``|x| ≳ 2^-110``).  ``x`` must be f32."""
    if x.dtype != torch.float32:
        raise TypeError(
            f"bf16_split3 needs float32 input, got {x.dtype}; convert first"
        )
    x = x.contiguous()
    hi = _mask_top(x)
    r1 = x - hi
    lo = _mask_top(r1)
    lo2 = r1 - lo
    return (
        hi.to(torch.bfloat16),
        lo.to(torch.bfloat16),
        lo2.to(torch.bfloat16),
    )
