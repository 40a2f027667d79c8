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

__all__ = ["bf16_split3", "f32_accumulable", "fp8_dtype", "fp8_available", "mm_f32",
           "round_to_e4m3"]

# The largest magnitude that rounds into e4m3fn's range: past it the
# nearest value would be 480, whose code is e4m3fn's NaN (there is no
# infinity); 464 itself ties to even, down to 448.
E4M3_ROUND_MAX = 464.0


def fp8_dtype():
    """The fp8 sketch-apply element type, e4m3 (4 exponent, 3 mantissa
    bits: the accuracy-side fp8, against e5m2's range-side), or None on
    a torch build without it.  The fp8 rung of the precision ladder
    (``policy``) rounds sketch operands to it with :func:`round_to_e4m3`."""
    return getattr(torch, "float8_e4m3fn", None)


def fp8_available() -> bool:
    """True when this torch build can represent e4m3 at all (whether the
    device multiplies it profitably is the policy layer's call)."""
    return fp8_dtype() is not None


def round_to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3fn, with the JAX package's
    ``astype(float8_e4m3fn)`` semantics on every device: round to
    nearest, ties to even, in range, and NaN (sign kept: code ``0x7F``
    or ``0xFF``) for ``|x| > 464``, ±inf and NaN.  torch's own cast
    saturates out-of-range values to ±448 on the CPU, which would
    quietly clip a bad operand instead of failing its certificate;
    here its result is kept only where ``x`` is in range.  Returns a
    ``float8_e4m3fn`` tensor (raises where this torch has none)."""
    f8 = fp8_dtype()
    if f8 is None:
        raise TypeError("this torch build has no float8_e4m3fn")
    code = x.to(f8).view(torch.uint8)
    # A NaN x fails both comparisons, so it takes the NaN code too.
    in_range = (x >= -E4M3_ROUND_MAX) & (x <= E4M3_ROUND_MAX)
    nan_code = torch.where(torch.signbit(x), code.new_tensor(0xFF), code.new_tensor(0x7F))
    return torch.where(in_range, code, nan_code).view(f8)


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


_HALF = (torch.bfloat16, torch.float16)

# The longest contraction one tensor-core product sums on the card.  Its
# f32 accumulator drifts with the length of the sum: a bf16 Gram of 131072
# rows (chip_smoke.py phase 3r (d), H100 80GB HBM3 at 700.00 W) read
# 6.12e-4 of its largest entry from the f64 product in one call, 1.27e-5
# in chunks of 4096 rows whose f32 partials are added in order, and
# 2.83e-5 through the f32 lift.
MM_F32_CHUNK = 4096


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 (or f16) matrices, or two stacks of them
    (3-D), with an f32 result: the JAX package's ``dot_general(...,
    preferred_element_type=f32)``.  The products of half-precision
    values are exact in f32, so only the order of the f32 sums is the
    library's.

    On the card it is ``torch.mm(a, b, out_dtype=torch.float32)``
    (``torch.bmm`` for stacks): tensor-core operands, f32 accumulation
    and an f32 result, never rounded to bf16 (a plain bf16 ``torch.mm``
    rounds its result, which would undo a bf16 split).  A contraction
    longer than ``MM_F32_CHUNK`` runs as products of that length whose
    f32 results are added in order.  On the CPU, where torch has no
    kernel for that overload, it is the exact lift
    ``a.float() @ b.float()``."""
    if a.dtype not in _HALF or b.dtype != a.dtype:
        raise TypeError(f"mm_f32 multiplies two bf16 or two f16 tensors, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device.type == "cpu":
        return a.float() @ b.float()
    op = torch.mm if a.ndim == 2 else torch.bmm
    out = None
    for k0 in range(0, max(a.shape[-1], 1), MM_F32_CHUNK):
        part = op(a[..., k0:k0 + MM_F32_CHUNK], b[..., k0:k0 + MM_F32_CHUNK, :],
                  out_dtype=torch.float32)
        out = part if out is None else out.add_(part)
    return out
