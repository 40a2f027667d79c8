"""Port vs JAX package: the counter stream, context JSON and precision
helpers.  Inputs come from numpy; JAX runs on the CPU with x64 on
(conftest), so every float draw is requested at an explicit dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu.core import precision as jprec
from libskylark_tpu.core import random as jrand
from libskylark_tpu.core.context import SketchContext as JContext
from libskylark_tpu_torch.core import precision as tprec
from libskylark_tpu_torch.core import random as trand
from libskylark_tpu_torch.core.context import SketchContext as TContext

# (seed, base, num): plain, a window crossing 2^32, one wrapping 2^64.
WINDOWS = [
    (7, 0, 1000),
    (123456789012345, (1 << 32) - 5, 20),
    (3, (1 << 64) - 4, 9),
]
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64),
          (jnp.float16, torch.float16), (jnp.bfloat16, torch.bfloat16)]
NARROW = (torch.float16, torch.bfloat16)


def _f64(x):
    """Values as f64 (exact for every float dtype here, ml_dtypes' bf16
    included)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _eps_units(out, ref, dtype):
    """Largest |out - ref| / (|ref| * eps) in units of ``dtype``'s
    epsilon, compared in f64; equal values (equal infinities included)
    count 0, so an f16 Lévy draw that overflows to inf on both sides
    agrees."""
    out, ref = _f64(out), _f64(ref)
    same = out == ref
    with np.errstate(divide="ignore", invalid="ignore"):
        err = np.abs(out - ref) / (np.abs(ref) * float(torch.finfo(dtype).eps))
    return float(np.where(same, 0.0, err).max())


def _words(h, l):
    return np.asarray(h).astype(np.int64), np.asarray(l).astype(np.int64)


@pytest.mark.parametrize("seed,base,num", WINDOWS)
@pytest.mark.parametrize("lane", [0, 2])
def test_raw_bits_bitwise(seed, base, num, lane):
    jh, jl = _words(*jrand.raw_bits(seed, base, num, lane=lane))
    th, tl = trand.raw_bits(seed, base, num, lane=lane, device="cpu")
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tl.numpy(), jl)


@pytest.mark.parametrize("base,full_cols,row0,col0", [
    (0, 17, 0, 0),
    ((1 << 32) - 100, 70000, 61000, 3),   # counter crosses 2^32
    (5, (1 << 32) - 3, 2, 1),             # 64-bit product of row and width
])
def test_window_bits_bitwise(base, full_cols, row0, col0):
    jh, jl = _words(*jrand.window_bits(5, base, full_cols, row0, col0, 4, 9))
    th, tl = trand.window_bits(5, base, full_cols, row0, col0, 4, 9, device="cpu")
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tl.numpy(), jl)


def test_sample_window_is_slice_of_full():
    full = trand.sample_window("normal", 9, 100, (6, 7), device="cpu")
    part = trand.sample_window("normal", 9, 100, (6, 7), offset=(2, 3),
                               shape=(3, 2), device="cpu")
    assert torch.equal(full[2:5, 3:5], part)


@pytest.mark.parametrize("dist", ["rademacher", "uniform"])
@pytest.mark.parametrize("jd,td", DTYPES)
def test_exact_distributions_bitwise(dist, jd, td):
    base = (1 << 32) - 50
    a = jrand.sample(dist, 11, base, 20000, dtype=jd)
    b = trand.sample(dist, 11, base, 20000, dtype=td, device="cpu")
    assert b.dtype == td
    np.testing.assert_array_equal(_f64(b), _f64(a))


@pytest.mark.parametrize("jd,td", DTYPES)
def test_uniform_bounds_round_like_jax(jd, td):
    """uniform on [low, high): the span and low are rounded to the sample
    dtype as JAX rounds a weakly typed Python float (in f16 and bf16 a
    bare Python float would be applied in f32 and rounded once)."""
    base = (1 << 32) - 50
    a = jrand.sample("uniform", 11, base, 20000, dtype=jd, low=0.1, high=0.8)
    b = trand.sample("uniform", 11, base, 20000, dtype=td, device="cpu", low=0.1, high=0.8)
    assert b.dtype == td
    np.testing.assert_array_equal(_f64(b), _f64(a))


@pytest.mark.parametrize("td", [torch.float32, torch.float64])
def test_dtype_constants_leave_f32_f64_draws_unchanged(td):
    """Rounding pi and the uniform bounds to the dtype changes nothing at
    f32 and f64: the draws are bitwise the Python-float forms."""
    import math

    hi, lo = trand.raw_bits(11, (1 << 32) - 50, 20000, device="cpu")
    u = trand._uniform01(hi, lo, td)
    assert torch.equal(trand.DISTRIBUTIONS["cauchy"](hi, lo, td),
                       torch.tan(math.pi * (u - 0.5)).to(td))
    assert torch.equal(trand.DISTRIBUTIONS["uniform"](hi, lo, td, low=0.1, high=0.8),
                       u * (0.8 - 0.1) + 0.1)


@pytest.mark.parametrize("low,high", [(0, 9), (3, 1000), (0, (1 << 32) - 1)])
def test_uniform_int_bitwise(low, high):
    base = (1 << 32) - 50
    a = np.asarray(jrand.sample("uniform_int", 11, base, 20000,
                                dtype=jnp.int64, low=low, high=high))
    b = trand.sample("uniform_int", 11, base, 20000, dtype=torch.int64,
                     device="cpu", low=low, high=high).numpy()
    np.testing.assert_array_equal(b, a)


# Transcendental draws agree to libm-vs-XLA rounding: cauchy and
# exponential to 1 ulp; the Box-Muller normal composes three rounded
# transcendentals (log, sqrt, cos), measured at most 3 ulp; levy = 1/z²
# squares and inverts that, measured at most 6 ulp.  Stated as a
# relative bound in units of the dtype's epsilon.
#
# In f16 and bf16 the transcendental runs on f16/bf16 operands in f32 and
# is rounded once to the narrow dtype (normal and levy work in f32 before
# their cast), so the f32 differences above reach the narrow result only
# where an f32 value straddles a rounding boundary: at most 1 eps unit.
# cauchy must be bitwise: its pi is rounded to the dtype as the JAX
# package rounds it.  All four read bitwise at this base.
NARROW_EPS_UNITS = {"cauchy": 0, "exponential": 1, "normal": 1, "levy": 1}


@pytest.mark.parametrize("dist,eps_units", [
    ("cauchy", 1), ("exponential", 1), ("normal", 4), ("levy", 8),
])
@pytest.mark.parametrize("jd,td", DTYPES)
def test_transcendental_distributions(dist, eps_units, jd, td):
    base = (1 << 32) - 50
    a = np.asarray(jrand.sample(dist, 11, base, 20000, dtype=jd))
    t = trand.sample(dist, 11, base, 20000, dtype=td, device="cpu")
    assert t.dtype == td
    if td in NARROW:
        assert _eps_units(t, a, td) <= NARROW_EPS_UNITS[dist]
        return
    b = t.numpy()
    assert b.dtype == a.dtype
    if dist in ("cauchy", "exponential"):
        np.testing.assert_array_max_ulp(b, a, maxulp=eps_units)
    else:
        rel = np.abs(b.astype(np.float64) - a) / np.abs(a)
        assert rel.max() <= eps_units * np.finfo(jd).eps


def test_uniform_int_rejects_bad_bounds():
    with pytest.raises(ValueError):
        trand.sample("uniform_int", 0, 0, 4, dtype=torch.int32, device="cpu",
                     low=5, high=4)
    with pytest.raises(ValueError):
        trand.sample("uniform_int", 0, 0, 4, dtype=torch.int32, device="cpu",
                     low=0, high=1 << 32)


def test_context_json_identical():
    j, t = JContext(seed=42, counter=7), TContext(seed=42, counter=7)
    assert j.reserve(10) == t.reserve(10) == 7
    assert t.to_json() == j.to_json()
    assert TContext.from_json(j.to_json()) == t
    with pytest.raises(ValueError):
        t.reserve(-1)


def test_bf16_split3_bitwise(rng):
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-30, 30, 4096))).astype(np.float32)
    jparts = jprec.bf16_split3(jnp.asarray(x))
    tparts = tprec.bf16_split3(torch.from_numpy(x))
    for jp, tp in zip(jparts, tparts):
        np.testing.assert_array_equal(tp.float().numpy(), np.asarray(jp, np.float32))
    total = sum(p.double() for p in tparts).numpy()
    np.testing.assert_allclose(total, x, rtol=2 ** -22)
    with pytest.raises(TypeError):
        tprec.bf16_split3(torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("jd,td", [
    (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
    (jnp.float16, torch.float16), (jnp.float64, torch.float64),
    (jnp.int32, torch.int32),
])
@pytest.mark.parametrize("demote", [False, True])
def test_f32_accumulable_matches(jd, td, demote):
    assert tprec.f32_accumulable(td, demote_f64=demote) == \
        jprec.f32_accumulable(jd, demote_f64=demote)
