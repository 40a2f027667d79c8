"""Port vs JAX package: the leaped Halton sequence (``core/quasirand.py``).

The port's radical inverse keeps the JAX digit loop's order of
operations as separate rounded f64 operations.  XLA's CPU compile
contracts its ``r + m·digit`` into a fused multiply-add, so the JAX
values sit within 1 ulp of f64 of the port's (the test below shows that
they are bitwise the FMA-contracted loop, and the port's bitwise the
unfused one, both computed here from exact Python integer digits).  The
digit tiers of ``window`` and the port's QJLT are bitwise the full
41-digit loop.  f32 windows are cast once from f64.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.core.quasirand as JQ
import libskylark_tpu_torch as T
import libskylark_tpu_torch.core.quasirand as TQ

def _exact_digits(base: int, idx: int, fma: bool) -> float:
    """The 41-step digit loop on one (base, idx), digits from Python ints;
    each step's ``r + m·digit`` rounded once (FMA) or twice."""
    res, r, m = idx + 1, 0.0, 1.0
    for _ in range(41):
        m = m / base
        digit = res % base
        r = float(Fraction(r) + Fraction(m) * digit) if fma else r + m * digit
        res //= base
    return r


def _within_ulps(a, b, n=1):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.all(np.abs(a - b) <= n * np.spacing(np.maximum(np.abs(a), np.abs(b))))


def test_primes_match_jax():
    for n in (0, 1, 2, 10, 97, 1000, 5000):
        np.testing.assert_array_equal(TQ.primes(n), JQ.primes(n))
    assert TQ.primes(5).tolist() == [2, 3, 5, 7, 11]
    assert T.core.primes is TQ.primes


@pytest.mark.parametrize("base", [int(p) for p in JQ.primes(25)])  # bases 2..97
def test_radical_inverse_matches_jax(rng, base):
    idx = np.concatenate([rng.integers(0, 1 << 40, 64), [0, 1, base - 2, base - 1, base,
                                                         base**2 - 1, (1 << 40) - 1, 1 << 40]])
    out = TQ.radical_inverse(base, torch.from_numpy(idx)).numpy()
    assert out.dtype == np.float64
    ref = np.asarray(JQ.radical_inverse(base, jnp.asarray(idx)))
    assert _within_ulps(out, ref, 1)
    np.testing.assert_array_equal(out, [_exact_digits(base, int(i), fma=False) for i in idx])


def test_jax_radical_inverse_is_the_fma_loop(rng):
    """Why the JAX values may differ by an ulp: they are bitwise the loop
    with each step contracted to one rounding."""
    idx = rng.integers(0, 1 << 40, 40)
    for base in (3, 7, 31, 97):
        ref = np.asarray(JQ.radical_inverse(base, jnp.asarray(idx)))
        np.testing.assert_array_equal(ref, [_exact_digits(base, int(i), fma=True) for i in idx])


def test_radical_inverse_broadcasts_and_shorter_loops_are_bitwise(rng):
    bases = torch.from_numpy(TQ.primes(30))[None, :]
    idx = torch.from_numpy(rng.integers(0, 1 << 20, 17))[:, None]
    full = TQ.radical_inverse(bases, idx)
    assert full.shape == (17, 30)
    # 2^20 + 1 has 21 base-2 digits: any bound from 21 up is the full loop.
    assert torch.equal(TQ.radical_inverse(bases, idx, ndigits=21), full)
    assert not torch.equal(TQ.radical_inverse(bases, idx, ndigits=8), full)


@pytest.mark.parametrize("d,leap", [(1, -1), (7, -1), (50, -1), (200, -1), (13, 1),
                                    (5, 53)])
def test_window_matches_jax(d, leap):
    Sj, St = JQ.LeapedHaltonSequence(d, leap), TQ.LeapedHaltonSequence(d, leap)
    assert St.leap == Sj.leap
    for i0, n in ((0, 33), (12345, 17), ((1 << 20) - 3, 9)):
        out = St.window(i0, n, torch.float64, device="cpu").numpy()
        assert out.shape == (n, d)
        assert _within_ulps(out, np.asarray(Sj.window(i0, n, dtype=jnp.float64)), 1)
        out32 = St.window(i0, n, device="cpu")
        assert out32.dtype == torch.float32
        assert torch.equal(out32, torch.from_numpy(out).float())


def _tier_edges(p: int, leap: int):
    """Window starts whose largest residue (idx0 + num)·leap + 1 sits
    just below, at and just above p^k for a few k."""
    num = 4
    for k in (2, 3, 4):
        target = p**k
        base = (target - 1) // leap - num
        for i0 in (base - 1, base, base + 1, base + 2):
            if i0 >= 0:
                yield i0, num


@pytest.mark.parametrize("d", [4, 30])
def test_window_tiers_are_the_41_digit_loop_at_tier_edges(d):
    S = TQ.LeapedHaltonSequence(d)
    p_all = TQ.primes(d)
    for p in (int(p_all[0]), int(p_all[d // 2]), int(p_all[-1])):
        for i0, num in _tier_edges(p, S.leap):
            idx = (i0 + torch.arange(num, dtype=torch.int64)) * S.leap
            full = TQ.radical_inverse(torch.from_numpy(p_all)[None, :], idx[:, None])
            assert torch.equal(S.window(i0, num, torch.float64, device="cpu"), full)


def test_digit_tiers_are_exact_at_powers():
    p = np.array([2, 3, 5, 1009], np.int64)
    for base in p:
        for k in (2, 3, 5, 8):
            M = int(base) ** k
            tiers = TQ.digit_tiers(p, M)
            # residues up to M need the digit count of M itself
            j = int(np.flatnonzero(p == base)[0])
            assert int(base) ** int(tiers[j]) > M
            assert int(tiers[j]) >= k + 1


def test_coordinate_matches_jax():
    Sj, St = JQ.LeapedHaltonSequence(11), TQ.LeapedHaltonSequence(11)
    idx = np.array([0, 5, 77, 1 << 30])
    for i in (0, 4, 10):
        out = St.coordinate(torch.from_numpy(idx), i).numpy()
        assert _within_ulps(out, np.asarray(Sj.coordinate(jnp.asarray(idx), i)), 1)


@pytest.mark.parametrize("d,leap,match", [
    (-1, -1, "dimension"), (5, 0, "positive"), (5, -7, "positive"),
    (5, 22, r"coprime.*\[2, 11\]"), (3, 25, r"coprime.*\[5\]"),
])
def test_leap_validation_matches_jax(d, leap, match):
    with pytest.raises(J.utils.exceptions.InvalidParameters, match=match):
        JQ.LeapedHaltonSequence(d, leap)
    with pytest.raises(T.utils.InvalidParameters, match=match):
        TQ.LeapedHaltonSequence(d, leap)


def test_json_round_trip_cross_package():
    for d, leap in ((9, -1), (9, 1), (40, 1009)):
        Sj, St = JQ.LeapedHaltonSequence(d, leap), TQ.LeapedHaltonSequence(d, leap)
        assert St.to_dict() == Sj.to_dict()
        assert St.to_json() == Sj.to_json()
        assert TQ.LeapedHaltonSequence.from_json(Sj.to_json()) == St
        assert JQ.LeapedHaltonSequence.from_json(St.to_json()) == Sj
    assert TQ.LeapedHaltonSequence(9).to_dict()["skylark_object_type"] == "qmc_sequence"


def test_fp8_helpers_match_jax():
    assert T.core.fp8_available() is J.core.precision.fp8_available()
    assert T.core.fp8_dtype() is torch.float8_e4m3fn
    assert str(T.core.fp8_dtype()).endswith(np.dtype(J.core.precision.fp8_dtype()).name)
