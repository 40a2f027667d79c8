"""Port vs JAX package: condition-number estimation with certificates
(``solvers/cond_est.py``).

The start and probe vectors come from ``gaussian_matrix`` on the
context, so both packages draw the same ones (bitwise in f64 here).
Same seeded numpy A in f64 to both.  Tolerance on well-conditioned,
well-separated problems, where the LSQR sweep stops after 11-18
iterations: cond, sigma_max, sigma_min and sigma_min_c within 1e-8
relative, with equal flags.  On the ill-conditioned problems the sweep
runs on past the convergence of the extreme Ritz values (51 of n = 100
steps at cond 10; past n on the narrow ones), and Lanczos without
reorthogonalization then turns rounding-level differences of the
matvecs into differences of the certified sigma_min and of the
bidiagonal's smallest singular value.  There the flags must match,
sigma_max stays within 1e-8 (power iteration is stable), cond,
sigma_min and sigma_min_c agree within 1e-2 (the largest gap seen is
2.4e-3), and a witness shows the gap is summation order: the JAX
package against itself on A with its rows permuted (the same problem in
exact arithmetic, summed in another order) moves the estimates as far.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu_torch.core.matrices import gaussian_matrix, random_matrix, uniform_matrix

jce = importlib.import_module("libskylark_tpu.solvers.cond_est")
tce = importlib.import_module("libskylark_tpu_torch.solvers.cond_est")
jmat = importlib.import_module("libskylark_tpu.core.matrices")

RTOL = 1e-8
ILL_RTOL = 1e-2
_ESTIMATES = ("cond", "sigma_min", "sigma_min_c")


def _both(A, seed=3, jparams=None, tparams=None, **kw):
    rj = jce.cond_est(jnp.asarray(A), J.SketchContext(seed=seed), jparams, **kw)
    rt = tce.cond_est(torch.from_numpy(A), T.SketchContext(seed=seed), tparams, **kw)
    return rj, rt


def _assert_match(rj, rt, rtol=RTOL):
    assert int(rt.flag) == int(rj.flag)
    for name in ("cond", "sigma_max", "sigma_min", "sigma_min_c"):
        a, b = float(getattr(rt, name)), float(getattr(rj, name))
        assert abs(a - b) <= rtol * abs(b), (name, a, b)


def _conditioned(rng, m, n, lo):
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return U @ np.diag(np.logspace(0, lo, n)) @ V


@pytest.mark.parametrize("m,n,lo", [
    (400, 120, -0.5),  # cond 3.2, the sweep stops at ~1/10 of n
    (900, 200, -0.3),  # cond 2
])
def test_cond_est_matches_jax(rng, m, n, lo):
    A = _conditioned(rng, m, n, lo)
    rj, rt = _both(A)
    _assert_match(rj, rt)
    assert abs(float(rt.cond) - 10.0 ** -lo) <= 0.1 * 10.0 ** -lo


_ILL = [
    (600, 100, -1),  # cond 10
    (400, 30, -4),   # cond 1e4
    (200, 15, -8),   # cond 1e8
    (60, 60, -2),    # square, cond 100
]


def _gap(r, ref):
    return max(abs(float(getattr(r, k)) - float(getattr(ref, k))) / abs(float(getattr(ref, k)))
               for k in _ESTIMATES)


@pytest.mark.parametrize("m,n,lo", _ILL)
def test_cond_est_ill_conditioned_matches_jax(rng, m, n, lo):
    A = _conditioned(rng, m, n, lo)
    rj, rt = _both(A)
    assert int(rt.flag) == int(rj.flag)
    assert abs(float(rt.sigma_max) - float(rj.sigma_max)) <= RTOL * float(rj.sigma_max)
    _assert_match(rj, rt, rtol=ILL_RTOL)
    for r in (rt, rj):
        assert abs(float(r.cond) - 10.0 ** -lo) <= 0.1 * 10.0 ** -lo


@pytest.mark.parametrize("m,n,lo", _ILL)
def test_cond_est_ill_conditioned_gap_is_summation_order(rng, m, n, lo):
    """The witness for ILL_RTOL: the JAX package on A with its rows
    permuted (four permutations) moves cond, sigma_min or sigma_min_c by
    more than 1e-8, and by at least a quarter of the port's gap."""
    A = _conditioned(rng, m, n, lo)
    rj, rt = _both(A)
    spread = max(
        _gap(jce.cond_est(jnp.asarray(A[np.random.default_rng(k).permutation(m)]),
                          J.SketchContext(seed=3)), rj)
        for k in range(4))
    assert spread > RTOL
    assert _gap(rt, rj) <= 4 * spread


def test_cond_est_gaussian_matches_jax(rng):
    A = rng.standard_normal((500, 40))
    rj, rt = _both(A)
    _assert_match(rj, rt)
    # The certificates' own identities, and the dominant pair against JAX
    # up to sign (σ_max is separated from σ_2 on this A).
    At = torch.from_numpy(A)
    smax = float(rt.sigma_max)
    assert float(torch.linalg.vector_norm(At @ rt.v_max - smax * rt.u_max)) <= 1e-6 * smax
    smin_c = float(rt.sigma_min_c)
    assert abs(float(torch.linalg.vector_norm(At @ rt.v_min)) - smin_c) <= 1e-8 * smin_c
    for name in ("u_max", "v_max", "u_min", "v_min"):
        t, j = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        assert abs(abs(t @ j) - 1.0) <= 1e-6, name


def test_cond_est_rank_deficient_flags_singular(rng):
    A = rng.standard_normal((200, 12))
    A[:, 5] = A[:, 2] + A[:, 7]
    rj, rt = _both(A)
    assert int(rt.flag) == int(rj.flag)
    assert float(rt.cond) >= 1e10 and float(rj.cond) >= 1e10


def test_cond_est_orthonormal_columns(rng):
    A = np.linalg.qr(rng.standard_normal((100, 8)))[0]
    rj, rt = _both(A)
    _assert_match(rj, rt)
    assert abs(float(rt.cond) - 1.0) <= 1e-6


def test_cond_est_zero_matrix_stays_finite():
    rj, rt = _both(np.zeros((30, 4)))
    assert int(rt.flag) == int(rj.flag)
    for r in (rt.u_max, rt.v_max, rt.u_min, rt.v_min):
        assert bool(torch.isfinite(r).all())


@pytest.mark.parametrize("kw", [dict(power_its=5, lanczos_steps=9), dict(lanczos_steps=3)])
def test_cond_est_short_budgets_match_jax(rng, kw):
    A = _conditioned(rng, 300, 60, -3)
    rj, rt = _both(A, **kw)
    _assert_match(rj, rt)
    assert int(rt.flag) == -6


def test_cond_est_params_match_jax(rng):
    A = _conditioned(rng, 400, 120, -0.5)
    rj, rt = _both(A, jparams=jce.CondEstParams(iter_lim=60, powerits=25, c2=1e-2),
                   tparams=tce.CondEstParams(iter_lim=60, powerits=25, c2=1e-2))
    _assert_match(rj, rt)


def test_cond_est_sparse_matches_jax(rng):
    D = rng.standard_normal((600, 60)) * (rng.random((600, 60)) < 0.2)
    rj = jce.cond_est(jsparse.BCOO.fromdense(jnp.asarray(D)), J.SketchContext(seed=3),
                      jce.CondEstParams(iter_lim=60))
    rt = tce.cond_est(torch.from_numpy(D).to_sparse(), T.SketchContext(seed=3),
                      tce.CondEstParams(iter_lim=60))
    _assert_match(rj, rt)
    dense = tce.cond_est(torch.from_numpy(D), T.SketchContext(seed=3),
                         tce.CondEstParams(iter_lim=60))
    _assert_match(dense, rt, rtol=1e-10)


def test_cond_est_f32(rng):
    A = _conditioned(rng, 300, 20, -2).astype(np.float32)
    rj, rt = _both(A)
    assert rt.cond.dtype == torch.float32
    # f32 rounding moves the estimate: within 1e-3 of JAX's f32 value,
    # both within 10 % of the true cond 100.
    assert abs(float(rt.cond) - float(rj.cond)) <= 1e-3 * float(rj.cond)
    assert abs(float(rt.cond) - 100.0) <= 10.0


def test_cond_est_is_deterministic_and_advances_context(rng):
    A = torch.from_numpy(rng.standard_normal((80, 6)))
    ctx = T.SketchContext(seed=4)
    r1 = tce.cond_est(A, ctx)
    assert ctx.counter == 12
    r2 = tce.cond_est(A, T.SketchContext(seed=4))
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    assert T.linalg.cond_est is tce.cond_est and T.solvers.CondEstResult is tce.CondEstResult


@pytest.mark.parametrize("dist,kw", [("normal", {}), ("uniform", dict(low=-2.0, high=3.0))])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_matrices_match_jax(dist, kw, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    cj, ct = J.SketchContext(seed=21, counter=5), T.SketchContext(seed=21, counter=5)
    if dist == "normal":
        mj = jmat.gaussian_matrix(cj, (37, 11), dtype=dtype, mean=1.5, stddev=2.0)
        mt = gaussian_matrix(ct, (37, 11), dtype=tdt, mean=1.5, stddev=2.0, device="cpu")
    else:
        mj = jmat.uniform_matrix(cj, (37, 11), dtype=dtype, **kw)
        mt = uniform_matrix(ct, (37, 11), dtype=tdt, device="cpu", **kw)
    assert ct.counter == cj.counter == 5 + 37 * 11
    mj = np.asarray(mj)
    # Box-Muller's transcendentals round within a few ulp; uniforms are exact.
    tol = 8 * np.finfo(dtype).eps * np.abs(mj).max() if dist == "normal" else 0
    np.testing.assert_allclose(mt.numpy(), mj, rtol=0, atol=tol)
    r = random_matrix(T.SketchContext(seed=2), (4, 3), "rademacher", device="cpu")
    assert set(r.flatten().tolist()) <= {-1.0, 1.0}
