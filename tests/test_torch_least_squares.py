"""Port vs JAX package: exact least squares and sketch-and-solve end to
end.  The JAX side runs with ``SKYLARK_GUARD=0`` and ``SKYLARK_POLICY=0``
(the port has no guard ladder or policy store yet; with an empty store
JAX's guarded attempt 0 is bit-identical to that) and with
``SKYLARK_NO_SRHT_GEMM=1`` so both packages take the WHT route, and with
``SKYLARK_NO_PLANS=1`` (plan-cached applies are bitwise the eager ones).  The
sketched problem SA is compared tightly; the solutions x to a tolerance
scaled by cond(SA), since both solve it in f32 from SA's that differ
in the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.linalg import least_squares as jls
from libskylark_tpu_torch.linalg import least_squares as tls
from libskylark_tpu_torch.utils.exceptions import NumericalHealthError

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def jax_unguarded(monkeypatch):
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    # Plans are bitwise eager by contract; the eager apply is what runs
    # on the installed jax (the plan path needs an API it removed).
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")


def _problem(rng, m, n):
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = (A @ rng.standard_normal(n) + rng.standard_normal(m)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("alg", ["qr", "sne", "ne", "svd"])
def test_exact_least_squares_matches_jax(rng, alg):
    A, b = _problem(rng, 200, 12)
    B = np.stack([b, -2 * b + 1], axis=1)
    xj = np.asarray(jls.exact_least_squares(jnp.asarray(A), jnp.asarray(B), alg=alg))
    xt = tls.exact_least_squares(torch.from_numpy(A), torch.from_numpy(B), alg=alg)
    cond = np.linalg.cond(A)
    np.testing.assert_allclose(xt.numpy(), xj, atol=100 * cond * EPS32 * np.abs(xj).max())
    xv = tls.exact_least_squares(torch.from_numpy(A), torch.from_numpy(b), alg=alg)
    assert xv.shape == (12,)


def test_exact_ne_singular_raises():
    A = torch.zeros(10, 3)
    with pytest.raises(NumericalHealthError) as e:
        tls.exact_least_squares(A, torch.ones(10), alg="ne")
    assert e.value.code == 108
    with pytest.raises(ValueError):
        tls.exact_least_squares(A, torch.ones(10), alg="lu")


@pytest.mark.parametrize("stype,m,n,s", [
    ("FJLT", 4096, 64, None),   # default FJLT, s = 4n: the sampled kernel route
    ("FJLT", 1000, 20, 100),    # padded N, rfut_rowwise + lane gather
    ("CWT", 4096, 64, None),    # scatter (b) and one-hot (A) branches
    ("SJLT", 2000, 10, 80),
])
def test_approximate_least_squares_matches_jax(rng, jax_unguarded, stype, m, n, s):
    A, b = _problem(rng, m, n)
    params = dict(sketch_type=stype, sketch_size=s)
    xj = np.asarray(J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=9),
        J.linalg.LeastSquaresParams(**params)))
    xt = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=9),
        T.linalg.LeastSquaresParams(**params))
    assert xt.shape == (n,) and xt.dtype == torch.float32
    # The sketched system both packages solve.
    ss = s or 4 * n
    Sj = J.sketch.create_sketch(stype, m, ss, J.SketchContext(seed=9))
    St = T.sketch.create_sketch(stype, m, ss, T.SketchContext(seed=9))
    SAj = np.asarray(Sj.apply(jnp.asarray(A), "columnwise"))
    SAt = St.apply(torch.from_numpy(A), "columnwise").numpy()
    np.testing.assert_allclose(SAt, SAj, rtol=0, atol=1e-5 * np.abs(SAj).max())
    cond = np.linalg.cond(SAj.astype(np.float64))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=100 * cond * EPS32 * np.abs(xj).max())


def test_approximate_least_squares_is_near_optimal(rng):
    A, b = _problem(rng, 4096, 32)
    x = T.linalg.approximate_least_squares(A, b, T.SketchContext(seed=3), device="cpu")
    assert x.device.type == "cpu"
    At, bt = torch.from_numpy(A).double(), torch.from_numpy(b).double()
    opt = torch.linalg.lstsq(At, bt[:, None]).solution[:, 0]
    ratio = (At @ x.double() - bt).norm() / (At @ opt - bt).norm()
    assert 1.0 <= ratio <= 1.5


@pytest.mark.parametrize("route", ["refine", "blendenpik", "lsrn", "exact"])
def test_deferred_routes_raise(route):
    A = torch.zeros(8, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.linalg.approximate_least_squares(A, torch.zeros(8), T.SketchContext(),
                                           route=route)
    with pytest.raises(ValueError):
        T.linalg.approximate_least_squares(A, torch.zeros(8), T.SketchContext(),
                                           route="bogus")
