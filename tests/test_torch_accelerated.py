"""Port vs JAX package: Blendenpik and LSRN (``solvers/accelerated.py``),
the least-squares routes of ``approximate_least_squares`` with the guard
ladder of the sketch route, and ``solve_regression``.

The JAX side runs with ``SKYLARK_NO_SRHT_GEMM=1`` (both packages take
the FJLT's WHT route), ``SKYLARK_POLICY=0`` (no profile store: the
default route) and ``SKYLARK_NO_PLANS=1`` (plans are bitwise eager by
contract, and the installed jax lacks an API the plan path needs).
Same seeded numpy inputs in f64 to both packages.  Tolerance: X within
1e-9 of the JAX solution relative to its largest entry, equal
``attempts``, and recovery records equal with each certificate's cond
within 1e-8 relative.  The port's own bitwise property: guarded ≡
unguarded on a healthy input, for Blendenpik, LSRN and the sketch route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.solvers import accelerated as jac
from libskylark_tpu.solvers import regression as jreg
from libskylark_tpu_torch.solvers import accelerated as tac
from libskylark_tpu_torch.solvers import regression as treg
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")


def _rel(x_port, x_jax):
    x_jax = np.asarray(x_jax)
    return np.abs(x_port.numpy() - x_jax).max() / np.abs(x_jax).max()


def _records_match(rt, rj):
    assert {k: v for k, v in rt.items() if k != "attempts"} == {
        k: v for k, v in rj.items() if k != "attempts"}
    assert len(rt["attempts"]) == len(rj["attempts"])
    for at, aj in zip(rt["attempts"], rj["attempts"]):
        assert {k: v for k, v in at.items() if k not in ("cond", "detail")} == {
            k: v for k, v in aj.items() if k not in ("cond", "detail")}
        assert at.get("detail", "")[:9] == aj.get("detail", "")[:9]
        if "cond" in aj:
            assert at["cond"] == pytest.approx(aj["cond"], rel=1e-8)


def _problem(rng, m, n, k=0, lo=0.0):
    A = rng.standard_normal((m, n)) * np.logspace(0, lo, n)
    B = rng.standard_normal((m, k)) if k else rng.standard_normal(m)
    return A, B


def _run(fn_t, fn_j, A, B, seed, tparams=None, jparams=None):
    xt, it = fn_t(torch.from_numpy(A), torch.from_numpy(B), T.SketchContext(seed=seed), tparams)
    xj, ij = fn_j(jnp.asarray(A), jnp.asarray(B), J.SketchContext(seed=seed), jparams)
    return (xt, it), (xj, ij)


def _assert_solution(out_t, out_j, rtol=RTOL):
    (xt, it), (xj, ij) = out_t, out_j
    assert xt.shape == np.asarray(xj).shape
    assert _rel(xt, xj) <= rtol
    assert int(it["iterations"]) == int(ij["iterations"])
    for key in ("attempts", "fallback"):
        assert it.get(key) == ij.get(key)
    if "condest" in ij:
        assert it["condest"] == pytest.approx(ij["condest"], rel=1e-8)
    _records_match(it["recovery"], ij["recovery"])


@pytest.mark.parametrize("m,n,k,lo,stype", [
    (2000, 30, 0, 0.0, None),     # FJLT, NB = 2048: the sampled WHT route
    (1500, 20, 2, -2.0, None),    # multi-RHS, cond 100
    (1000, 30, 0, -6.0, None),    # cond 1e6 (tests/test_solvers.py's case)
    (800, 16, 0, -1.0, "CWT"),
    (900, 12, 1, -1.0, "JLT"),
])
def test_blendenpik_matches_jax(rng, m, n, k, lo, stype):
    A, B = _problem(rng, m, n, k, lo)
    if lo == -6.0:
        B = A @ rng.standard_normal(n)
    out_t, out_j = _run(tac.faster_least_squares, jac.faster_least_squares, A, B, 11,
                        tac.FasterLeastSquaresParams(sketch_type=stype),
                        jac.FasterLeastSquaresParams(sketch_type=stype))
    _assert_solution(out_t, out_j)
    assert out_t[1]["attempts"] == 1


def test_blendenpik_retries_then_falls_back_like_jax(rng):
    """A cond threshold no R meets: three growing sketches, then the exact
    SVD solve, recorded as initial, grow, grow, fallback."""
    A, b = _problem(rng, 600, 10, 0, -1.0)
    out_t, out_j = _run(tac.faster_least_squares, jac.faster_least_squares, A, b, 3,
                        tac.FasterLeastSquaresParams(cond_threshold=1.0),
                        jac.FasterLeastSquaresParams(cond_threshold=1.0))
    _assert_solution(out_t, out_j)
    it = out_t[1]
    assert it["attempts"] == 3 and it["fallback"] == "svd" and it["iterations"] == 0
    assert [a["action"] for a in it["recovery"]["attempts"]] == [
        "initial", "grow", "grow", "fallback"]
    assert [a["sketch_size"] for a in it["recovery"]["attempts"][:3]] == [40, 80, 160]


def test_blendenpik_ill_conditioned_f32_retries_like_jax(rng):
    """f32 past its threshold 0.1/sqrt(eps) ~ 290: the retry loop grows
    the sketch, then falls back, as in the JAX package.  The f32 sketches
    and QRs of the two packages round differently, so the condest values
    agree to 1e-3 and the fallback solutions (f32 SVDs of A) to f32
    accuracy scaled by cond(A) = 1e4."""
    A, b = _problem(rng, 1000, 16, 0, -4.0)
    A, b = A.astype(np.float32), b.astype(np.float32)
    (xt, it), (xj, ij) = _run(tac.faster_least_squares, jac.faster_least_squares, A, b, 5)
    assert it["attempts"] == ij["attempts"] == 3 and it["fallback"] == ij["fallback"] == "svd"
    assert [(a["action"], a["verdict"], a["sketch_size"]) for a in it["recovery"]["attempts"][:3]
            ] == [(a["action"], a["verdict"], a["sketch_size"])
                  for a in ij["recovery"]["attempts"][:3]]
    for at, aj in zip(it["recovery"]["attempts"][:3], ij["recovery"]["attempts"][:3]):
        assert at["cond"] == pytest.approx(aj["cond"], rel=1e-3)
    assert xt.dtype == torch.float32
    assert _rel(xt, xj) <= 1e4 * 100 * np.finfo(np.float32).eps


@pytest.mark.parametrize("m,n,k,stype,deficient", [
    (1500, 20, 0, None, False),
    (1200, 24, 2, None, True),     # rank-deficient: A = [G, G[:, :8]]
    (900, 15, 0, "CWT", False),
    (800, 16, 0, "FJLT", True),
])
def test_lsrn_matches_jax(rng, m, n, k, stype, deficient):
    A, B = _problem(rng, m, n, k)
    if deficient:
        A[:, -8:] = A[:, :8]
    out_t, out_j = _run(tac.lsrn_least_squares, jac.lsrn_least_squares, A, B, 13,
                        tac.FasterLeastSquaresParams(sketch_type=stype),
                        jac.FasterLeastSquaresParams(sketch_type=stype))
    _assert_solution(out_t, out_j)


@pytest.mark.parametrize("solver", ["faster_least_squares", "lsrn_least_squares"])
def test_guarded_is_bitwise_unguarded(rng, monkeypatch, solver):
    A, b = _problem(rng, 1200, 20, 0, -1.0)
    fn = getattr(tac, solver)
    xg, ig = fn(torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=7))
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    xu, iu = fn(torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=7))
    assert torch.equal(xg, xu)
    assert ig["recovery"]["guarded"] is True and iu["recovery"]["guarded"] is False
    assert int(ig["iterations"]) == int(iu["iterations"])
    if solver == "faster_least_squares":
        assert iu["recovery"]["attempts"] == ig["recovery"]["attempts"]  # the native loop
    else:
        assert iu["recovery"]["attempts"] == []


def test_accelerated_refuses_sparse_and_wide(rng):
    D = torch.from_numpy(rng.standard_normal((50, 5))).to_sparse()
    for fn in (tac.faster_least_squares, tac.lsrn_least_squares):
        with pytest.raises(UnsupportedError, match="ROADMAP Queue C"):
            fn(D, torch.ones(50, dtype=torch.float64), T.SketchContext())
    with pytest.raises(ValueError, match="tall"):
        tac.faster_least_squares(torch.ones(3, 5), torch.ones(3), T.SketchContext())


def test_tri_condest_matches_jax(rng):
    R = np.triu(rng.standard_normal((12, 12))) + 5 * np.eye(12)
    assert tac._tri_condest(torch.from_numpy(R)) == pytest.approx(
        jac._tri_condest(jnp.asarray(R)), rel=1e-12)


# -- least-squares routes -----------------------------------------------------


@pytest.mark.parametrize("route,k", [("blendenpik", 0), ("lsrn", 0), ("blendenpik", 2),
                                     ("lsrn", 1)])
def test_ls_accelerated_routes_match_jax(rng, route, k):
    A, B = _problem(rng, 1500, 20, k, -1.0)
    xt, it = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(B), T.SketchContext(seed=4), route=route,
        return_info=True)
    xj, ij = J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(B), J.SketchContext(seed=4), route=route, return_info=True)
    _assert_solution((xt, it), (xj, ij))
    assert set(it) == set(ij)
    assert it["policy"] == ij["policy"]


@pytest.mark.parametrize("stype,alg,k", [
    ("FJLT", "qr", 0), ("FJLT", "ne", 2), ("CWT", "qr", 0), ("SJLT", "sne", 1),
    ("JLT", "svd", 0),
])
def test_ls_guarded_sketch_route_matches_jax(rng, stype, alg, k):
    A, B = _problem(rng, 2000, 16, k, -1.0)
    p = dict(sketch_type=stype)
    xt, it = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(B), T.SketchContext(seed=6),
        T.linalg.LeastSquaresParams(**p), alg=alg, return_info=True)
    xj, ij = J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(B), J.SketchContext(seed=6),
        J.linalg.LeastSquaresParams(**p), alg=alg, return_info=True)
    assert _rel(xt, xj) <= RTOL
    _records_match(it["recovery"], ij["recovery"])
    assert it["recovery"]["attempts"][0]["verdict"] == "OK"


def test_ls_ladder_climbs_like_jax(rng, monkeypatch):
    """A certification ceiling no sketch meets: resketch, grow, then the
    exact SVD solve of the full problem, as in the JAX package."""
    monkeypatch.setenv("SKYLARK_GUARD_COND_MAX", "1.0")
    A, b = _problem(rng, 1000, 12, 0, -1.0)
    xt, it = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=2), return_info=True)
    xj, ij = J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=2), return_info=True)
    _records_match(it["recovery"], ij["recovery"])
    assert [a["action"] for a in it["recovery"]["attempts"]] == [
        "initial", "resketch", "grow", "fallback"]
    assert [a.get("sketch_size") for a in it["recovery"]["attempts"]] == [48, 48, 96, None]
    assert _rel(xt, xj) <= RTOL
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    assert np.abs(xt.numpy() - x_ls).max() <= 1e-10 * np.abs(x_ls).max()


@pytest.mark.parametrize("stype", ["FJLT", "CWT"])
def test_ls_guarded_is_bitwise_unguarded(rng, monkeypatch, stype):
    A, b = _problem(rng, 1024, 16, 0, -1.0)
    A32, b32 = torch.from_numpy(A.astype(np.float32)), torch.from_numpy(b.astype(np.float32))
    p = T.linalg.LeastSquaresParams(sketch_type=stype)
    xg, ig = T.linalg.approximate_least_squares(A32, b32, T.SketchContext(seed=3), p,
                                                return_info=True)
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    xu, iu = T.linalg.approximate_least_squares(A32, b32, T.SketchContext(seed=3), p,
                                                return_info=True)
    assert torch.equal(xg, xu)
    assert ig["recovery"]["attempts"][0]["verdict"] == "OK"
    assert iu["recovery"] == {"stage": "sketch_and_solve_ls", "guarded": False,
                              "recovered": False, "attempts": []}
    assert torch.equal(xu, T.linalg.approximate_least_squares(A32, b32, T.SketchContext(seed=3),
                                                              p))


def test_ls_deferred_options_raise():
    # fault_plan= is ported (tests/test_torch_refine.py holds its verdicts
    # against the JAX package): a plan with no fault leaves the solve
    # bitwise as it is.  Sparse Blendenpik and LSRN still raise.
    A = torch.from_numpy(np.random.default_rng(2).standard_normal((64, 2)))
    b = A @ torch.ones(2, dtype=A.dtype)
    x, info = T.linalg.approximate_least_squares(A, b, T.SketchContext(), return_info=True,
                                                 fault_plan=T.resilient.FaultPlan())
    assert torch.equal(x, T.linalg.approximate_least_squares(A, b, T.SketchContext()))
    assert info["recovery"]["attempts"][0]["verdict"] == "OK"
    D = torch.zeros(8, 2).to_sparse()
    for route in ("blendenpik", "lsrn"):
        with pytest.raises(UnsupportedError, match="ROADMAP Queue C"):
            T.linalg.approximate_least_squares(D, torch.zeros(8), T.SketchContext(),
                                               route=route)


# -- solve_regression ---------------------------------------------------------


@pytest.mark.parametrize("solver,reg,k", [
    ("exact", "none", 0), ("exact", "ridge", 2), ("sketched", "none", 0),
    ("auto", "none", 1), ("sketched", "ridge", 0), ("accelerated", "none", 0),
    ("lsrn", "none", 2), ("accelerated", "ridge", 0),
])
def test_solve_regression_matches_jax(rng, solver, reg, k):
    A, B = _problem(rng, 1200, 14, k, -1.0)
    lam = 0.7 if reg == "ridge" else 0.0
    out_t = treg.solve_regression(
        treg.RegressionProblem(torch.from_numpy(A), regularization=reg, lam=lam),
        torch.from_numpy(B), solver, T.SketchContext(seed=8))
    out_j = jreg.solve_regression(
        jreg.RegressionProblem(jnp.asarray(A), regularization=reg, lam=lam),
        jnp.asarray(B), solver, J.SketchContext(seed=8))
    if solver in ("accelerated", "lsrn"):
        _assert_solution(out_t, out_j)
    else:
        assert _rel(out_t, out_j) <= RTOL
    if reg == "ridge" and solver == "exact":
        X = out_t.numpy()
        ref = np.linalg.solve(A.T @ A + lam * np.eye(14), A.T @ B)
        assert np.abs(X - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("k", [0, 2])
def test_solve_regression_l1_matches_jax(rng, k):
    A, B = _problem(rng, 600, 8, k)
    B = B + (rng.random(B.shape) < 0.05) * 50.0  # outliers an l1 fit ignores
    xt = treg.solve_regression(treg.RegressionProblem(torch.from_numpy(A), penalty="l1"),
                               torch.from_numpy(B), context=T.SketchContext(seed=1))
    xj = jreg.solve_regression(jreg.RegressionProblem(jnp.asarray(A), penalty="l1"),
                               jnp.asarray(B), context=J.SketchContext(seed=1))
    # 30 IRLS sweeps on the MMT-sketched problem, each an exact solve of a
    # reweighted system: rounding differences compound to ~1e-10.
    assert _rel(xt, xj) <= 1e-8


def test_solve_regression_errors():
    P = treg.RegressionProblem(torch.ones(6, 2, dtype=torch.float64))
    b = torch.ones(6, dtype=torch.float64)
    for solver in ("sketched", "accelerated", "lsrn", "auto"):
        with pytest.raises(ValueError, match="SketchContext"):
            treg.solve_regression(P, b, solver)
    with pytest.raises(ValueError, match="SketchContext"):
        treg.solve_regression(treg.RegressionProblem(P.A, penalty="l1"), b)
    with pytest.raises(ValueError, match="unknown solver"):
        treg.solve_regression(P, b, "bogus", T.SketchContext())
    for solver in ("refine", "accelerated"):
        with pytest.raises(ValueError, match="SketchContext"):
            treg.solve_regression(P, b, solver)
    assert P.shape == (6, 2)
    for name in ("solve_regression", "RegressionProblem", "faster_least_squares",
                 "lsrn_least_squares", "FasterLeastSquaresParams"):
        assert hasattr(T.solvers, name)
