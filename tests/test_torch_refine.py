"""Port vs JAX package: mixed-precision refinement
(``solvers/refine.py``), the refine and exact routes of
``approximate_least_squares`` with ``fault_plan=``, and
``solve_regression(..., "refine")``.

The JAX side runs with ``SKYLARK_POLICY=0 SKYLARK_NO_PLANS=1
SKYLARK_NO_SRHT_GEMM=1`` (no profile store; plans are bitwise eager by
contract; both packages take the FJLT's WHT route) and x64 on
(``tests/conftest.py``), so its residuals are f64 as the port's always
are.  ``tests/test_refine.py`` does not collect under the installed jax,
so the reference functions are called directly.  The same seeded numpy
inputs go to both packages.

Tolerances, each relative to the largest entry of the reference:

- refined x within ``X_TOL`` = 1e-9 of the JAX package's and of
  ``np.linalg.lstsq`` in f64, and a residual within ``1 + 1e-12`` of
  lstsq's;
- ``info["refine"]``: rung, sketch size, halt and convergence equal;
  sweeps equal or within ``ITERS_SLACK`` = 2.  The preconditioner's
  triangular solves run in f32, and the sweep that first crosses the
  gate moves with their rounding: the JAX package's own count moves
  between 34 and 35 when the rows of its S·A are permuted before the
  QR (the same R up to row signs, rounded otherwise), which
  ``test_refine_converges_as_jax`` shows wherever the counts differ;
- certificate conds within ``COND_TOL`` = 1e-2: ``cond_est`` runs
  Lanczos without reorthogonalization, which spreads σ_min that far
  (ROADMAP Queue C);
- the exact route's x within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.solvers import refine as jref
from libskylark_tpu.solvers import regression as jreg
from libskylark_tpu.utils.exceptions import RefinementError as JRefinementError
from libskylark_tpu_torch.solvers import refine as tref
from libskylark_tpu_torch.solvers import regression as treg
from libskylark_tpu_torch.utils.exceptions import RefinementError, UnsupportedError

X_TOL = 1e-9
RATIO_TOL = 1e-12
ITERS_SLACK = 2
COND_TOL = 1e-2
EXACT_TOL = 1e-10
M, N = 2048, 32

_JAX = {}  # JAX results by case: each refine shape compiles its sweep once


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")


def _problem(dtype=np.float64, k=None, m=M, n=N, seed=0):
    """A (m, n) with column scales over a decade, B = A·X + 1e-3·G, in
    ``dtype``; B is a vector when k is None."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * np.logspace(0, -1, n)
    X = rng.standard_normal((n, k or 1))
    B = A @ X + 1e-3 * rng.standard_normal((m, k or 1))
    return A.astype(dtype), (B[:, 0] if k is None else B).astype(dtype)


def _rel(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape
    return np.abs(port.astype(np.float64) - ref).max() / np.abs(ref).max()


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _refine_both(A, B, seed=3, tparams=None, jparams=None, fault=None):
    jfault = J.resilient.FaultPlan(**fault) if fault else None
    tfault = T.resilient.FaultPlan(**fault) if fault else None
    xt, it = tref.refine_least_squares(torch.from_numpy(A), torch.from_numpy(B),
                                       T.SketchContext(seed=seed), tparams, fault_plan=tfault)
    xj, ij = jref.refine_least_squares(jnp.asarray(A), jnp.asarray(B),
                                       J.SketchContext(seed=seed), jparams, fault_plan=jfault)
    return (xt, it), (np.asarray(xj), ij)


def _verdicts(info):
    return [(a["action"], a.get("verdict")) for a in info["recovery"]["attempts"]]


def _conds_agree(it, ij):
    """Each certificate's cond within COND_TOL; a numerically singular
    sketch's estimate is rounding noise, so where the JAX package's
    exceeds the f32 ceiling (the certificates are f32), both must."""
    ceiling = T.guard.cond_max(torch.float32)
    at, aj = it["recovery"]["attempts"], ij["recovery"]["attempts"]
    assert [a.get("cond") is None for a in at] == [a.get("cond") is None for a in aj]
    for a, b in zip(at, aj):
        if b.get("cond") is None:
            continue
        if b["cond"] < ceiling:
            assert a["cond"] == pytest.approx(b["cond"], rel=COND_TOL)
        else:
            assert min(a["cond"], b["cond"]) >= ceiling


def _jax_iters_under_row_perms(A, B, perms=6):
    """The JAX package's sweep counts with R from the QR of its own S·A
    with the rows permuted (the same factor up to row signs)."""
    B2 = jnp.asarray(B[:, None] if B.ndim == 1 else B, jnp.float64)
    A_w, qr_dtype, _ = jref._working_cast(jnp.asarray(A), jnp.asarray(A).dtype)
    SA = J.sketch.FJLT(A.shape[0], 4 * A.shape[1], J.SketchContext(seed=3)).apply(
        A_w, "columnwise").astype(qr_dtype)
    R0 = jnp.linalg.qr(SA, mode="r")
    kw = dict(sigma_max=float(np.linalg.svd(np.asarray(R0), compute_uv=False)[0]),
              rtol=float(np.finfo(np.float64).eps) ** 0.75, max_iters=100,
              stagnation_factor=0.9, rdtype=jnp.float64)
    rng = np.random.default_rng(0)
    return {jref._refine_loop(jnp.asarray(A, jnp.float64), B2,
                              jnp.linalg.qr(SA[rng.permutation(SA.shape[0])], mode="r"),
                              **kw)[1]["iters"] for _ in range(perms)}


def _same_refine(rt, rj, slack=0):
    for key in ("rung", "sketch_size", "converged", "halt"):
        assert rt.get(key) == rj.get(key), key
    assert abs(rt["iters"] - rj["iters"]) <= slack


def test_refine_leaves_the_sketch_route_bitwise():
    A, b = (torch.from_numpy(a) for a in _problem(np.float32))
    ls = T.linalg.approximate_least_squares
    before = ls(A, b, T.SketchContext(seed=3))
    ls(A, b, T.SketchContext(seed=3), route="refine")
    assert torch.equal(ls(A, b, T.SketchContext(seed=3)), before)


@pytest.mark.parametrize("k", [None, 1, 3])
@pytest.mark.parametrize("dtype,rung", [(np.float64, "f32"), (np.float32, "bf16+f32")])
def test_refine_converges_as_jax(dtype, rung, k):
    A, B = _problem(dtype, k)
    (xt, it), (xj, ij) = _jax(("converge", dtype, k), lambda: _refine_both(A, B))
    assert xt.dtype == torch.float64
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    x_ls = np.linalg.lstsq(A64, B64, rcond=None)[0]
    assert _rel(xt, xj) <= X_TOL
    assert _rel(xt, x_ls) <= X_TOL
    res = np.linalg.norm(A64 @ xt.numpy() - B64)
    assert res <= (1 + RATIO_TOL) * np.linalg.norm(A64 @ x_ls - B64)
    assert it["refine"]["rung"] == rung
    assert it["refine"]["halt"] == "converged"
    _same_refine(it["refine"], ij["refine"], slack=ITERS_SLACK)
    if it["refine"]["iters"] != ij["refine"]["iters"]:
        moved = _jax(("perms", dtype, k), lambda: _jax_iters_under_row_perms(A, B))
        assert it["refine"]["iters"] in moved | {ij["refine"]["iters"]}
        assert max(moved) - min(moved) >= 1, moved
    assert _verdicts(it) == _verdicts(ij) == [("initial", "OK")]
    _conds_agree(it, ij)


def test_refine_guarded_is_bitwise_unguarded(monkeypatch):
    """Guarded attempt 0 sketches with the caller's context, unguarded a
    copy of it: the JAX package returns bitwise the same x both ways, and
    so does the port."""
    A, b = _problem(np.float32)
    xt, _ = tref.refine_least_squares(torch.from_numpy(A), torch.from_numpy(b),
                                      T.SketchContext(seed=3))
    xj, _ = jref.refine_least_squares(jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=3))
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    xtu, it = tref.refine_least_squares(torch.from_numpy(A), torch.from_numpy(b),
                                        T.SketchContext(seed=3))
    xju, ij = jref.refine_least_squares(jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=3))
    assert np.array_equal(np.asarray(xju), np.asarray(xj))
    assert torch.equal(xtu, xt)
    assert it["recovery"] == ij["recovery"] == {"stage": "refine_ls", "guarded": False,
                                                "recovered": False, "attempts": []}


def test_refine_is_exact_f64_when_the_sketch_fills_the_rows():
    A, b = _problem(m=96)  # s0 = min(4n, m) = m
    (xt, it), (xj, ij) = _refine_both(A, b)
    assert it == ij
    assert it["refine"] == {"iters": 0, "rung": "exact-f64", "converged": True,
                            "sketch_size": 96}
    assert _rel(xt, xj) <= EXACT_TOL


def test_refine_stagnation_walks_the_ladder_to_the_fallback(monkeypatch):
    A, b = _problem()
    stuck = dict(max_iters=1, rtol=1e-300)
    (xt, it), (xj, ij) = _refine_both(A, b, tparams=tref.RefineParams(**stuck),
                                      jparams=jref.RefineParams(**stuck))
    assert _verdicts(it) == _verdicts(ij)
    assert _verdicts(it)[-1] == ("fallback", "FALLBACK")
    assert it["recovery"]["recovered"] and ij["recovery"]["recovered"]
    _conds_agree(it, ij)
    _same_refine(it["refine"], ij["refine"])
    assert it["refine"]["halt"] == "fallback"
    assert _rel(xt, xj) <= EXACT_TOL
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    with pytest.raises(RefinementError) as et:
        tref.refine_least_squares(torch.from_numpy(A), torch.from_numpy(b),
                                  T.SketchContext(seed=3), tref.RefineParams(**stuck))
    with pytest.raises(JRefinementError) as ej:
        jref.refine_least_squares(jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=3),
                                  jref.RefineParams(**stuck))
    assert et.value.code == ej.value.code == 115
    assert (et.value.iters, et.value.stage) == (ej.value.iters, ej.value.stage) == (1, "refine_ls")
    assert et.value.residual == pytest.approx(ej.value.residual, rel=COND_TOL)


@pytest.mark.parametrize("route", ["sketch", "refine"])
@pytest.mark.parametrize("fault", ["nan_at", "bad_sketch_at"])
def test_fault_plan_recovers_as_jax(route, fault):
    A, b = _problem(np.float32)
    plan = {fault: 0}
    xt, it = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=3), route=route,
        fault_plan=T.resilient.FaultPlan(**plan), return_info=True)
    xj, ij = _jax(("fault", route, fault), lambda: J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=3), route=route,
        fault_plan=J.resilient.FaultPlan(**plan), return_info=True))
    assert _verdicts(it) == _verdicts(ij) == [("initial", "RESKETCH"), ("resketch", "OK")]
    assert it["recovery"]["recovered"] and ij["recovery"]["recovered"]
    _conds_agree(it, ij)
    assert it["policy"] == ij["policy"]
    if route == "refine":
        _same_refine(it["refine"], ij["refine"], slack=ITERS_SLACK)
        assert _rel(xt, xj) <= X_TOL
    else:  # an f32 sketch-and-solve of the resketched draw
        assert _rel(xt, xj) <= 1e-5


def test_unguarded_fault_plan_poisons_attempt_zero(monkeypatch):
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    A, b = _problem()
    xt = T.linalg.approximate_least_squares(torch.from_numpy(A), torch.from_numpy(b),
                                            T.SketchContext(seed=3),
                                            fault_plan=T.resilient.FaultPlan(nan_at=0))
    xj = J.linalg.approximate_least_squares(jnp.asarray(A), jnp.asarray(b),
                                            J.SketchContext(seed=3),
                                            fault_plan=J.resilient.FaultPlan(nan_at=0))
    assert bool(torch.isnan(xt).all()) and bool(np.isnan(np.asarray(xj)).all())


def test_refine_with_qjlt_matches_jax():
    A, b = _problem(n=16)
    p = dict(sketch_type="QJLT")
    (xt, it), (xj, ij) = _refine_both(A, b, tparams=tref.RefineParams(**p),
                                      jparams=jref.RefineParams(**p))
    assert _rel(xt, xj) <= X_TOL
    _same_refine(it["refine"], ij["refine"], slack=ITERS_SLACK)
    assert _verdicts(it) == _verdicts(ij)
    _conds_agree(it, ij)


def test_sparse_refine_raises_naming_queue_c():
    A, b = _problem(m=256, n=8)
    A[np.abs(A) < 1.0] = 0.0
    coo = torch.from_numpy(A).to_sparse()
    with pytest.raises(UnsupportedError, match="ROADMAP Queue C"):
        tref.refine_least_squares(coo, torch.from_numpy(b), T.SketchContext())
    with pytest.raises(UnsupportedError, match="ROADMAP Queue C"):
        T.linalg.approximate_least_squares(coo, torch.from_numpy(b), T.SketchContext(),
                                           route="refine")
    # The reference fails there too (its QR of the sparse S·A).
    idx = np.argwhere(A != 0)
    bcoo = jsparse.BCOO((jnp.asarray(A[A != 0]), jnp.asarray(idx)), shape=A.shape)
    with pytest.raises(TypeError):
        jref.refine_least_squares(bcoo, jnp.asarray(b), J.SketchContext())


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("k", [None, 2])
def test_exact_route_matches_jax(sparse, k):
    A, B = _problem(k=k, m=512, n=16)
    if sparse:
        A[np.abs(A) < 0.5] = 0.0
        idx = np.argwhere(A != 0)
        At = T.utils.coo_from_bcoo_arrays(A[A != 0], idx, A.shape, device="cpu")
        Aj = jsparse.BCOO((jnp.asarray(A[A != 0]), jnp.asarray(idx)), shape=A.shape)
    else:
        At, Aj = torch.from_numpy(A), jnp.asarray(A)
    xt, it = T.linalg.approximate_least_squares(At, torch.from_numpy(B), T.SketchContext(seed=1),
                                                route="exact", return_info=True)
    xj, ij = J.linalg.approximate_least_squares(Aj, jnp.asarray(B), J.SketchContext(seed=1),
                                                route="exact", return_info=True)
    assert _rel(xt, xj) <= EXACT_TOL
    assert it == ij


@pytest.mark.parametrize("k", [0, 2])
def test_solve_regression_refine_matches_jax(k):
    A, B = _problem(k=k or None, m=1200, n=14)
    xt, it = treg.solve_regression(treg.RegressionProblem(torch.from_numpy(A)),
                                   torch.from_numpy(B), "refine", T.SketchContext(seed=8))
    xj, ij = jreg.solve_regression(jreg.RegressionProblem(jnp.asarray(A)), jnp.asarray(B),
                                   "refine", J.SketchContext(seed=8))
    assert _rel(xt, xj) <= X_TOL
    _same_refine(it["refine"], ij["refine"], slack=ITERS_SLACK)
    assert it["policy"] == ij["policy"]
    assert _verdicts(it) == _verdicts(ij)
