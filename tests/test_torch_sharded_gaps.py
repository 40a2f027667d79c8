"""Port vs JAX package: the two sharded routes that ran unsharded-only
until the matmul-route slice, on the host-device meshes of
``tests/test_torch_multichip.py`` (1, 2 and 4 CPU slots).

- Ridge regularization of a row-sharded A: the port lays ``[A; √λ I]``
  over the mesh's equal row blocks (``solvers/regression.py``); the JAX
  package concatenates on the sharded array under GSPMD.  Held against
  the JAX package's solve within 1e-10 (exact) and 1e-8 (sketched, whose
  columnwise FJLT runs the subsampled-Hadamard GEMM on each slot's rows
  of G in both packages) of its largest entry.
- A columnwise DCT FJLT of a row-sharded A (``parallel/routes.py``): A
  moved to column blocks, each slot's columns sketched whole; and a
  columnwise WHT FJLT of a row-sharded A on the GEMM route.  Held
  against the JAX package's apply within 1e-12 (f64) and 1e-5 (f32) of
  the largest entry.

A mesh of one is bitwise the port's unsharded call, and no route
gathers A.  The JAX package runs in its default environment, with its
plans off (its plan path needs an API the installed jax removed) and
``SKYLARK_POLICY=0``, as ``tests/test_torch_multichip.py`` has it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.plans.plan as jplan
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
from libskylark_tpu_torch.parallel import mesh as tmesh

SLOTS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX",
                "SKYLARK_NO_SRHT_GEMM"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


@pytest.fixture
def rng():
    return np.random.default_rng(29)


@pytest.fixture
def gathers(monkeypatch):
    """Shapes of every sharded value gathered while the test runs."""
    seen = []
    orig = tmesh.fully_replicated

    def wrapped(x):
        if isinstance(x, tmesh.Sharded) and x.mesh.size > 1:
            seen.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(tmesh, "fully_replicated", wrapped)
    return seen


def _mesh(p):
    return T.parallel.default_mesh(p, device="cpu")


def _rel(got, want):
    got = T.parallel.fully_replicated(got).double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _x(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("p", SLOTS)
@pytest.mark.parametrize("solver,tol", [("exact", 1e-10), ("sketched", 1e-8)])
@pytest.mark.parametrize("rhs", [1, 3])
def test_ridge_on_a_sharded_a_matches_jax(rng, solver, tol, p, rhs, gathers):
    m, n, lam = 1020, 12, 40.0   # m + n = 1032 rows over 1, 2 and 4 slots
    A = rng.standard_normal((m, n))
    B = rng.standard_normal((m, rhs) if rhs > 1 else m)
    want = _x(J.solvers.solve_regression(
        J.solvers.RegressionProblem(jnp.asarray(A), regularization="ridge", lam=lam),
        jnp.asarray(B), solver, J.SketchContext(seed=5)))
    prob = T.solvers.RegressionProblem(T.parallel.shard_rows(torch.from_numpy(A), _mesh(p)),
                                       regularization="ridge", lam=lam)
    got = _x(T.solvers.solve_regression(prob, torch.from_numpy(B), solver,
                                        T.SketchContext(seed=5)))
    assert _rel(got, np.asarray(want)) <= tol
    # The control: the solve without the ridge term misses.
    plain = _x(J.solvers.solve_regression(J.solvers.RegressionProblem(jnp.asarray(A)),
                                          jnp.asarray(B), solver, J.SketchContext(seed=5)))
    assert _rel(got, np.asarray(plain)) > 1e-3
    if p == 1:
        local = _x(T.solvers.solve_regression(
            T.solvers.RegressionProblem(torch.from_numpy(A), regularization="ridge", lam=lam),
            torch.from_numpy(B), solver, T.SketchContext(seed=5)))
        assert torch.equal(got, local)
    assert (m, n) not in gathers and (m + n, n) not in gathers


@pytest.mark.parametrize("p", [2, 4])
def test_ridge_augmented_blocks_hold_a_and_the_ridge_rows(rng, p):
    """Each slot's block of ``[A; √λ I]`` is those rows of the augmented
    matrix, made on the slot without gathering A."""
    from libskylark_tpu_torch.solvers.regression import _augment_ridge, _augment_ridge_sharded

    A = torch.from_numpy(rng.standard_normal((60, 4)))
    B = torch.from_numpy(rng.standard_normal(60))
    As = T.parallel.shard_rows(A, _mesh(p))
    got, B_aug = _augment_ridge_sharded(As, B, 2.25)
    want, B_want = _augment_ridge(A, B, 2.25)
    assert isinstance(got, tmesh.Sharded) and got.shape == (64, 4)
    assert all(s.shape == (64 // p, 4) for s in got.shards)
    assert torch.equal(T.parallel.fully_replicated(got), want) and torch.equal(B_aug, B_want)


@pytest.mark.parametrize("p", SLOTS)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("m", [1, 3, 9])
def test_dct_fjlt_of_a_sharded_a_matches_jax(rng, dtype, tol, p, m, gathers):
    """Column blocks of any width (fewer columns than slots included); the
    gather kernel runs on each slot's block."""
    n, s = 300, 40
    A = rng.standard_normal((n, m)).astype(dtype)
    want = J.sketch.FJLT(n, s, J.SketchContext(seed=8), fut="dct").apply(jnp.asarray(A))
    St = T.sketch.FJLT(n, s, T.SketchContext(seed=8), fut="dct")
    At = torch.from_numpy(A)
    As = T.parallel.shard_rows(At, T.parallel.make_mesh((p,), (T.parallel.ROWS,),
                                                        devices="cpu"))
    got = St.apply(As)
    assert isinstance(got, torch.Tensor) and got.dtype == At.dtype
    assert _rel(got, np.asarray(want)) <= tol
    other = T.sketch.FJLT(n, s, T.SketchContext(seed=9), fut="dct").apply(At)
    assert _rel(other, np.asarray(want)) > 1e-2
    local = St.apply(At)
    if p == 1:
        assert torch.equal(got, local)
    else:
        assert _rel(got, local.double().numpy()) <= tol
    assert (n, m) not in gathers


@pytest.mark.parametrize("p", SLOTS)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_wht_fjlt_of_a_sharded_a_takes_the_gemm(rng, dtype, tol, p, monkeypatch, gathers):
    """Where the gate holds, each slot multiplies its rows of G with its
    block and one psum merges (the Kronecker split's gather kernel is not
    launched); against the JAX package's GEMM route."""
    from libskylark_tpu_torch.sketch import kernels_window

    n, s, m = 512, 64, 6
    A = rng.standard_normal((n, m)).astype(dtype)
    Sj = J.sketch.FJLT(n, s, J.SketchContext(seed=10))
    St = T.sketch.FJLT(n, s, T.SketchContext(seed=10))
    assert St._gemm_wins(torch.from_numpy(A).dtype) and Sj._gemm_wins(jnp.dtype(dtype))
    calls = []
    real = kernels_window.gather_scaled_rows
    monkeypatch.setattr(kernels_window, "gather_scaled_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = St.apply(T.parallel.shard_rows(torch.from_numpy(A), _mesh(p)))
    assert _rel(got, np.asarray(Sj.apply(jnp.asarray(A)))) <= tol
    assert not calls
    if p == 1:
        assert torch.equal(got, St.apply(torch.from_numpy(A)))
    assert (n, m) not in gathers
