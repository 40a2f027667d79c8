"""Port vs JAX package: the Krylov solvers (``solvers/krylov.py``) and
their preconditioners, and the port's own chunked ≡ one-shot property.

Same seeded numpy inputs in f64 (x64 is on) to both packages.
Tolerance: X within 1e-10 of the JAX solution relative to its largest
entry, with equal iteration counts and flags (the port keeps the JAX
while-loop's exact stopping rule as a device-side mask).  Driving the
port's chunks by hand in chunks of 1 and 7 must give bitwise the
one-shot result.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import libskylark_tpu_torch as T
from libskylark_tpu.solvers import precond as jprecond
from libskylark_tpu_torch.resilient.chunked import graphable, stepper
from libskylark_tpu_torch.solvers import krylov as tk
from libskylark_tpu_torch.solvers import precond as tprecond

jk = importlib.import_module("libskylark_tpu.solvers.krylov")

RTOL = 1e-10


def _rel(x_port, x_jax):
    x_jax = np.asarray(x_jax)
    return np.abs(x_port.numpy() - x_jax).max() / np.abs(x_jax).max()


def _match(out_t, out_j, rtol=RTOL):
    (xt, it), (xj, ij) = out_t, out_j
    assert xt.shape == np.asarray(xj).shape
    assert _rel(xt, xj) <= rtol
    assert int(it["iterations"]) == int(ij["iterations"])
    assert int(it["flag"]) == int(ij["flag"])


def _spd(rng, n, shift=0.5):
    G = rng.standard_normal((3 * n, n))
    return G.T @ G + shift * np.eye(n)


def _lsqr_problem(rng, m, n, k):
    A = rng.standard_normal((m, n))
    B = rng.standard_normal((m, k)) if k else rng.standard_normal(m)
    return A, B


@pytest.mark.parametrize("m,n,k,tol,iters", [
    (300, 20, 0, 1e-14, 100),   # vector b, converges by S2
    (300, 20, 3, 1e-14, 100),   # multi-RHS
    (200, 40, 2, 1e-6, 100),    # loose tolerance: earlier stop
    (500, 60, 0, 1e-14, 7),     # stops at iter_lim
    (64, 64, 1, 1e-14, 200),    # square, consistent, well conditioned
])
def test_lsqr_matches_jax(rng, m, n, k, tol, iters):
    A, B = _lsqr_problem(rng, m, n, k)
    if m == n:
        A = A + 16 * np.eye(n)
        B = A @ rng.standard_normal((n, k))
    jp = jk.KrylovParams(tolerance=tol, iter_lim=iters)
    tp = tk.KrylovParams(tolerance=tol, iter_lim=iters)
    _match(tk.lsqr(torch.from_numpy(A), torch.from_numpy(B), params=tp),
           jk.lsqr(jnp.asarray(A), jnp.asarray(B), params=jp))


def test_lsqr_zero_column_and_x0(rng):
    A, B = _lsqr_problem(rng, 150, 12, 3)
    B[:, 1] = 0.0
    x0 = rng.standard_normal((12, 3))
    _match(tk.lsqr(torch.from_numpy(A), torch.from_numpy(B), x0=torch.from_numpy(x0)),
           jk.lsqr(jnp.asarray(A), jnp.asarray(B), x0=jnp.asarray(x0)))
    xt, _ = tk.lsqr(torch.from_numpy(A), torch.from_numpy(B))
    assert torch.equal(xt[:, 1], torch.zeros(12, dtype=torch.float64))


@pytest.mark.parametrize("kind", ["tri", "mat"])
def test_lsqr_preconditioned_matches_jax(rng, kind):
    A = rng.standard_normal((400, 25)) * np.logspace(0, -4, 25)
    b = rng.standard_normal(400)
    R = np.linalg.qr(A[::4], mode="r")
    if kind == "tri":
        pj, pt = jprecond.TriInversePrecond(jnp.asarray(R)), tprecond.TriInversePrecond(
            torch.from_numpy(R))
    else:
        N = np.linalg.inv(R)
        pj, pt = jprecond.MatPrecond(jnp.asarray(N)), tprecond.MatPrecond(torch.from_numpy(N))
    _match(tk.lsqr(torch.from_numpy(A), torch.from_numpy(b), precond=pt),
           jk.lsqr(jnp.asarray(A), jnp.asarray(b), precond=pj))


def test_lsqr_sparse_and_operator_pair(rng):
    D = rng.standard_normal((200, 15)) * (rng.random((200, 15)) < 0.3)
    b = rng.standard_normal(200)
    ref = jk.lsqr(jsparse.BCOO.fromdense(jnp.asarray(D)), jnp.asarray(b))
    _match(tk.lsqr(torch.from_numpy(D).to_sparse(), torch.from_numpy(b)), ref)
    At = torch.from_numpy(D)
    _match(tk.lsqr((lambda x: At @ x, lambda y: At.T @ y), torch.from_numpy(b)), ref)


@pytest.mark.parametrize("n,k,precond,tol", [
    (20, 0, None, 1e-14),
    (30, 3, None, 1e-14),
    (25, 2, "jacobi", 1e-14),
    (40, 0, None, 1e-4),
])
def test_cg_matches_jax(rng, n, k, precond, tol):
    # Kept to cond ~ 10^2 (the Jacobi case: a diagonal scaling of that):
    # on an ill-conditioned SPD matrix CG's iterates drift apart with the
    # rounding of either package, and so do its stopping iterations.
    G = _spd(rng, n)
    if precond:
        d = np.logspace(0, 1, n)
        G = d[:, None] * G * d[None, :]
    B = rng.standard_normal((n, k)) if k else rng.standard_normal(n)
    pj = pt = None
    if precond:
        M = np.diag(1.0 / np.diag(G))
        pj, pt = jprecond.MatPrecond(jnp.asarray(M)), tprecond.MatPrecond(torch.from_numpy(M))
    _match(tk.cg(torch.from_numpy(G), torch.from_numpy(B), precond=pt,
                 params=tk.KrylovParams(tolerance=tol)),
           jk.cg(jnp.asarray(G), jnp.asarray(B), precond=pj,
                 params=jk.KrylovParams(tolerance=tol)))


def test_cg_x0_matches_jax(rng):
    G = _spd(rng, 16)
    b, x0 = rng.standard_normal(16), rng.standard_normal(16)
    _match(tk.cg(torch.from_numpy(G), torch.from_numpy(b), x0=torch.from_numpy(x0)),
           jk.cg(jnp.asarray(G), jnp.asarray(b), x0=jnp.asarray(x0)))


@pytest.mark.parametrize("memory,k,precond", [
    (5, 0, None), (3, 2, None), (5, 1, "fixed"), (4, 0, "varying"),
])
def test_flexible_cg_matches_jax(rng, memory, k, precond):
    d = np.logspace(0, 0.5, 24)
    G = d[:, None] * _spd(rng, 24) * d[None, :]
    B = rng.standard_normal((24, k)) if k else rng.standard_normal(24)
    dinv = 1.0 / np.diag(G)
    pj = pt = None
    if precond == "fixed":
        pj = jprecond.MatPrecond(jnp.asarray(np.diag(dinv)))
        pt = tprecond.MatPrecond(torch.from_numpy(np.diag(dinv)))
    elif precond == "varying":
        dj, dt = jnp.asarray(dinv), torch.from_numpy(dinv)
        pj = lambda R, it: dj[:, None] * R * (1.0 + 0.1 * (it % 2))
        pt = lambda R, it: dt[:, None] * R * (1.0 + 0.1 * (it % 2))
    _match(tk.flexible_cg(torch.from_numpy(G), torch.from_numpy(B), precond=pt, memory=memory),
           jk.flexible_cg(jnp.asarray(G), jnp.asarray(B), precond=pj, memory=memory))


@pytest.mark.parametrize("iters,k", [(100, 0), (37, 2), (1, 0), (2, 1)])
def test_chebyshev_matches_jax(rng, iters, k):
    G = _spd(rng, 20)
    ev = np.linalg.eigvalsh(G)
    B = rng.standard_normal((20, k)) if k else rng.standard_normal(20)
    _match(tk.chebyshev(torch.from_numpy(G), torch.from_numpy(B), ev[0], ev[-1],
                        params=tk.KrylovParams(iter_lim=iters)),
           jk.chebyshev(jnp.asarray(G), jnp.asarray(B), ev[0], ev[-1],
                        params=jk.KrylovParams(iter_lim=iters)))


def test_lsqr_f32_matches_jax(rng):
    A = rng.standard_normal((500, 30)).astype(np.float32)
    b = rng.standard_normal(500).astype(np.float32)
    xt, it = tk.lsqr(torch.from_numpy(A), torch.from_numpy(b))
    xj, ij = jk.lsqr(jnp.asarray(A), jnp.asarray(b))
    assert xt.dtype == torch.float32
    # In f32 the 1e-14 tolerance is out of reach: LSQR stops on S2 or on
    # stagnation, a rounding-level event whose iteration differs between
    # the two packages' f32 recurrences.  On this well-conditioned A
    # (cond ~ 1.6) both solutions agree to 1e-5 of each other and of the
    # f64 least-squares solution.
    x64 = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64), rcond=None)[0]
    assert int(it["iterations"]) <= 100 and int(ij["iterations"]) <= 100
    assert _rel(xt, xj) <= 1e-5
    assert np.abs(xt.numpy() - x64).max() / np.abs(x64).max() <= 1e-5


def _by_hand(sol, chunk):
    s = sol.init_state()
    while not sol.is_done(s):
        s = sol.step_chunk(s, chunk)
    return s, sol.extract_result(s)


def _factories(rng):
    A, B = _lsqr_problem(rng, 120, 10, 2)
    G = _spd(rng, 12)
    b = rng.standard_normal(12)
    ev = np.linalg.eigvalsh(G)
    A, B, G, b = map(torch.from_numpy, (A, B, G, b))
    kp = tk.KrylovParams(iter_lim=30, tolerance=1e-12)
    return {
        "lsqr": (lambda: tk.lsqr_chunked(A, B, params=kp), lambda: tk.lsqr(A, B, params=kp)),
        "cg": (lambda: tk.cg_chunked(G, b, params=kp), lambda: tk.cg(G, b, params=kp)),
        "flexible_cg": (lambda: tk.flexible_cg_chunked(G, b, params=kp, memory=3),
                        lambda: tk.flexible_cg(G, b, params=kp, memory=3)),
        "chebyshev": (lambda: tk.chebyshev_chunked(G, b, ev[0], ev[-1], params=kp),
                      lambda: tk.chebyshev(G, b, ev[0], ev[-1], params=kp)),
    }


@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("kind", ["lsqr", "cg", "flexible_cg", "chebyshev"])
def test_chunked_is_bitwise_one_shot(rng, kind, chunk):
    factory, one_shot = _factories(rng)[kind]
    sol = factory()
    assert sol.kind == kind
    s, (X, info) = _by_hand(sol, chunk)
    X1, info1 = one_shot()
    assert torch.equal(X, X1)
    assert int(info["iterations"]) == int(info1["iterations"]) == sol.iteration(s)
    # A finished state stays as it is under further steps.
    s2 = sol.step_chunk(s, 3)
    assert all(torch.equal(s2[k], v) for k, v in s.items())


def test_chunk_of_zero_steps_and_zero_iter_lim(rng):
    A, b = _lsqr_problem(rng, 50, 5, 0)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    sol = tk.lsqr_chunked(At, bt)
    s = sol.init_state()
    assert all(torch.equal(sol.step_chunk(s, 0)[k], v) for k, v in s.items())
    x, info = tk.lsqr(At, bt, params=tk.KrylovParams(iter_lim=0))
    xj, ij = jk.lsqr(jnp.asarray(A), jnp.asarray(b), params=jk.KrylovParams(iter_lim=0))
    assert int(info["iterations"]) == int(ij["iterations"]) == 0
    assert torch.equal(x, torch.zeros(5, dtype=torch.float64))


def test_one_shot_syncs_once_per_chunk(rng, monkeypatch):
    """The one-shot loop reads the state once per SYNC_EVERY steps."""
    A, b = _lsqr_problem(rng, 300, 20, 0)
    calls = []
    orig = tk._chunked

    def spy(*args, **kw):
        sol = orig(*args, **kw)
        done = sol.is_done
        sol.is_done = lambda s: calls.append(1) or done(s)
        return sol

    monkeypatch.setattr(tk, "_chunked", spy)
    _, info = tk.lsqr(torch.from_numpy(A), torch.from_numpy(b))
    its = int(info["iterations"])
    assert len(calls) == -(-its // tk.SYNC_EVERY) + 1


def test_graphable_takes_only_dense_cuda_tensors(rng):
    """CUDA-graph steps are for dense CUDA matrices: CPU tensors, sparse
    COO tensors and (matvec, rmatvec) pairs run their steps eagerly."""
    A = torch.from_numpy(rng.standard_normal((6, 3)))
    assert not graphable(A)
    assert not graphable(A.to_sparse())
    assert not graphable((lambda x: x, lambda y: y))
    assert not tk._graphable(A, tk.IdPrecond())


def test_stepper_eager_runs_k_steps():
    advance = stepper(lambda s: {"x": 2 * s["x"], "it": s["it"] + 1}, graphed=False)
    s = {"x": torch.ones(3), "it": torch.zeros((), dtype=torch.int64)}
    assert advance(s, 0) is s
    out = advance(s, 3)
    assert torch.equal(out["x"], torch.full((3,), 8.0)) and int(out["it"]) == 3


@pytest.mark.parametrize("cls", ["IdPrecond", "MatPrecond", "TriInversePrecond"])
def test_preconditioners_match_jax(rng, cls):
    R = np.triu(rng.standard_normal((6, 6))) + 4 * np.eye(6)
    X = rng.standard_normal((6, 2))
    args = () if cls == "IdPrecond" else (R,)
    pj = getattr(jprecond, cls)(*map(jnp.asarray, args))
    pt = getattr(tprecond, cls)(*map(torch.from_numpy, args))
    for f in ("apply", "apply_adjoint"):
        for x in (X, X[:, 0]):
            out = getattr(pt, f)(torch.from_numpy(x))
            np.testing.assert_allclose(out.numpy(), np.asarray(getattr(pj, f)(jnp.asarray(x))),
                                       rtol=1e-12, atol=1e-12)


def test_lower_triangular_precond_matches_jax(rng):
    L = np.tril(rng.standard_normal((5, 5))) + 3 * np.eye(5)
    x = rng.standard_normal(5)
    pj = jprecond.TriInversePrecond(jnp.asarray(L), lower=True)
    pt = tprecond.TriInversePrecond(torch.from_numpy(L), lower=True)
    for f in ("apply", "apply_adjoint"):
        np.testing.assert_allclose(getattr(pt, f)(torch.from_numpy(x)).numpy(),
                                   np.asarray(getattr(pj, f)(jnp.asarray(x))), rtol=1e-12)


def test_exports():
    for name in ("lsqr", "cg", "flexible_cg", "chebyshev", "lsqr_chunked", "cg_chunked",
                 "flexible_cg_chunked", "chebyshev_chunked", "KrylovParams", "IdPrecond",
                 "MatPrecond", "TriInversePrecond"):
        assert hasattr(T.solvers, name)
    assert T.resilient.ChunkedSolver is tk.ChunkedSolver
    # The randomized Gauss-Seidel solvers are ported
    # (tests/test_torch_gauss_seidel.py), no longer deferred.
    from libskylark_tpu_torch.solvers import asynch, gauss_seidel

    assert T.solvers.asy_fcg is asynch.asy_fcg
    assert T.solvers.randomized_block_gauss_seidel is gauss_seidel.randomized_block_gauss_seidel
    for name in ("asy_fcg", "randomized_block_gauss_seidel"):
        assert name in T.solvers.__all__
        assert "not ported" not in (getattr(T.solvers, name).__doc__ or "")
    # Refinement is ported (tests/test_torch_refine.py).
    assert T.solvers.refine_least_squares.__module__.endswith("solvers.refine")
    assert "RefineParams" in T.solvers.__all__
    # The prox library is ported (tests/test_torch_prox.py).
    assert T.solvers.get_loss("hinge").name == "hinge"
    assert T.solvers.get_regularizer("l1").name == "l1"
    # The runner is ported (tests/test_torch_resilient.py), and so are
    # the host faults of the elastic layer (tests/test_torch_elastic.py)
    # and the fleet's drills (tests/test_torch_serve_sharded.py).
    assert T.resilient.ResilientRunner.__module__.endswith("resilient.runner")
    assert T.resilient.HostFaultPlan(slow_at_batch=1).slow_at_batch == 1
    assert T.resilient.FleetFaultPlan(slow_heartbeat_at=1).slow_heartbeat_at == 1
