"""Port vs JAX package: the randomized Gauss-Seidel solvers
(``solvers/gauss_seidel.py``: ``randomized_block_gauss_seidel``,
``gs_num_blocks``; ``solvers/asynch.py``: ``asy_fcg``) on the CPU.

- The block schedule is the JAX package's permutation, bitwise: a stable
  argsort of the same f32 uniforms (24-bit keys, so ties occur and the
  stable order matters; a case with ties is checked to have them).
- X within 1e-12 relative of the JAX package's in f64, 1e-5 in f32 (the
  two packages' GEMMs and LU solves round differently), the residual
  report within 10× that of ‖B‖ (a converged residual is rounding), and
  ``context.counter`` after the call equal.
- ``asy_fcg`` against the JAX package's, and its per-iteration counter
  window equal to the JAX package's uint32 ``it · per_iter`` also where
  the product wraps past 2^32.
- No entry point runs on the CPU by default: numpy input without a card
  raises unless the caller asks for the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.core.random import sample as jsample
from libskylark_tpu.solvers import asynch as jasynch
from libskylark_tpu.solvers import gauss_seidel as jgs
from libskylark_tpu_torch.solvers import asynch as tasynch
from libskylark_tpu_torch.solvers import gauss_seidel as tgs

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _spd(rng, n, k=1, dtype=np.float64):
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.eye(n)  # cond ~ 5
    B = rng.standard_normal((n, k)) if k > 1 else rng.standard_normal(n)
    return A.astype(dtype), B.astype(dtype)


def _rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def _jax_schedule(seed, base, sweeps, nblocks, offset):
    u = jsample("uniform", seed, base, sweeps * nblocks, dtype=jnp.float32, offset=offset)
    return np.asarray(jnp.argsort(u.reshape(sweeps, nblocks), axis=1)), np.asarray(u)


@pytest.mark.parametrize("n,bs", [(1, 64), (64, 64), (65, 64), (200, 16), (1000, 7), (5, 10)])
def test_gs_num_blocks_matches_jax(n, bs):
    assert tgs.gs_num_blocks(n, bs) == jgs.gs_num_blocks(n, bs)


@pytest.mark.parametrize("seed,base,sweeps,nblocks,offset", [
    (0, 0, 10, 16, 0),
    (5, 123, 3, 257, 7),
    (11, 2**32 - 40, 2, 64, 0),  # the window crosses 2^32
    (2, 9, 4, 8192, 2**32 - 1000),  # 32768 keys: ties in the 24-bit uniforms
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedule_is_the_jax_permutation_bitwise(seed, base, sweeps, nblocks, offset, as_tensor):
    off = torch.tensor(offset, dtype=torch.int64) if as_tensor else offset
    got = tgs.gs_schedule(seed, base, sweeps, nblocks, offset=off, device="cpu")
    ref, u = _jax_schedule(seed, base, sweeps, nblocks, offset)
    np.testing.assert_array_equal(got.numpy(), ref)
    if nblocks == 8192:
        assert any(len(np.unique(row)) < nblocks for row in u.reshape(sweeps, nblocks))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,k,bs,sweeps", [(128, 1, 16, 10), (150, 3, 32, 6), (40, 2, 64, 3)])
def test_gauss_seidel_matches_jax(rng, dtype, n, k, bs, sweeps):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    A, B = _spd(rng, n, k, npdt)
    cj, ct = J.SketchContext(seed=9, counter=17), T.SketchContext(seed=9, counter=17)
    Xj, ij = jgs.randomized_block_gauss_seidel(jnp.asarray(A), jnp.asarray(B), cj,
                                               block_size=bs, sweeps=sweeps)
    Xt, it = T.solvers.randomized_block_gauss_seidel(torch.from_numpy(A), torch.from_numpy(B),
                                                     ct, block_size=bs, sweeps=sweeps)
    assert Xt.dtype == dtype and tuple(Xt.shape) == B.shape
    assert _rel(Xt, Xj) <= TOL[dtype]
    # ‖B − A X‖ per column, to the same rounding as X (A's cond is ~5).
    np.testing.assert_allclose(it["resid"].numpy(), np.asarray(ij["resid"]), rtol=0,
                               atol=10 * TOL[dtype] * np.linalg.norm(B))
    assert int(it["sweeps"]) == int(ij["sweeps"]) == sweeps
    assert ct.counter == cj.counter == 17 + sweeps * jgs.gs_num_blocks(n, bs)


def test_gauss_seidel_converges_and_a_control_misses(rng):
    """Enough sweeps solve the system to rounding; zero sweeps (the
    control) leave X at 0."""
    A, B = _spd(rng, 96, 2)
    X, info = T.solvers.randomized_block_gauss_seidel(
        torch.from_numpy(A), torch.from_numpy(B), T.SketchContext(seed=1), block_size=16,
        sweeps=60)
    ref = np.linalg.solve(A, B)
    assert _rel(X, ref) <= 1e-10
    assert float(info["resid"].max()) <= 1e-9 * np.linalg.norm(B)
    X0, _ = T.solvers.randomized_block_gauss_seidel(
        torch.from_numpy(A), torch.from_numpy(B), T.SketchContext(seed=1), sweeps=0)
    assert _rel(X0, ref) == 1.0


def test_gauss_seidel_x0_and_offset_match_jax(rng):
    A, B = _spd(rng, 100, 2)
    x0 = rng.standard_normal((100, 2))
    for off in (3, torch.tensor(3, dtype=torch.int64)):
        cj, ct = J.SketchContext(seed=4), T.SketchContext(seed=4)
        Xj, _ = jgs.randomized_block_gauss_seidel(jnp.asarray(A), jnp.asarray(B), cj,
                                                  block_size=24, sweeps=3, x0=jnp.asarray(x0),
                                                  counter_offset=3)
        x0_t = torch.from_numpy(x0)
        Xt, _ = T.solvers.randomized_block_gauss_seidel(
            torch.from_numpy(A), torch.from_numpy(B), ct, block_size=24, sweeps=3, x0=x0_t,
            counter_offset=off)
        assert _rel(Xt, Xj) <= 1e-12
        np.testing.assert_array_equal(x0_t.numpy(), x0)  # the caller's x0 is not updated


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 3])
def test_asy_fcg_matches_jax(rng, dtype, k):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    A, B = _spd(rng, 160, k, npdt)
    params_j = J.solvers.KrylovParams(iter_lim=12, tolerance=1e-10)
    params_t = T.solvers.KrylovParams(iter_lim=12, tolerance=1e-10)
    cj, ct = J.SketchContext(seed=3), T.SketchContext(seed=3)
    Xj, ij = jasynch.asy_fcg(jnp.asarray(A), jnp.asarray(B), cj, params_j, inner_sweeps=2,
                             block_size=32)
    Xt, it = T.solvers.asy_fcg(torch.from_numpy(A), torch.from_numpy(B), ct, params_t,
                               inner_sweeps=2, block_size=32)
    assert _rel(Xt, Xj) <= 1e2 * TOL[dtype]
    assert int(it["iterations"]) == int(ij["iterations"])
    assert ct.counter == cj.counter == 12 * 2 * 5
    if dtype == torch.float64:
        assert _rel(Xt, np.linalg.solve(A, B)) <= 1e-9


@pytest.mark.parametrize("it", [0, 1, 7, 2**32 // 10 + 3, 2**31 + 5])
def test_counter_window_wraps_as_jax(rng, it):
    """Outer iteration ``it``'s window is JAX's uint32 ``it · per_iter``,
    wrapping mod 2^32, and the preconditioner it drives equals the JAX
    package's GS at that offset."""
    per_iter = 2 * 5  # inner_sweeps × nblocks at n = 160, block 32
    window = tasynch._window(torch.tensor(it, dtype=torch.int64), per_iter)
    ref = int(jnp.asarray(it, jnp.uint32) * jnp.uint32(per_iter))
    assert int(window) == ref < 2**32
    A, B = _spd(rng, 160, 2)
    Z = tasynch._gs_precond(torch.from_numpy(A), 3, 40, per_iter, 2, 32)(
        torch.from_numpy(B), torch.tensor(it, dtype=torch.int64))
    Zj, _ = jgs.randomized_block_gauss_seidel(
        jnp.asarray(A), jnp.asarray(B), J.SketchContext(seed=3, counter=40), block_size=32,
        sweeps=2, counter_offset=jnp.asarray(it, jnp.uint32) * jnp.uint32(per_iter))
    assert _rel(Z, Zj) <= 1e-12


def test_entry_points_run_on_the_card_by_default(rng):
    """Numpy input goes to the default device (the card): without one the
    call raises; ``device="cpu"`` runs on the CPU."""
    A, B = _spd(rng, 32, 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.solvers.randomized_block_gauss_seidel(A, B, T.SketchContext(seed=1))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.solvers.asy_fcg(A, B, T.SketchContext(seed=1))
    X, _ = T.solvers.randomized_block_gauss_seidel(A, B, T.SketchContext(seed=1), block_size=8,
                                                   device="cpu")
    assert X.device.type == "cpu"
    X, _ = T.solvers.asy_fcg(A, B, T.SketchContext(seed=1), block_size=8, device="cpu")
    assert X.device.type == "cpu"
