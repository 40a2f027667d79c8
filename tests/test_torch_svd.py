"""Port vs JAX package: the randomized SVD (``linalg/svd.py``).

Eigenvector signs, and the order of near-equal eigenvalues, differ
between JAX's LAPACK and torch's, so raw U and V are never compared.
The invariants are held at 1e-9 (relative to the largest singular
value, or absolute for orthonormal bases), on the same seeded numpy A
in f64: the singular values; U·diag(s)·Vᵀ; |diag(U_portᵀ·U_jax)| → 1 on
well-separated values; UᵀU = I.  The port's own bitwise properties:
chunked ≡ one-shot (chunks of 1 and 7), guarded ≡ unguarded on a
healthy input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from libskylark_tpu import plans as jplans
import libskylark_tpu.plans.plan as jplan
import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.linalg import svd as jsvd
from libskylark_tpu_torch.linalg import svd as tsvd

TOL = 1e-9


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("SKYLARK_GUARD", raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    # The JAX package's plans off (its plan path needs an API the installed
    # jax removed); the port keeps its default, planned path.
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)


def _lowrank(rng, m, n, decay=0.7, noise=1e-3):
    """Separated singular values decay^j plus a noise floor."""
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    s = np.maximum(decay ** np.arange(n), noise) * 10
    return U @ np.diag(s) @ V.T


def _orth_err(Q):
    Q = np.asarray(Q)
    return np.abs(Q.T @ Q - np.eye(Q.shape[1])).max()


def _assert_factors(t, j, k_sep):
    """(U, s, V) of the port against JAX's, by invariants."""
    Ut, st, Vt = (x.numpy() for x in t)
    Uj, sj, Vj = (np.asarray(x) for x in j)
    scale = sj[0]
    assert np.abs(st - sj).max() <= TOL * scale
    assert np.abs((Ut * st) @ Vt.T - (Uj * sj) @ Vj.T).max() <= TOL * scale
    assert np.abs(np.abs(np.sum(Ut[:, :k_sep] * Uj[:, :k_sep], 0)) - 1).max() <= TOL
    assert np.abs(np.abs(np.sum(Vt[:, :k_sep] * Vj[:, :k_sep], 0)) - 1).max() <= TOL
    assert _orth_err(Ut) <= TOL and _orth_err(Vt) <= TOL


@pytest.mark.parametrize("m,n,k,params", [
    (200, 40, 5, dict()),
    (300, 50, 8, dict(num_iterations=2)),
    (150, 30, 4, dict(num_iterations=1, oversampling_ratio=3, oversampling_additive=2)),
    (120, 24, 6, dict(num_iterations=2, skip_qr=True)),
    (60, 60, 10, dict(num_iterations=1)),
])
def test_approximate_svd_matches_jax(rng, m, n, k, params):
    A = _lowrank(rng, m, n)
    (t, it) = tsvd.approximate_svd(torch.from_numpy(A), k, T.SketchContext(seed=5),
                                   tsvd.SVDParams(**params), return_info=True)
    (j, ij) = jsvd.approximate_svd(jnp.asarray(A), k, J.SketchContext(seed=5),
                                   jsvd.SVDParams(**params), return_info=True)
    assert it == ij
    _assert_factors(t, j, k_sep=k)


def test_approximate_svd_sparse_matches_jax(rng):
    D = rng.standard_normal((300, 40)) * (rng.random((300, 40)) < 0.15)
    D[:, :3] *= np.array([30.0, 20.0, 12.0])  # separate the top three
    j = jsvd.approximate_svd(jsparse.BCOO.fromdense(jnp.asarray(D)), 3,
                             J.SketchContext(seed=2), jsvd.SVDParams(num_iterations=2))
    t = tsvd.approximate_svd(torch.from_numpy(D).to_sparse(), 3, T.SketchContext(seed=2),
                             tsvd.SVDParams(num_iterations=2))
    _assert_factors(t, j, k_sep=3)
    dense = tsvd.approximate_svd(torch.from_numpy(D), 3, T.SketchContext(seed=2),
                                 tsvd.SVDParams(num_iterations=2))
    _assert_factors(t, dense, k_sep=3)


def test_approximate_svd_exactly_low_rank_stays_finite(rng):
    """A rank-3 A: the sketch is rank-deficient, the eigenvalue floor of
    gram_orth keeps the factors finite."""
    A = rng.standard_normal((100, 3)) @ rng.standard_normal((3, 20))
    (t, info) = tsvd.approximate_svd(torch.from_numpy(A), 3, T.SketchContext(seed=1),
                                     return_info=True)
    j = jsvd.approximate_svd(jnp.asarray(A), 3, J.SketchContext(seed=1))
    assert all(bool(torch.isfinite(x).all()) for x in t)
    assert info["recovery"]["attempts"][0]["verdict"] == "OK"
    sj = np.asarray(j[1])
    assert np.abs(t[1].numpy() - sj).max() <= TOL * sj[0]


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_gram_orth_matches_jax(rng, passes):
    Y = rng.standard_normal((200, 12)) * np.logspace(0, -3, 12)
    Qt = tsvd.gram_orth(torch.from_numpy(Y), passes).numpy()
    Qj = np.asarray(jsvd.gram_orth(jnp.asarray(Y), passes))
    # Both span Y's columns; the bases differ by an orthogonal rotation
    # (eigh's sign and order), so compare the projectors.
    assert np.abs(Qt @ Qt.T - Qj @ Qj.T).max() <= TOL
    assert _orth_err(Qt) <= TOL


def test_gram_orth_rank_deficient_gives_zero_columns(rng):
    Y = rng.standard_normal((50, 2)) @ rng.standard_normal((2, 6))
    Q = tsvd.gram_orth(torch.from_numpy(Y))
    Qj = np.asarray(jsvd.gram_orth(jnp.asarray(Y)))
    assert bool(torch.isfinite(Q).all())
    norms = np.sort(torch.linalg.vector_norm(Q, dim=0).numpy())
    assert np.allclose(norms[-2:], 1.0, atol=TOL) and np.all(norms[:-2] <= TOL)
    assert np.abs(Q.numpy() @ Q.numpy().T - Qj @ Qj.T).max() <= TOL


@pytest.mark.parametrize("iters,ortho", [(0, True), (1, True), (3, True), (2, False)])
def test_power_iteration_matches_jax(rng, iters, ortho):
    A = _lowrank(rng, 80, 30)
    Q0 = rng.standard_normal((80, 5))
    Qt = tsvd.power_iteration(torch.from_numpy(A), torch.from_numpy(Q0), iters, ortho).numpy()
    Qj = np.asarray(jsvd.power_iteration(jnp.asarray(A), jnp.asarray(Q0), iters, ortho))
    if ortho and iters:
        assert np.abs(Qt @ Qt.T - Qj @ Qj.T).max() <= TOL
    else:
        assert np.abs(Qt - Qj).max() <= TOL * np.abs(Qj).max()


@pytest.mark.parametrize("iters", [0, 2])
def test_approximate_symmetric_svd_matches_jax(rng, iters):
    n = 60
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = 10 * 0.6 ** np.arange(n) * np.where(np.arange(n) % 3 == 1, -1, 1)
    A = (Q * lam) @ Q.T
    A = (A + A.T) / 2
    Vt, lt = tsvd.approximate_symmetric_svd(torch.from_numpy(A), 5, T.SketchContext(seed=4),
                                            tsvd.SVDParams(num_iterations=iters))
    Vj, lj = jsvd.approximate_symmetric_svd(jnp.asarray(A), 5, J.SketchContext(seed=4),
                                            jsvd.SVDParams(num_iterations=iters))
    Vt, lt, Vj, lj = Vt.numpy(), lt.numpy(), np.asarray(Vj), np.asarray(lj)
    assert np.abs(lt - lj).max() <= TOL * np.abs(lj).max()
    assert np.abs((Vt * lt) @ Vt.T - (Vj * lj) @ Vj.T).max() <= TOL * np.abs(lj).max()
    assert np.abs(np.abs(np.sum(Vt * Vj, 0)) - 1).max() <= TOL


def _hand(sol, chunk):
    st = sol.init_state()
    while not sol.is_done(st):
        st = sol.step_chunk(st, chunk)
    return sol.extract_result(st), sol.iteration(st)


@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("iters", [0, 3, 9])
def test_svd_chunked_is_bitwise_one_shot(rng, chunk, iters, monkeypatch):
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    A = torch.from_numpy(_lowrank(rng, 90, 20))
    p = tsvd.SVDParams(num_iterations=iters)
    sol = tsvd.approximate_svd_chunked(A, 4, T.SketchContext(seed=5), p)
    assert sol.kind == "approximate_svd"
    out, its = _hand(sol, chunk)
    assert its == iters
    one = tsvd.approximate_svd(A, 4, T.SketchContext(seed=5), p)
    assert all(torch.equal(a, b) for a, b in zip(out, one))


@pytest.mark.parametrize("iters", [0, 2])
def test_svd_guarded_is_bitwise_unguarded(rng, monkeypatch, iters):
    A = torch.from_numpy(_lowrank(rng, 80, 20))
    p = tsvd.SVDParams(num_iterations=iters)
    g, info = tsvd.approximate_svd(A, 4, T.SketchContext(seed=9), p, return_info=True)
    assert info["recovery"] == {"stage": "randomized_svd", "guarded": True, "recovered": False,
                                "attempts": [{"action": "initial", "verdict": "OK",
                                              "sketch_size": 8}]}
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    u, info0 = tsvd.approximate_svd(A, 4, T.SketchContext(seed=9), p, return_info=True)
    assert all(torch.equal(a, b) for a, b in zip(g, u))
    assert info0["recovery"] == {"stage": "randomized_svd", "guarded": False,
                                 "recovered": False, "attempts": []}


def test_svd_ladder_climbs_to_dense_fallback(rng, monkeypatch):
    """A certificate that fails on every sketch (a tolerance no factor
    meets) climbs resketch → grow → fallback, as in the JAX package."""
    from libskylark_tpu import guard as jg
    from libskylark_tpu_torch import guard as tg

    A = _lowrank(rng, 70, 16)
    strict_t, strict_j = tg.certify_svd, jg.certify_svd
    monkeypatch.setattr(tg, "certify_svd", lambda *a, **k: strict_t(*a, rtol=-1.0))
    monkeypatch.setattr(jg, "certify_svd", lambda *a, **k: strict_j(*a, rtol=-1.0))
    t, it = tsvd.approximate_svd(torch.from_numpy(A), 3, T.SketchContext(seed=8),
                                 return_info=True)
    j, ij = jsvd.approximate_svd(jnp.asarray(A), 3, J.SketchContext(seed=8), return_info=True)
    strip = lambda rec: [(a["action"], a["verdict"], a.get("sketch_size"))
                         for a in rec["attempts"]]
    assert strip(it["recovery"]) == strip(ij["recovery"])
    assert [a["action"] for a in it["recovery"]["attempts"]] == [
        "initial", "resketch", "grow", "fallback"]
    assert it["recovery"]["recovered"] is True
    _assert_factors(t, j, k_sep=3)
    s_exact = np.linalg.svd(A, compute_uv=False)[:3]
    assert np.abs(t[1].numpy() - s_exact).max() <= TOL * s_exact[0]


def test_svd_rank_validation_and_sizes(rng):
    A = torch.from_numpy(rng.standard_normal((10, 6)))
    with pytest.raises(ValueError, match="exceeds"):
        tsvd.approximate_svd(A, 7, T.SketchContext())
    assert tsvd._sketch_size(4, tsvd.SVDParams(), 6) == jsvd._sketch_size(
        4, jsvd.SVDParams(), 6) == (4, 6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("noise,decay", [(0.0, 1.0), (0.01, 0.8)])
def test_synthetic_lowrank_blocks_match_jax(dtype, noise, decay):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    cj, ct = J.SketchContext(seed=13), T.SketchContext(seed=13)
    fj = jsvd.synthetic_lowrank_blocks(cj, 64, 12, 3, noise=noise, dtype=dtype, decay=decay)
    ft = tsvd.synthetic_lowrank_blocks(ct, 64, 12, 3, noise=noise, dtype=tdt, decay=decay,
                                       device="cpu")
    assert ct.counter == cj.counter
    full = ft(0, 64)
    ref = np.asarray(fj(0, 64))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(full.numpy() - ref).max() <= tol * np.abs(ref).max()
    # Any panel is bitwise the same rows of the whole.
    assert torch.equal(ft(16, 24), full[16:40])


def test_streaming_svd_is_deferred():
    # Ported with its sharded panels (tests/test_torch_sharded_paths.py):
    # an explicit mesh is refused before any panel is asked for, as in the
    # JAX package.
    explicit = T.parallel.make_mesh((1,), (T.parallel.ROWS,), explicit=True, devices="cpu")
    with pytest.raises(ValueError, match="Auto-axes mesh"):
        T.linalg.streaming_approximate_svd(None, (4, 4), 1, T.SketchContext(), mesh=explicit)
