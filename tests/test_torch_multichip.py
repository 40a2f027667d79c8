"""Port vs JAX package: the routes the JAX package leaves to GSPMD
(``libskylark_tpu_torch/parallel/routes.py``), on meshes of 1, 2, 4 and
8 CPU slots.

The JAX package hands a sharded ``jax.Array`` to its jitted code; the
port hands a ``Sharded`` to the same entry points, which run slot by
slot.  Each algorithm of ``tests/test_multichip.py`` and
``tests/test_linalg.py::test_sharded_matches_local`` is held to the JAX
package's local run at that test's tolerance (Blendenpik rtol 1e-7 /
atol 1e-9, KRR W rtol 1e-6 / atol 1e-8, SVD σ rtol 1e-8 and the
reconstruction rtol 1e-6, the 1-D mesh against ``lstsq`` at rtol 1e-6,
ADMM accuracy > 0.9 and W held to the port's unsharded trainer), and a
mesh of one is bitwise the port's unsharded call.  The JAX side runs
with ``SKYLARK_NO_SRHT_GEMM=1`` (the FJLT's WHT route, as the port),
``SKYLARK_POLICY=0`` and its plans off; this jax keeps
``trace_state_clean`` in ``jax._src.core``, which the fixture puts back
for the JAX KRR.  No sharded route may gather A: a wrapper around
``parallel.mesh.fully_replicated`` records every gathered shape.
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
from libskylark_tpu_torch.parallel import COLS, ROWS, mesh as tmesh, routes

SLOTS = [1, 2, 4, 8]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The bitwise pins run on one thread: on a loaded host MKL may run a
    GEMM on fewer threads than torch asks for, and its bits follow the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def _mesh(p):
    return T.parallel.default_mesh(p, device="cpu")


def _np(x):
    return T.parallel.fully_replicated(x).detach().cpu().numpy()


def _rel(got, want):
    got, want = np.asarray(_np(got) if not isinstance(got, np.ndarray) else got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


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


# -- sketches on a sharded input ---------------------------------------------------


@pytest.mark.parametrize("p", SLOTS)
@pytest.mark.parametrize("kind", ["JLT", "CWT", "SJLT", "FJLT"])
def test_columnwise_sketch_of_a_sharded_input(rng, kind, p, gathers):
    """Σ_k S[:, rows_k]·A_k merged by one psum: bitwise on one slot, f64
    rounding (1e-13 of the largest entry) on more, control: another
    seed's sketch misses."""
    A = torch.from_numpy(rng.standard_normal((2048, 6)))
    S = T.sketch.create_sketch(kind, 2048, 64, T.SketchContext(seed=3))
    want = S.apply(A, "columnwise")
    got = S.apply(T.parallel.shard(A, _mesh(p), (ROWS, COLS)), "columnwise")
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    if p == 1:
        assert torch.equal(got, want)
    assert _rel(got, want.numpy()) <= 1e-13
    other = T.sketch.create_sketch(kind, 2048, 64, T.SketchContext(seed=4)).apply(A)
    assert _rel(other, want.numpy()) > 1e-2
    assert (2048, 6) not in gathers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fjlt_kronecker_split_straddling_slots(rng, dtype):
    """N = 1020 (NB = 1024) on 6 slots: q = 4 blocks of 256, slots of 170
    rows straddle them; the f32 (bf16) sums agree with the unsharded
    apply within 4 u·√NB of the largest entry."""
    A = torch.from_numpy(rng.standard_normal((1020, 5))).to(dtype)
    S = T.sketch.FJLT(1020, 128, T.SketchContext(seed=9))
    want = S.apply(A, "columnwise").double().numpy()
    got = S.apply(T.parallel.shard_rows(A, T.parallel.make_mesh((6,), (ROWS,),
                                                                  devices="cpu")))
    u = torch.finfo(dtype).eps
    assert _rel(got.double(), want) <= 4 * u * 32


@pytest.mark.parametrize("p", SLOTS)
def test_rowwise_sketch_of_a_sharded_input_is_row_sharded(rng, p):
    """The dry run's ``FJLT.apply(A, "rowwise")``: each slot sketches its
    rows; the result is row-sharded and its rows are the unsharded
    apply's."""
    A = torch.from_numpy(rng.standard_normal((64, 512))).float()
    S = T.sketch.FJLT(512, 64, T.SketchContext(seed=25))
    got = S.apply(T.parallel.shard_rows(A, _mesh(p)), "rowwise")
    want = S.apply(A, "rowwise")
    if p == 1:
        assert torch.equal(got, want)
    else:
        assert isinstance(got, tmesh.Sharded) and got.shape == (64, 64)
        assert _rel(got, want.numpy()) <= 1e-6


def test_as_tensor_refuses_a_sharded_value():
    with pytest.raises(TypeError, match="fully_replicated"):
        T._device.as_tensor(T.parallel.shard_rows(torch.zeros(4, 2), _mesh(2)))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_linear_ops_of_a_sharded_a(rng, p, gathers):
    """``utils.linear_ops`` of a ``Sharded`` A gives its per-slot pair
    (``routes.linear_ops``): ``A·x`` in row order, ``Aᵀ·y`` psum'd; a mesh
    of one is the tensor's pair, bit for bit.  ``routes.operands`` lays
    a sharded b out on slot 0 and never gathers A."""
    A = torch.from_numpy(rng.standard_normal((64, 6)))
    x, y = torch.from_numpy(rng.standard_normal(6)), torch.from_numpy(rng.standard_normal(64))
    As = T.parallel.shard_rows(A, _mesh(p))
    matvec, rmatvec = T.utils.linear_ops(As)
    if p == 1:
        assert torch.equal(matvec(x), A @ x) and torch.equal(rmatvec(y), A.T @ y)
    np.testing.assert_allclose(matvec(x).numpy(), (A @ x).numpy(), rtol=1e-12)
    np.testing.assert_allclose(rmatvec(y).numpy(), (A.T @ y).numpy(), rtol=1e-12)
    Ao, b = routes.operands(As, T.parallel.shard_rows(y, _mesh(p)))
    assert torch.equal(b, y) and isinstance(Ao, tmesh.Sharded) == (p > 1)
    assert (64, 6) not in gathers


@pytest.mark.parametrize("sketch, options, refused", [
    ("JLT", {"device": "cpu"}, False),
    ("CWT", {"dense_output": True}, True),
])
def test_sharded_apply_takes_device_and_refuses_other_options(rng, sketch, options, refused):
    """``device=`` moves nothing for a sharded A (its slots lie where they
    lie, as a tensor's data does); an option the sharded route cannot
    honour raises instead of being dropped."""
    A = torch.from_numpy(rng.standard_normal((64, 5)))
    S = getattr(T.sketch, sketch)(64, 16, T.SketchContext(seed=3))
    As = T.parallel.shard_rows(A, _mesh(2))
    if refused:
        with pytest.raises(TypeError, match="dense_output"):
            S.apply(As, "columnwise", **options)
    else:
        assert torch.equal(S.apply(As, "columnwise", **options), S.apply(As, "columnwise"))


# -- the algorithms of tests/test_multichip.py ---------------------------------------


@pytest.mark.parametrize("p", SLOTS)
def test_blendenpik_sharded_matches_local(rng, p, gathers):
    A, b = rng.standard_normal((2048, 24)), rng.standard_normal(2048)
    x_jax, _ = J.linalg.faster_least_squares(jnp.asarray(A), jnp.asarray(b),
                                             J.SketchContext(seed=1))
    mesh = _mesh(p)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x, info = T.linalg.faster_least_squares(T.parallel.shard_rows(At, mesh),
                                            T.parallel.shard_rows(bt, mesh),
                                            T.SketchContext(seed=1))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax), rtol=1e-7, atol=1e-9)
    x_local, _ = T.linalg.faster_least_squares(At, bt, T.SketchContext(seed=1))
    if p == 1:
        assert torch.equal(x, x_local)
    assert (2048, 24) not in gathers


@pytest.mark.parametrize("p", SLOTS)
def test_krr_sharded_matches_local(rng, p, gathers):
    X = rng.standard_normal((512, 8))
    y = np.sin(X.sum(1))
    W_jax = J.ml.approximate_kernel_ridge(J.ml.GaussianKernel(8, 2.0), jnp.asarray(X),
                                          jnp.asarray(y), 0.05, 256,
                                          J.SketchContext(seed=2)).W
    mesh = _mesh(p)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    k = T.ml.GaussianKernel(8, 2.0)
    m = T.ml.approximate_kernel_ridge(k, T.parallel.shard_rows(Xt, mesh),
                                      T.parallel.shard_rows(yt, mesh), 0.05, 256,
                                      T.SketchContext(seed=2))
    np.testing.assert_allclose(m.W.numpy(), np.asarray(W_jax), rtol=1e-6, atol=1e-8)
    if p == 1:
        local = T.ml.approximate_kernel_ridge(k, Xt, yt, 0.05, 256, T.SketchContext(seed=2))
        assert torch.equal(m.W, local.W)
    assert (512, 8) not in gathers


def _blobs(rng, n=256, d=6):
    X = np.vstack([rng.standard_normal((n // 2, d)) - 1.5,
                   rng.standard_normal((n // 2, d)) + 1.5])
    y = np.array([0] * (n // 2) + [1] * (n // 2))
    perm = rng.permutation(n)
    return X[perm], y[perm]


def _admm_train(X, y, d=6):
    k = T.ml.GaussianKernel(d, 2.0)
    ctx = T.SketchContext(seed=3)
    maps = [k.create_rft(64, "regular", ctx) for _ in range(2)]
    solver = T.ml.BlockADMMSolver("hinge", "l2", maps,
                                  T.ml.ADMMParams(maxiter=20, lam=0.005, data_partitions=8))
    return solver.train(X, y)


@pytest.mark.parametrize("p", SLOTS)
def test_admm_with_sharded_partitions(rng, p, gathers):
    """X on the (ROWS, COLS) mesh, resharded to rows; the 8 partitions
    laid over the slots.  Accuracy > 0.9 as the JAX test asks, and W is
    the unsharded trainer's to f64 rounding (bitwise on one slot)."""
    X, y = _blobs(rng)
    Xt = torch.from_numpy(X)
    m = _admm_train(T.parallel.shard(Xt, _mesh(p), (ROWS, COLS)), y)
    pred = m.predict_labels(Xt, m.classes).numpy()
    assert (pred == y).mean() > 0.9
    local = _admm_train(Xt, y)
    if p == 1:
        assert torch.equal(m.W, local.W)
    np.testing.assert_allclose(m.W.numpy(), local.W.numpy(), rtol=0, atol=1e-10)
    assert m.history == pytest.approx(local.history, rel=1e-12)
    sharded_out = m.predict(T.parallel.shard_rows(Xt, _mesh(p)))
    np.testing.assert_allclose(_np(sharded_out), m.predict(Xt).numpy(), rtol=0, atol=1e-12)
    assert (256, 6) not in gathers


def test_admm_partitions_must_cover_the_slots(rng):
    X, y = _blobs(rng)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        k = T.ml.GaussianKernel(6, 2.0)
        maps = [k.create_rft(16, "regular", T.SketchContext(seed=3))]
        T.ml.BlockADMMSolver("hinge", "l2", maps, T.ml.ADMMParams(
            maxiter=1, data_partitions=2)).train(
            T.parallel.shard_rows(torch.from_numpy(X), _mesh(4)), y)


@pytest.mark.parametrize("p", SLOTS)
def test_1d_mesh_also_works(rng, p):
    A, b = rng.standard_normal((512, 16)), rng.standard_normal(512)
    mesh1 = T.parallel.make_mesh((p,), (ROWS,), devices="cpu")
    x, _ = T.linalg.faster_least_squares(T.parallel.shard(torch.from_numpy(A), mesh1, ROWS),
                                         torch.from_numpy(b), T.SketchContext(seed=4))
    x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-6, atol=1e-8)


def _low_rank(rng, m, n, k, noise):
    return (rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
            + noise * rng.standard_normal((m, n)))


@pytest.mark.parametrize("p", SLOTS)
@pytest.mark.parametrize("iters", [0, 2])
def test_sharded_matches_local(rng, p, iters, gathers):
    """``tests/test_linalg.py::test_sharded_matches_local`` (and with
    power iterations): σ at rtol 1e-8, U·diag(σ)·Vᵀ at rtol 1e-6; U comes
    back row-sharded."""
    A = _low_rank(rng, 128, 32, 4, noise=0.001)
    params = J.linalg.SVDParams(num_iterations=iters)
    U0, s0, V0 = J.linalg.approximate_svd(jnp.asarray(A), 4, J.SketchContext(seed=3), params)
    At = torch.from_numpy(A)
    tparams = T.linalg.SVDParams(num_iterations=iters)
    U1, s1, V1 = T.linalg.approximate_svd(T.parallel.shard_rows(At, _mesh(p)), 4,
                                          T.SketchContext(seed=3), tparams)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-8, atol=1e-10)
    rec0 = np.asarray(U0 @ jnp.diag(s0) @ V0.T)
    rec1 = (_np(U1) * s1.numpy()) @ V1.numpy().T
    np.testing.assert_allclose(rec1, rec0, rtol=1e-6, atol=1e-8)
    if p == 1:
        local = T.linalg.approximate_svd(At, 4, T.SketchContext(seed=3), tparams)
        assert all(torch.equal(a, b) for a, b in zip((U1, s1, V1), local))
    else:
        assert isinstance(U1, tmesh.Sharded) and U1.shape == (128, 4)
    assert (128, 32) not in gathers


# -- the solvers ------------------------------------------------------------------


SOLVERS = ["exact", "sketched", "accelerated", "lsrn", "refine", "auto"]


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_regression_sharded(rng, solver, p, gathers):
    """Every ``skylark_linear --solver`` on a row-sharded A:
    the JAX package's unsharded solution within 1e-8 of its largest
    entry (the port's unsharded parity is 1e-9; the sharded sums move it
    by f64 rounding)."""
    A, b = rng.standard_normal((1024, 12)), rng.standard_normal(1024)
    want = J.solvers.solve_regression(J.solvers.RegressionProblem(jnp.asarray(A)),
                                      jnp.asarray(b), solver, J.SketchContext(seed=5))
    got = T.solvers.solve_regression(
        T.solvers.RegressionProblem(T.parallel.shard_rows(torch.from_numpy(A), _mesh(p))),
        T.parallel.shard_rows(torch.from_numpy(b), _mesh(p)), solver,
        T.SketchContext(seed=5))
    xw = np.asarray(want[0] if isinstance(want, tuple) else want)
    xg = got[0] if isinstance(got, tuple) else got
    assert _rel(xg, xw) <= 1e-8
    assert (1024, 12) not in gathers


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("alg", ["qr", "sne", "ne", "svd"])
def test_exact_least_squares_sharded(rng, alg, p, gathers):
    """TSQR over the slots' R factors (qr, sne, svd) and the psum'd Gram
    (ne), against the JAX package's unsharded solve."""
    A, B = rng.standard_normal((512, 10)), rng.standard_normal((512, 3))
    want = J.linalg.exact_least_squares(jnp.asarray(A), jnp.asarray(B), alg=alg)
    got = T.linalg.exact_least_squares(
        T.parallel.shard(torch.from_numpy(A), _mesh(p), (ROWS, COLS)),
        torch.from_numpy(B), alg=alg)
    assert _rel(got, np.asarray(want)) <= 1e-12
    assert (512, 10) not in gathers


@pytest.mark.parametrize("route", ["sketch", "blendenpik", "lsrn", "exact"])
def test_approximate_least_squares_routes_on_a_2d_mesh(rng, route, gathers):
    """The dry run's call: A on the (ROWS, COLS) mesh, b on ROWS only (a
    different layout, gathered as the right-hand side)."""
    A, b = rng.standard_normal((256, 8)), rng.standard_normal(256)
    mesh = _mesh(8)
    params = T.linalg.LeastSquaresParams(sketch_type="CWT", sketch_size=32)
    got = T.linalg.approximate_least_squares(
        T.parallel.shard(torch.from_numpy(A), mesh, ROWS, COLS),
        T.parallel.shard(torch.from_numpy(b), mesh, ROWS), T.SketchContext(seed=4), params,
        route=route)
    want = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=4), params, route=route)
    assert _rel(got, want.numpy()) <= 1e-10
    assert (256, 8) not in gathers


@pytest.mark.parametrize("p", [1, 2, 4])
def test_refine_route_on_a_sharded_a(rng, p, gathers):
    """Refinement of a row-sharded A (f64 residual, f32 QR of the bf16
    sketch) converges to the f64 QR solve at 1e-9 as the unsharded
    route does; one slot is bitwise the unsharded call."""
    A, b = rng.standard_normal((1024, 16)), rng.standard_normal(1024)
    At, bt = torch.from_numpy(A).float(), torch.from_numpy(b)
    x_ref = np.linalg.lstsq(At.double().numpy(), b, rcond=None)[0]
    x, info = T.linalg.approximate_least_squares(
        T.parallel.shard_rows(At, _mesh(p)), T.parallel.shard_rows(bt, _mesh(p)),
        T.SketchContext(seed=1), route="refine", return_info=True)
    assert info["refine"]["converged"] and info["refine"]["rung"] == "bf16+f32"
    assert _rel(x, x_ref) <= 1e-9
    if p == 1:
        x0 = T.linalg.approximate_least_squares(At, bt, T.SketchContext(seed=1), route="refine")
        assert torch.equal(x, x0)
    assert (1024, 16) not in gathers


@pytest.mark.parametrize("what", ["ridge", "dct"])
def test_what_a_sharded_route_refuses_it_says(rng, what):
    """Ridge lays ``[A; √λ I]`` over equal row blocks, so m + n rows that
    do not divide over the slots raise, naming it (64 + 3 over 2); the
    DCT FJLT refuses nothing any more: with fewer columns than slots (one
    column on 4) it is the unsharded apply, bit for bit."""
    if what == "ridge":
        A = T.parallel.shard_rows(torch.from_numpy(rng.standard_normal((64, 3))), _mesh(2))
        with pytest.raises(ValueError, match="not divisible"):
            T.solvers.solve_regression(T.solvers.RegressionProblem(
                A, regularization="ridge", lam=0.5), torch.zeros(64, dtype=torch.float64),
                "exact")
    else:
        A = torch.from_numpy(rng.standard_normal((64, 1)))
        S = T.sketch.FJLT(64, 16, T.SketchContext(seed=1), fut="dct")
        assert torch.equal(S.apply(T.parallel.shard_rows(A, _mesh(4))), S.apply(A))


def test_cond_est_and_the_krylov_operator_take_a_sharded_a(rng):
    A = rng.standard_normal((512, 8)) * np.logspace(0, 2, 8)
    At = torch.from_numpy(A)
    As = T.parallel.shard_rows(At, _mesh(4))
    r0 = T.solvers.cond_est(At, T.SketchContext(seed=6))
    r1 = T.solvers.cond_est(As, T.SketchContext(seed=6))
    assert float(r1.sigma_max) == pytest.approx(float(r0.sigma_max), rel=1e-10)
    assert float(r1.cond) == pytest.approx(np.linalg.cond(A), rel=1e-2)
    b = torch.from_numpy(rng.standard_normal(512))
    x, _ = T.solvers.lsqr(As, b, params=T.solvers.KrylovParams(iter_lim=200))
    assert _rel(x, np.linalg.lstsq(A, b.numpy(), rcond=None)[0]) <= 1e-8


# -- kernel ridge -----------------------------------------------------------------


@pytest.mark.parametrize("p", SLOTS)
def test_large_scale_krr_sharded(rng, p, gathers):
    X, y = rng.standard_normal((256, 8)), rng.standard_normal(256)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    k = T.ml.GaussianKernel(8, sigma=2.0)
    params = T.ml.KrrParams(max_split=16, iter_lim=3)
    want = T.ml.large_scale_kernel_ridge(k, Xt, yt, 0.1, 48, T.SketchContext(seed=21), params)
    got = T.ml.large_scale_kernel_ridge(k, T.parallel.shard(Xt, _mesh(p), (ROWS, COLS)), yt,
                                        0.1, 48, T.SketchContext(seed=21), params)
    if p == 1:
        assert torch.equal(got.W, want.W)
    np.testing.assert_allclose(got.W.numpy(), want.W.numpy(), rtol=0, atol=1e-12)
    jw = J.ml.large_scale_kernel_ridge(J.ml.GaussianKernel(8, sigma=2.0), jnp.asarray(X),
                                       jnp.asarray(y), 0.1, 48, J.SketchContext(seed=21),
                                       J.ml.KrrParams(max_split=16, iter_lim=3)).W
    np.testing.assert_allclose(got.W.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-8)
    assert (256, 8) not in gathers


@pytest.mark.parametrize("p", SLOTS)
def test_streaming_krr_with_sharded_panels(rng, p, gathers):
    """The dry run's step: ``block_fn`` returns ``constrain_rows(panel,
    mesh)``; held to ``large_scale_kernel_ridge`` at rtol 1e-4 and, on
    one slot, bitwise the unsharded panels."""
    nk, dk, sk = 32 * 8, 8, 16
    X = torch.from_numpy(rng.standard_normal((nk, dk))).float()
    y = torch.from_numpy(rng.standard_normal(nk)).float()
    k = T.ml.GaussianKernel(dk, sigma=2.0)
    mesh1 = T.parallel.make_mesh((p,), (ROWS,), devices="cpu")
    params = T.ml.KrrParams(max_split=8, iter_lim=2)

    def run(block_fn):
        return T.ml.streaming_kernel_ridge(k, block_fn, (nk, dk), y, 0.1, sk,
                                           T.SketchContext(seed=31), params,
                                           block_rows=nk // 2, feature_dtype=torch.float32,
                                           block_args=(X,))

    got = run(lambda start, rows, X: T.parallel.constrain_rows(X[start:start + rows], mesh1))
    ref = T.ml.large_scale_kernel_ridge(k, X, y, 0.1, sk, T.SketchContext(seed=31), params)
    np.testing.assert_allclose(got.W.numpy(), ref.W.numpy(), rtol=1e-4, atol=1e-6)
    if p == 1:
        plain = run(lambda start, rows, X: X[start:start + rows])
        assert torch.equal(got.W, plain.W)
    assert (nk // 2, dk) not in gathers


@pytest.mark.parametrize("sharded", [False, True])
def test_streaming_krr_reads_every_panel_alike(rng, sharded):
    """Deciding whether to capture the passes reads no extra panel: each
    of the four panels is made as often as the others."""
    nk, dk = 4 * 32, 8
    X = torch.from_numpy(rng.standard_normal((nk, dk))).float()
    mesh1 = T.parallel.make_mesh((2,), (ROWS,), devices="cpu")
    starts = []

    def block_fn(start, rows):
        starts.append(start)
        panel = X[start:start + rows]
        return T.parallel.constrain_rows(panel, mesh1) if sharded else panel

    T.ml.streaming_kernel_ridge(T.ml.GaussianKernel(dk, sigma=2.0), block_fn, (nk, dk),
                                torch.ones(nk), 0.1, 16, T.SketchContext(seed=31),
                                T.ml.KrrParams(max_split=8, iter_lim=2), block_rows=32,
                                feature_dtype=torch.float32)
    counts = {s: starts.count(s) for s in set(starts)}
    assert sorted(counts) == [0, 32, 64, 96] and len(set(counts.values())) == 1, counts


# -- the dry run ------------------------------------------------------------------


@pytest.mark.parametrize("n", SLOTS)
def test_dryrun_multichip_runs_to_its_end(n, capsys):
    T.flagship.dryrun_multichip(n, device="cpu")
    assert f"({64 * n}x16 in" in capsys.readouterr().out


def test_mesh_reshard_never_gathers(rng, gathers):
    """(ROWS, COLS) → rows over both axes, a replica → rows, rows → a 1-D
    mesh: bitwise the fresh split, nothing gathered."""
    x = torch.from_numpy(rng.standard_normal((16, 8)))
    mesh = _mesh(8)
    mesh1 = T.parallel.make_mesh((8,), (ROWS,), devices="cpu")
    for src in (T.parallel.shard(x, mesh, ROWS, COLS), T.parallel.replicate(x, mesh),
                T.parallel.shard_cols(x, mesh)):
        for target, spec in ((mesh, ((ROWS, COLS),)), (mesh, (ROWS, COLS)), (mesh1, (ROWS,))):
            got = T.parallel.shard(src, target, *spec)
            want = T.parallel.shard(x, target, *spec)
            assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))
    assert not gathers


def test_mesh_of_one_is_the_unsharded_call_on_every_route(rng):
    """A 1 × 1 mesh hands each route its one tensor: the sketches, the
    solvers, the SVD, KRR, ADMM and predict are bitwise the unsharded
    calls."""
    one = _mesh(1)
    A, b = rng.standard_normal((256, 8)), rng.standard_normal(256)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    As, bs = T.parallel.shard_rows(At, one), T.parallel.shard_rows(bt, one)
    ctx = T.SketchContext
    for fn in (
        lambda a, b: T.sketch.FJLT(256, 32, ctx(seed=1)).apply(a),
        lambda a, b: T.sketch.CWT(256, 32, ctx(seed=1)).apply(a),
        lambda a, b: T.linalg.approximate_least_squares(a, b, ctx(seed=2)),
        lambda a, b: T.linalg.lsrn_least_squares(a, b, ctx(seed=2))[0],
        lambda a, b: T.linalg.exact_least_squares(a, b, alg="svd"),
        lambda a, b: T.linalg.approximate_svd(a, 3, ctx(seed=3))[1],
        lambda a, b: T.ml.approximate_kernel_ridge(T.ml.GaussianKernel(8, 2.0), a, b, 0.1, 32,
                                                   ctx(seed=4)).W,
    ):
        assert torch.equal(fn(As, bs), fn(At, bt))
