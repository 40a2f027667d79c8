"""Port vs JAX package: the BlockADMM kernel-machine trainer
(``ml/admm.py``) and its phase timers (``utils/timer.py``).

Same seeded numpy inputs in f64 (x64 is on) and the same feature maps
(one ``SketchContext`` seed each side) to both packages.  Tolerances,
relative to the largest magnitude: W and the objective trace after 5
iterations within 1e-9 for the squared, LAD and hinge losses, 1e-6 for
the logistic loss (its prox is a damped Newton loop, solved to 2ε = 2e-4
in the Newton decrement).  The port's own properties: ``chunked`` in
chunks of any size is bitwise ``train``; its feature blocks (one rowwise
apply reshaped to (P, n/P, s)) equal the per-partition columnwise
applies; P = 1 and P = 4 both train well (the JAX package's invariance
test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.ml import admm as jadmm
from libskylark_tpu_torch.ml import admm as tadmm

TOL = 1e-9
LOGISTIC_TOL = 1e-6


def _rel(port, ref):
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def _blobs(rng, n_per, d, k=2, sep=3.0):
    X = np.vstack([rng.standard_normal((n_per, d)) + sep * c * np.eye(d)[c % d]
                   for c in range(k)])
    y = np.repeat(np.arange(k) * 2 + 1, n_per)  # labels 1, 3, 5, ...
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def _maps(pkg, d, blocks, s, seed=11, sigma=2.0, tag="regular"):
    ctx = pkg.SketchContext(seed=seed)
    k = pkg.ml.GaussianKernel(d, sigma)
    return [k.create_rft(s, tag, ctx) for _ in range(blocks)]


def _train_both(X, y, loss, reg, blocks=2, s=32, tag="regular", regression=False,
                **params):
    d = X.shape[1]
    kw = dict(rho=1.0, lam=0.01, maxiter=5, **params)
    jm = jadmm.BlockADMMSolver(loss, reg, _maps(J, d, blocks, s, tag=tag),
                               jadmm.ADMMParams(**kw)).train(X, y, regression=regression)
    tm = tadmm.BlockADMMSolver(loss, reg, _maps(T, d, blocks, s, tag=tag),
                               tadmm.ADMMParams(**kw)).train(
        torch.from_numpy(X), torch.from_numpy(y) if regression else y, regression=regression)
    return jm, tm


@pytest.mark.parametrize("loss,reg,k,P", [
    ("hinge", "l2", 2, 1),
    ("hinge", "l1", 3, 2),
    ("squared", "l2", 3, 4),
    ("squared", "none", 2, 2),
    ("lad", "l1", 2, 1),
    ("logistic", "l2", 3, 2),
    ("logistic", "none", 2, 1),
])
def test_train_matches_jax(rng, loss, reg, k, P):
    X, y = _blobs(rng, 24, 4, k=k)
    jm, tm = _train_both(X, y, loss, reg, data_partitions=P)
    tol = LOGISTIC_TOL if loss == "logistic" else TOL
    assert _rel(tm.W, jm.W) <= tol
    assert _rel(np.asarray(tm.history), np.asarray(jm.history)) <= tol
    assert list(tm.classes) == list(np.asarray(jm.classes).tolist())
    assert tm.W.dtype == torch.float64 and len(tm.history) == 5


def test_train_fastfood_three_blocks_and_scaled_maps(rng):
    X, y = _blobs(rng, 20, 6, k=2)
    jm, tm = _train_both(X, y, "hinge", "l2", blocks=3, s=24, tag="fast", scale_maps=True,
                         data_partitions=2)
    assert _rel(tm.W, jm.W) <= TOL
    assert _rel(np.asarray(tm.history), np.asarray(jm.history)) <= TOL
    assert tm.scale_maps and tm.to_dict()["scale_maps"]


def test_regression_multitarget_matches_jax(rng):
    X = rng.standard_normal((48, 3))
    Y = X @ rng.standard_normal((3, 2))
    jm, tm = _train_both(X, Y, "squared", "l2", regression=True, data_partitions=3)
    assert _rel(tm.W, jm.W) <= TOL
    assert _rel(np.asarray(tm.history), np.asarray(jm.history)) <= TOL
    assert tm.classes is None


def test_validation_history_matches_jax(rng):
    X, y = _blobs(rng, 24, 4, k=2)
    kw = dict(rho=1.0, lam=0.005, maxiter=5)
    jm = jadmm.BlockADMMSolver("hinge", "l2", _maps(J, 4, 2, 32), jadmm.ADMMParams(**kw)).train(
        X, y, Xv=X[:16], Yv=y[:16])
    tm = tadmm.BlockADMMSolver("hinge", "l2", _maps(T, 4, 2, 32), tadmm.ADMMParams(**kw)).train(
        torch.from_numpy(X), y, Xv=torch.from_numpy(X[:16]), Yv=y[:16])
    assert _rel(tm.W, jm.W) <= TOL
    assert _rel(np.asarray(tm.history), np.asarray(jm.history)) <= TOL
    np.testing.assert_allclose(tm.val_history, jm.val_history, rtol=1e-6)
    assert set(tm.timers.counts) == {"transform", "factor", "iteration", "prediction"}
    assert tm.timers.counts["iteration"] == 5
    # The stepwise (validated) run is bitwise the run without validation.
    plain = tadmm.BlockADMMSolver("hinge", "l2", _maps(T, 4, 2, 32),
                                  tadmm.ADMMParams(**kw)).train(torch.from_numpy(X), y)
    assert torch.equal(plain.W, tm.W) and plain.history == tm.history


@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_chunked_is_bitwise_train(rng, loss):
    X, y = _blobs(rng, 18, 4, k=3)
    kw = dict(rho=1.0, lam=0.01, maxiter=7, data_partitions=3)
    solver = tadmm.BlockADMMSolver(loss, "l2", _maps(T, 4, 2, 32), tadmm.ADMMParams(**kw))
    ref = solver.train(torch.from_numpy(X), y)
    for chunk in (1, 3, 100):
        sol = solver.chunked(torch.from_numpy(X), y)
        assert sol.kind == "block_admm"
        st = sol.init_state()
        while not sol.is_done(st):
            st = sol.step_chunk(st, chunk)
        assert sol.iteration(st) == 7
        m = sol.extract_result(st)
        assert torch.equal(m.W, ref.W) and m.history == ref.history


def test_feature_blocks_equal_per_partition_applies(rng):
    """One rowwise apply reshaped to (P, n/P, s) is the partitions'
    columnwise applies, transposed (the JAX package's vmapped layout)."""
    X = torch.from_numpy(rng.standard_normal((30, 5)))
    for tag in ("regular", "fast"):
        S = _maps(T, 5, 1, 40, tag=tag)[0]
        solver = tadmm.BlockADMMSolver("hinge", "l2", [S])
        Z = solver._apply_map(S, X, 3)
        for p in range(3):
            part = S.apply(X[10 * p:10 * (p + 1)].T, "columnwise").T
            assert _rel(Z[p], part) <= 1e-12


def test_data_partitions_both_train_well(rng):
    X, y = _blobs(rng, 32, 3, k=2)
    for P in (1, 4):
        solver = tadmm.BlockADMMSolver(
            "squared", "l2", _maps(T, 3, 1, 64, seed=5),
            tadmm.ADMMParams(rho=1.0, lam=0.01, maxiter=25, data_partitions=P))
        m = solver.train(torch.from_numpy(X), y)
        assert (m.predict_labels(torch.from_numpy(X)).numpy() == y).mean() > 0.9, f"P={P}"
        assert m.history[-1] <= m.history[0]
    with pytest.raises(ValueError, match="not divisible"):
        tadmm.BlockADMMSolver("squared", "l2", _maps(T, 3, 1, 8),
                              tadmm.ADMMParams(data_partitions=5)).train(torch.from_numpy(X), y)


def test_admm_model_loads_in_jax(rng, tmp_path):
    X, y = _blobs(rng, 16, 4, k=2)
    tm = tadmm.BlockADMMSolver("hinge", "l2", _maps(T, 4, 2, 32, tag="fast"),
                               tadmm.ADMMParams(maxiter=4, scale_maps=True)).train(
        torch.from_numpy(X), y)
    path = str(tmp_path / "admm.json")
    tm.save(path)
    jm = J.ml.load_model(path)
    assert np.array_equal(np.asarray(jm.W), tm.W.numpy())
    assert _rel(tm.predict(torch.from_numpy(X)), jm.predict(jnp.asarray(X))) <= TOL
    assert np.array_equal(np.asarray(jm.predict_labels(jnp.asarray(X))),
                          tm.predict_labels(torch.from_numpy(X)).numpy())


def test_phase_timer():
    t = T.utils.PhaseTimer()
    for _ in range(2):
        with t.phase("a") as ph:
            ph.result = [torch.ones(3), {"x": torch.zeros(2)}]
    assert t.counts["a"] == 2 and t.totals["a"] >= 0.0
    assert t.report().splitlines()[1].startswith("a")
    # Without a process group the distributed report is the table over
    # one process (tests/test_torch_distributed_world.py holds worlds).
    rep = t.report(distributed=True)
    assert "over 1 process)" in rep and rep.splitlines()[1].startswith("a")
    stacked = np.array([[1.0, 2.0], [3.0, 4.0]])
    assert T.utils.aggregate_report(["p", "q"], stacked) == \
        J.utils.timer.aggregate_report(["p", "q"], stacked)
