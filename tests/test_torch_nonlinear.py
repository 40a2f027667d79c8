"""Port vs JAX package: the nonlinear estimators (``ml/nonlinear.py``) and
the NURST sampler (``sketch/sampling.py``).

Same seeded numpy inputs in f64 (x64 is on) and the same
``SketchContext`` seeds to both packages.  Tolerances, relative to the
largest magnitude: RLS and SketchRLS coefficients and predictions
1e-10 (direct solves); NystromRLS and SketchPCR predictions 1e-8 (their
weights depend on eigenvector signs, their predictions do not, and the
landmark Gram's eigenvalues are floored at 1e-8); NURST's indices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.ml import nonlinear as jnl
from libskylark_tpu.sketch import sampling as jsamp
from libskylark_tpu_torch.ml import nonlinear as tnl
from libskylark_tpu_torch.sketch import sampling as tsamp

DIRECT = 1e-10
SPECTRAL = 1e-8


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")


def _rel(port, ref):
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


def _classes(rng, n=120, d=4, k=3):
    centers = rng.standard_normal((k, d)) * 3
    y = rng.integers(0, k, n) * 10 + 2  # labels 2, 12, 22
    X = centers[(y - 2) // 10] + rng.standard_normal((n, d))
    return X, y


def _pair(cls, sigma=2.0, d=4, kernel="GaussianKernel"):
    args = (d, sigma) if kernel == "GaussianKernel" else (d,)
    return (getattr(jnl, cls)(getattr(J.ml, kernel)(*args)),
            getattr(tnl, cls)(getattr(T.ml, kernel)(*args)))


def _check_predictions(jm, tm, Xt, tol):
    pj = jm.predict(jnp.asarray(Xt))
    pt = tm.predict(torch.from_numpy(Xt))
    if tm.multiclass:
        assert np.array_equal(pt.numpy(), np.asarray(pj))
    else:
        assert _rel(pt, pj) <= tol


@pytest.mark.parametrize("multiclass", [True, False])
def test_rls_matches_jax(rng, multiclass):
    X, y = _classes(rng)
    Y = y if multiclass else np.sin(X).sum(1)
    jm, tm = _pair("RLS")
    jm.train(jnp.asarray(X), Y, regularization=0.5, multiclass=multiclass)
    tm.train(torch.from_numpy(X), Y, regularization=0.5, multiclass=multiclass)
    assert _rel(tm.alpha, jm.alpha) <= DIRECT
    _check_predictions(jm, tm, rng.standard_normal((30, 4)) * 2, DIRECT)


@pytest.mark.parametrize("kernel,subtype", [
    ("GaussianKernel", "regular"), ("GaussianKernel", "fast"), ("LinearKernel", "sparse")])
def test_sketch_rls_matches_jax(rng, kernel, subtype):
    X, y = _classes(rng)
    jm, tm = _pair("SketchRLS", kernel=kernel)
    jm.train(jnp.asarray(X), y, J.SketchContext(seed=3), random_features=64,
             regularization=0.1, subtype=subtype)
    tm.train(torch.from_numpy(X), y, T.SketchContext(seed=3), random_features=64,
             regularization=0.1, subtype=subtype)
    assert _rel(tm.weights, jm.weights) <= DIRECT
    assert list(tm.classes) == list(jm.classes)
    Xt = rng.standard_normal((30, 4)) * 2
    assert _rel(tm.rft.apply(torch.from_numpy(Xt), "rowwise") @ tm.weights,
                jm.rft.apply(jnp.asarray(Xt), "rowwise") @ jm.weights) <= DIRECT
    _check_predictions(jm, tm, Xt, DIRECT)


@pytest.mark.parametrize("probdist", ["uniform", "leverages"])
def test_nystrom_rls_matches_jax(rng, probdist):
    X, y = _classes(rng)
    Yr = np.cos(X).sum(1)
    for multiclass, Y in ((True, y), (False, Yr)):
        jm, tm = _pair("NystromRLS")
        jm.train(jnp.asarray(X), Y, J.SketchContext(seed=5), random_features=24,
                 regularization=0.2, probdist=probdist, multiclass=multiclass)
        tm.train(torch.from_numpy(X), Y, T.SketchContext(seed=5), random_features=24,
                 regularization=0.2, probdist=probdist, multiclass=multiclass)
        assert torch.equal(tm.SX, torch.from_numpy(np.array(jm.SX)))  # the same landmarks
        Xt = rng.standard_normal((30, 4)) * 2
        Kt = T.ml.GaussianKernel(4, 2.0).gram(torch.from_numpy(Xt), tm.SX)
        Kj = J.ml.GaussianKernel(4, 2.0).gram(jnp.asarray(Xt), jm.SX)
        assert _rel(Kt @ tm.U @ tm.weights, Kj @ jm.U @ jm.weights) <= SPECTRAL
        _check_predictions(jm, tm, Xt, SPECTRAL)
    with pytest.raises(ValueError, match="probdist"):
        tm.train(torch.from_numpy(X), y, T.SketchContext(seed=5), probdist="other")


@pytest.mark.parametrize("multiclass", [True, False])
def test_sketch_pcr_matches_jax(rng, multiclass):
    X, y = _classes(rng, n=150)
    Y = y if multiclass else np.sin(X).sum(1)
    jm, tm = _pair("SketchPCR")
    jm.train(jnp.asarray(X), Y, J.SketchContext(seed=9), rank=12, multiclass=multiclass)
    tm.train(torch.from_numpy(X), Y, T.SketchContext(seed=9), rank=12, multiclass=multiclass)
    assert (tm.rank, tm.s, tm.t) == (jm.rank, jm.s, jm.t) == (12, 24, 48)
    # The weights are the projection onto the top-12 right subspace: sign-free.
    assert _rel(tm.weights, jm.weights) <= SPECTRAL
    _check_predictions(jm, tm, rng.standard_normal((30, 4)) * 2, SPECTRAL)
    with pytest.raises(ValueError, match="rank <= s <= t"):
        tm.train(torch.from_numpy(X), Y, T.SketchContext(seed=9), rank=30, s=20)


@pytest.mark.parametrize("n,s,weights", [
    (50, 20, "uniform"), (300, 64, "skewed"), (1000, 500, "sparse"), (7, 40, "skewed")])
def test_nurst_selects_the_same_rows(rng, n, s, weights):
    probs = {"uniform": np.ones(n), "skewed": rng.random(n) ** 4,
             "sparse": (rng.random(n) < 0.05) * rng.random(n) + 0.0}[weights]
    if not probs.any():
        probs[0] = 1.0
    jS = jsamp.NURST(n, s, J.SketchContext(seed=17, counter=5), probs)
    tS = tsamp.NURST(n, s, T.SketchContext(seed=17, counter=5), probs)
    idx = tS.samples("cpu")
    assert idx.dtype == torch.int32
    assert np.array_equal(idx.numpy(), np.asarray(jS.samples))
    assert (probs[idx.numpy()] > 0).all()  # no zero-probability row is drawn
    A = rng.standard_normal((n, 3))
    assert np.array_equal(tS.apply(torch.from_numpy(A)).numpy(),
                          np.asarray(jS.apply(jnp.asarray(A))))
    assert np.array_equal(tS.apply(torch.from_numpy(A.T), "rowwise").numpy(),
                          np.asarray(jS.apply(jnp.asarray(A.T), "rowwise")))
    # The JSON loads in either package's registry and selects the same
    # rows (loading renormalizes the probabilities, in both packages).
    assert np.array_equal(T.sketch.from_json(jS.to_json()).samples("cpu").numpy(), idx.numpy())
    assert np.array_equal(np.asarray(J.sketch.from_json(tS.to_json()).samples), idx.numpy())


def test_nurst_rejects_bad_probs():
    for probs, msg in ((np.ones(4), "shape"), (-np.ones(5), "nonnegative"),
                       (np.zeros(5), "positive")):
        with pytest.raises(ValueError, match=msg):
            tsamp.NURST(5, 3, T.SketchContext(seed=1), probs)


def test_exports_match_jax():
    assert set(tnl.__all__) == set(jnl.__all__)
    for name in ("RLS", "SketchRLS", "NystromRLS", "SketchPCR", "ADMMParams", "BlockADMMSolver"):
        assert hasattr(T.ml, name)
    assert T.sketch.NURST is tsamp.NURST
    assert set(T.ml.__all__) == set(J.ml.__all__) - {
        "DistributedBlockADMMTrainer", "prepare_rank_admm", "rank_chunked_solver",
        "stream_feature_blocks", "validate_train_partition"}
