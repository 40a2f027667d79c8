"""Port vs JAX package: the kernels' Gram matrices and feature-map
factories (``ml/kernels.py``), the distance matrices, label coding and
metrics.

Inputs come from numpy; each function of the JAX package and its port
get the same arrays.  Tolerances: f64 results 1e-10 of the largest
magnitude, f32 results 1e-5 of it (summation order only: the squared
distance's ‖x‖² + ‖y‖² − 2·x·y runs in full f32 on both sides).  Labels
and codings are exact; the port's accuracy is the exact percentage, the
JAX package's an f32 mean within 1e-4 of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.ml import kernels as jkernels
from libskylark_tpu_torch.ml import kernels as tkernels

RTOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]
KERNELS = [
    ("linear", {}),
    ("gaussian", {"sigma": 1.7}),
    ("polynomial", {"q": 3, "c": 0.5, "gamma": 0.8}),
    ("polynomial", {"q": 2}),
    ("laplacian", {"sigma": 2.5}),
    ("expsemigroup", {"beta": 0.4}),
    ("matern", {"nu": 0.5, "l": 1.3}),
    ("matern", {"nu": 1.5, "l": 0.9}),
    ("matern", {"nu": 2.5, "l": 2.0}),
]


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300))


def _data(rng, shape, dtype):
    return np.abs(rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("name,params", KERNELS, ids=lambda v: str(v))
def test_gram_matches_jax(rng, name, params, same, dtype):
    d = 12
    Kj = jkernels.kernel_by_name(name, d, **params)
    Kt = tkernels.from_dict(Kj.to_dict())
    X = _data(rng, (15, d), dtype)
    Y = None if same else _data(rng, (11, d), dtype)
    ref = np.asarray(Kj.gram(jnp.asarray(X), None if same else jnp.asarray(Y)))
    out = Kt.gram(torch.from_numpy(X), None if same else torch.from_numpy(Y)).numpy()
    assert out.dtype == X.dtype
    if same and name == "matern" and params["nu"] == 0.5:
        # exp(−r/ℓ) has a kink at r = 0: the diagonal's r is the square
        # root of a cancellation residue of ~eps·‖x‖² (different in each
        # package), so it is held at √eps·‖x‖/ℓ and the rest as usual.
        diag = np.abs(np.diag(out) - np.diag(ref)).max()
        assert diag <= 4 * np.sqrt(np.finfo(dtype).eps) * np.linalg.norm(X, axis=1).max() / params["l"]
        off = ~np.eye(len(X), dtype=bool)
        out, ref = out[off], ref[off]
    assert _rel(out, ref) <= RTOL[dtype]


@pytest.mark.parametrize("name,params", KERNELS, ids=lambda v: str(v))
def test_kernel_dict_identical(name, params):
    Kj = jkernels.kernel_by_name(name, 9, **params)
    Kt = tkernels.kernel_by_name(name, 9, **params)
    assert Kt.to_dict() == Kj.to_dict()
    assert Kt.to_json() == Kj.to_json()
    assert tkernels.from_dict(Kj.to_dict()).to_dict() == Kj.to_dict()
    assert repr(Kt) == repr(Kj)


@pytest.mark.parametrize("name,params,tag", [
    ("linear", {}, "regular"), ("linear", {}, "fast"), ("linear", {}, "sparse"),
    ("gaussian", {"sigma": 2.0}, "regular"), ("gaussian", {"sigma": 2.0}, "fast"),
    ("polynomial", {"q": 2}, "regular"), ("polynomial", {"q": 2}, "fast"),
    ("laplacian", {"sigma": 1.0}, "regular"),
    ("expsemigroup", {"beta": 0.2}, "regular"),
    ("matern", {"nu": 1.5}, "regular"), ("matern", {"nu": 1.5}, "fast"),
])
def test_create_rft_same_sketch(name, params, tag):
    """Each tag builds the JAX package's sketch: same type, same JSON."""
    Kj = jkernels.kernel_by_name(name, 20, **params)
    Kt = tkernels.kernel_by_name(name, 20, **params)
    Sj = Kj.create_rft(64, tag, J.SketchContext(seed=7))
    St = Kt.create_rft(64, tag, T.SketchContext(seed=7))
    assert St.sketch_type == Sj.sketch_type
    assert St.to_dict() == Sj.to_dict()


@pytest.mark.parametrize("name,params,stype", [
    ("gaussian", {"sigma": 1.0}, "GaussianQRFT"), ("laplacian", {"sigma": 1.0}, "LaplacianQRFT"),
    ("expsemigroup", {"beta": 1.0}, "ExpSemigroupQRLT"),
])
def test_quasi_tag_matches_jax(rng, name, params, stype):
    """The "quasi" tag builds the JAX package's QMC map: same type, same
    JSON, features within 1e-10 in f64 (absolute: the Laplacian's Cauchy
    rows make cosine arguments of ~10^3, where an f64 ulp is ~1e-13)."""
    Sj = jkernels.kernel_by_name(name, 8, **params).create_rft(16, "quasi", J.SketchContext(seed=1))
    St = tkernels.kernel_by_name(name, 8, **params).create_rft(16, "quasi", T.SketchContext(seed=1))
    assert St.sketch_type == Sj.sketch_type == stype
    assert St.to_dict() == Sj.to_dict()
    X = np.abs(rng.standard_normal((5, 8)))
    out = St.apply(torch.from_numpy(X), "rowwise").numpy()
    assert np.abs(out - np.asarray(Sj.apply(jnp.asarray(X), "rowwise"))).max() <= 1e-10


@pytest.mark.parametrize("name,params,tag", [
    ("linear", {}, "quasi"), ("polynomial", {}, "sparse"), ("laplacian", {"sigma": 1.0}, "fast"),
    ("matern", {"nu": 0.5}, "sparse"), ("gaussian", {"sigma": 1.0}, "nope"),
])
def test_unknown_tags_raise(name, params, tag):
    with pytest.raises(ValueError):
        tkernels.kernel_by_name(name, 8, **params).create_rft(16, tag, T.SketchContext(seed=1))


def test_kernel_factory_errors():
    with pytest.raises(ValueError):
        tkernels.kernel_by_name("rbf", 3)
    with pytest.raises(ValueError):
        tkernels.MaternKernel(3, nu=1.0)


@pytest.mark.parametrize("name,params", [("laplacian", {"sigma": 1.5}),
                                         ("expsemigroup", {"beta": 0.3})])
def test_blocked_pairwise_rows_match_jax(rng, monkeypatch, name, params):
    """Above _PAIRWISE_LIMIT both packages cut X into row blocks (patched
    small on both sides: blocks of 2 rows, a ragged last one)."""
    X, Y = _data(rng, (9, 6), np.float64), _data(rng, (5, 6), np.float64)
    Kt = tkernels.kernel_by_name(name, 6, **params)
    whole = Kt.gram(torch.from_numpy(X), torch.from_numpy(Y))
    monkeypatch.setattr(jkernels, "_PAIRWISE_LIMIT", 60)
    monkeypatch.setattr(tkernels, "_PAIRWISE_LIMIT", 60)
    ref = jkernels.kernel_by_name(name, 6, **params).gram(jnp.asarray(X), jnp.asarray(Y))
    out = Kt.gram(torch.from_numpy(X), torch.from_numpy(Y))
    assert _rel(out.numpy(), ref) <= RTOL[np.float64]
    assert torch.equal(out, whole)


def test_sparse_and_mixed_dtype_gram(rng):
    """A sparse COO X is densified; f32 against f64 promotes to f64.  The
    port promotes the operands first; the JAX package sums the f32
    operand's squared norms in f32 before promoting, so it is held
    against JAX's gram of the promoted operands."""
    X = _data(rng, (6, 5), np.float64)
    X[X < 0.7] = 0.0
    r, c = np.nonzero(X)
    coo = T.utils.coo_from_bcoo_arrays(X[r, c], np.stack([r, c], 1), X.shape, device="cpu")
    K = tkernels.GaussianKernel(5, 1.0)
    assert torch.equal(K.gram(coo), K.gram(torch.from_numpy(X)))
    Y = _data(rng, (4, 5), np.float32)
    ref = jkernels.GaussianKernel(5, 1.0).gram(jnp.asarray(X), jnp.asarray(Y, np.float64))
    out = K.gram(torch.from_numpy(X), torch.from_numpy(Y))
    assert out.dtype == torch.float64
    assert _rel(out.numpy(), ref) <= RTOL[np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["euclidean_distance_matrix", "l1_distance_matrix",
                                "expsemigroup_distance_matrix"])
def test_distances_match_jax(rng, fn, dtype):
    X, Y = _data(rng, (10, 7), dtype), _data(rng, (8, 7), dtype)
    C = rng.standard_normal((10, 8)).astype(dtype)
    jfn, tfn = getattr(J.ml, fn), getattr(T.ml, fn)
    for args, kw in (((X, Y), {}), ((X,), {"alpha": 0.5}),
                     ((X, Y), {"alpha": 2.0, "beta": -0.5, "C": C})):
        ref = jfn(*map(jnp.asarray, args), **{k: jnp.asarray(v) if k == "C" else v
                                              for k, v in kw.items()})
        out = tfn(*map(torch.from_numpy, args), **{k: torch.from_numpy(v) if k == "C" else v
                                                   for k, v in kw.items()})
        assert _rel(out.numpy(), ref) <= RTOL[dtype]
    with pytest.raises(ValueError, match="beta"):
        tfn(torch.from_numpy(X), beta=1.0)


def test_dummy_coding_and_decode_match_jax():
    y = np.array([3, 1, 3, 7, 1, 1])
    Tj, cj = J.ml.dummy_coding(y)
    Tt, ct = T.ml.dummy_coding(y, device="cpu")
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))
    assert Tt.dtype == torch.get_default_dtype()
    Tt2, ct2 = T.ml.dummy_coding(y, classes=[7, 1, 3, 9], dtype=torch.float64, device="cpu")
    Tj2, cj2 = J.ml.dummy_coding(y, classes=[7, 1, 3, 9])
    np.testing.assert_array_equal(ct2, cj2)
    np.testing.assert_array_equal(Tt2.numpy(), np.asarray(Tj2))
    with pytest.raises(ValueError, match="not in classes"):
        T.ml.dummy_coding(y, classes=[1, 3], device="cpu")
    # Ties decode to the first maximum in both packages.
    O = np.array([[0.1, 0.9, 0.9], [2.0, -1.0, 2.0], [-3.0, -2.0, -1.0]])
    np.testing.assert_array_equal(T.ml.decode_labels(torch.from_numpy(O), [10, 20, 30]).numpy(),
                                  np.asarray(J.ml.decode_labels(O, [10, 20, 30])))


def test_metrics_match_jax(rng):
    p = rng.integers(0, 4, 50)
    t = rng.integers(0, 4, 50)
    acc = T.ml.classification_accuracy(torch.from_numpy(p), torch.from_numpy(t))
    # The port counts exactly in f64; the JAX package takes an f32 mean.
    assert float(acc) == 100.0 * np.sum(p == t) / p.size
    assert abs(float(acc) - float(J.ml.classification_accuracy(p, t))) <= 1e-4
    a, b = rng.standard_normal((6, 3)), rng.standard_normal((6, 3))
    mse = T.ml.mean_squared_error(torch.from_numpy(a), torch.from_numpy(b))
    assert abs(float(mse) - float(J.ml.mean_squared_error(a, b))) <= 1e-14
    with pytest.raises(ValueError, match="shape mismatch"):
        T.ml.classification_accuracy(torch.from_numpy(p), torch.from_numpy(t[:-1]))
