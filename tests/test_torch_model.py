"""Model interchange between the JAX package and the port: a model saved
by either loads in the other and predicts the same, and the flagship
forward step agrees with the JAX package's ``__graft_entry__.entry``.

Predictions are held at 1e-5 of their largest magnitude (the feature
maps' own f32 agreement, tests/test_torch_rft.py, carried through one
product with W).  The Laplacian map is held in f64 only: its Cauchy W
makes f32 features differ by more between any two correct summation
orders.  Both packages run FJLT by the WHT-and-gather route
(``SKYLARK_NO_SRHT_GEMM=1``; tests/test_torch_sketch.py).  Saved JSON
is identical after ``json.loads``; bf16 coefficients round-trip bit for
bit, without ``ml_dtypes``.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
D = 24
MAPS = [
    ("GaussianRFT", {"sigma": 1.5}),
    ("LaplacianRFT", {"sigma": 2.0}),
    ("MaternRFT", {"nu": 1.5, "l": 1.2}),
    ("FastGaussianRFT", {"sigma": 1.3}),
    ("FastMaternRFT", {"nu": 2.5, "l": 0.8}),
    ("ExpSemigroupRLT", {"beta": 0.5}),
    ("PPT", {"q": 3, "c": 1.0, "gamma": 0.5}),
    ("JLT", {}),
    ("CT", {"C": 2.0}),
    ("FJLT", {}),
    ("CWT", {}),
]
KERNELS = [
    ("linear", {}),
    ("gaussian", {"sigma": 1.7}),
    ("polynomial", {"q": 3, "c": 0.5, "gamma": 0.8}),
    ("laplacian", {"sigma": 2.5}),
    ("expsemigroup", {"beta": 0.4}),
    ("matern", {"nu": 1.5, "l": 0.9}),
]


@pytest.fixture(autouse=True)
def no_srht_gemm(monkeypatch):
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300))


def _data(rng, shape, dtype):
    """Non-negative (the RLT needs histograms), O(1)-norm rows."""
    return (np.abs(rng.standard_normal(shape)) / np.sqrt(shape[-1])).astype(dtype)


def _jax_model(maps, k, dtype, scale_maps, rng, classes=None):
    jmaps = [J.sketch.create_sketch(t, D, s, J.SketchContext(seed=31 + i), **p)
             for i, (t, p, s) in enumerate(maps)]
    width = sum(s for _, _, s in maps)
    W = rng.standard_normal((width, k)).astype(dtype)
    return J.ml.FeatureMapModel(jmaps, jnp.asarray(W), scale_maps=scale_maps, classes=classes)


def _dtypes(stype):
    return [np.float64] if stype == "LaplacianRFT" else [np.float32, np.float64]


FM_CASES = [(t, p, dt) for t, p in MAPS for dt in _dtypes(t)]


@pytest.mark.parametrize("scale_maps", [False, True])
@pytest.mark.parametrize("stype,params,dtype", FM_CASES, ids=lambda v: str(v))
def test_feature_map_model_jax_to_port(tmp_path, rng, stype, params, dtype, scale_maps):
    jm = _jax_model([(stype, params, 40)], 4, dtype, scale_maps, rng, classes=[2, 5, 7, 11])
    path = tmp_path / "m.json"
    jm.save(str(path))
    tm = T.ml.load_model(str(path), device="cpu")
    assert isinstance(tm, T.ml.FeatureMapModel)
    assert tm.classes == [2, 5, 7, 11] and tm.scale_maps == scale_maps
    X = _data(rng, (10, D), dtype)
    ref = np.asarray(jm.predict(jnp.asarray(X)))
    out = tm.predict(torch.from_numpy(X))
    assert out.dtype == torch.from_numpy(X).dtype
    assert _rel(out.numpy(), ref) <= RTOL
    labels = tm.predict_labels(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jm.predict_labels(jnp.asarray(X))))
    assert tm.to_dict() == json.loads(path.read_text())
    # And back: the port's save loads in the JAX package.
    back_path = tmp_path / "back.json"
    tm.save(str(back_path))
    back = J.ml.load_model(str(back_path))
    assert json.loads(back_path.read_text()) == json.loads(path.read_text())
    assert _rel(np.asarray(back.predict(jnp.asarray(X))), ref) <= 1e-12


@pytest.mark.parametrize("scale_maps", [False, True])
def test_feature_map_model_port_to_jax(tmp_path, rng, scale_maps):
    """The port's save loads in the JAX package: two maps concatenated (a
    Gaussian RFT and the linear kernel's FJLT), float classes."""
    maps = [T.ml.GaussianKernel(D, 2.0).create_rft(32, "regular", T.SketchContext(seed=3)),
            T.ml.LinearKernel(D).create_rft(16, "fast", T.SketchContext(seed=4))]
    W = rng.standard_normal((48, 3)).astype(np.float32)
    tm = T.ml.FeatureMapModel(maps, W, scale_maps=scale_maps, classes=[0.5, 1.5, 2.5],
                              device="cpu")
    tm.info = {"note": "port", "iters": 3}
    path = tmp_path / "p.json"
    tm.save(str(path))
    jm = J.ml.load_model(str(path))
    assert isinstance(jm, J.ml.FeatureMapModel)
    X = _data(rng, (7, D), np.float32)
    assert _rel(tm.predict(torch.from_numpy(X)).numpy(), jm.predict(jnp.asarray(X))) <= RTOL
    jpath = tmp_path / "j.json"
    jm.save(str(jpath))
    assert json.loads(path.read_text()) == json.loads(jpath.read_text())


def test_feature_map_model_from_dict_and_raw_features(rng):
    """``from_dict`` carries a JAX model's JSON and numpy coefficients
    across; a model with no maps is linear in the raw features."""
    jm = _jax_model([("GaussianRFT", {"sigma": 1.0}, 20), ("CWT", {}, 12)], 2, np.float64,
                    False, rng)
    tm = T.ml.FeatureMapModel.from_dict(jm.to_dict(), np.asarray(jm.W), device="cpu")
    X = _data(rng, (5, D), np.float64)
    assert _rel(tm.predict(torch.from_numpy(X)).numpy(), jm.predict(jnp.asarray(X))) <= 1e-10
    W = rng.standard_normal((D, 3))
    raw = T.ml.FeatureMapModel([], W, input_dim=D, device="cpu")
    torch.testing.assert_close(raw.predict(torch.from_numpy(X)), torch.from_numpy(X @ W))
    with pytest.raises(ValueError, match="not a feature_map"):
        T.ml.FeatureMapModel.from_dict({"model_type": "kernel"}, W)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,params", KERNELS, ids=lambda v: str(v))
def test_kernel_model_both_ways(tmp_path, rng, name, params, dtype):
    Xtr = _data(rng, (12, D), dtype)
    A = rng.standard_normal((12, 3)).astype(dtype)
    jm = J.ml.KernelModel(J.ml.kernel_by_name(name, D, **params), jnp.asarray(Xtr),
                          jnp.asarray(A), classes=[1, 2, 3])
    jpath = tmp_path / "jk.json"
    jm.save(str(jpath))
    tm = T.ml.load_model(str(jpath), device="cpu")
    assert isinstance(tm, T.ml.KernelModel) and tm.classes == [1, 2, 3]
    X = _data(rng, (6, D), dtype)
    ref = np.asarray(jm.predict(jnp.asarray(X)))
    assert _rel(tm.predict(torch.from_numpy(X)).numpy(), ref) <= RTOL
    np.testing.assert_array_equal(tm.predict_labels(torch.from_numpy(X)).numpy(),
                                  np.asarray(jm.predict_labels(jnp.asarray(X))))
    tpath = tmp_path / "tk.json"
    tm.save(str(tpath))
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())
    back = J.ml.load_model(str(tpath))
    assert _rel(np.asarray(back.predict(jnp.asarray(X))), ref) <= RTOL
    np.testing.assert_array_equal(np.asarray(back.X_train), Xtr)


def test_bf16_coefficients_bitwise_without_ml_dtypes(tmp_path, rng, monkeypatch):
    """bf16 W and A are saved as 2-byte records and restored bit for bit
    by either package; the port's load works with ``ml_dtypes``
    unimportable."""
    import ml_dtypes

    Wj = rng.standard_normal((30, 4)).astype(ml_dtypes.bfloat16)
    jm = J.ml.FeatureMapModel([J.sketch.GaussianRFT(D, 30, J.SketchContext(seed=2))],
                              jnp.asarray(Wj))
    jpath = tmp_path / "b.json"
    jm.save(str(jpath))
    Xtr = rng.standard_normal((5, D)).astype(ml_dtypes.bfloat16)
    Aj = rng.standard_normal((5, 2)).astype(ml_dtypes.bfloat16)
    jk = J.ml.KernelModel(J.ml.GaussianKernel(D, 1.0), jnp.asarray(Xtr), jnp.asarray(Aj))
    kpath = tmp_path / "bk.json"
    jk.save(str(kpath))
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    tm = T.ml.load_model(str(jpath), device="cpu")
    tk = T.ml.load_model(str(kpath), device="cpu")
    assert tm.W.dtype == torch.bfloat16 and tk.A.dtype == torch.bfloat16
    np.testing.assert_array_equal(tm.W.view(torch.int16).numpy(), Wj.view(np.int16))
    np.testing.assert_array_equal(tk.X_train.view(torch.int16).numpy(), Xtr.view(np.int16))
    np.testing.assert_array_equal(tk.A.view(torch.int16).numpy(), Aj.view(np.int16))
    tpath = tmp_path / "t.json"
    tm.save(str(tpath))
    again = T.ml.load_model(str(tpath), device="cpu")
    assert torch.equal(again.W.view(torch.int16), tm.W.view(torch.int16))
    monkeypatch.delitem(sys.modules, "ml_dtypes")
    np.testing.assert_array_equal(np.asarray(J.ml.load_model(str(tpath)).W).view(np.int16),
                                  Wj.view(np.int16))


def test_load_rejects_unknown_types(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"model_type": "tree"}))
    with pytest.raises(ValueError, match="unknown model_type"):
        T.ml.load_model(str(path), device="cpu")
    with pytest.raises(ValueError, match="not a kernel"):
        T.ml.KernelModel.load(str(path), device="cpu")


def test_flagship_matches_jax_entry():
    """The port's twin of ``__graft_entry__.entry``: same map, same numpy
    draws, decision values within 1e-5."""
    spec = importlib.util.spec_from_file_location("_graft_entry", ROOT / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfwd, (jX, jW) = graft.entry()
    tfwd, (tX, tW) = T.flagship.entry(device="cpu")
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
    ref = np.asarray(jfwd(jX, jW))
    out = tfwd(tX, tW)
    assert out.shape == (256, 10) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= RTOL
