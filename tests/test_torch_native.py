"""The port's native C core (``libskylark_tpu_torch.native``, its own copy
of the C++ source, built into ``build/native/``) against the port's
torch sketches and kernels and against the JAX package's native core.

``tests/test_native.py`` mirrored case for case, with the port's
sketches, kernels and models in place of the JAX package's, at that
file's tolerances (integer draws bitwise; f64 transcendental draws
1e-12; grams 1e-10; sketch applies 1e-9 for the integer-derived types,
1e-8 for the RFT/RLT/QMC maps, 1e-7 for Fastfood).  The two packages'
native libraries are compiled from the same C code, so every native
result is held bitwise equal to the JAX package's own native result.
Plus: two processes building the library at once both load a valid one.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu.native as JN
from libskylark_tpu_torch import SketchContext, native
from libskylark_tpu_torch.core.random import sample
from libskylark_tpu_torch.sketch import CWT, JLT, UST, WZT, from_json

ROOT = Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True)
def _needs_the_library():
    """Decided when a test runs, not at import: a machine without g++
    has no native library."""
    if not native.available():
        pytest.skip("native library unavailable (no g++)")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def test_library_is_built_from_the_ports_source():
    """The port never loads the JAX package's library or reads its tree:
    its library lives under build/native/, named by the hash of its own
    source and flags."""
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert native.SRC == ROOT / "libskylark_tpu_torch" / "native" / "src" / "skylark_native.cpp"
    assert native.lib()._name == str(path)
    assert "libskylark_tpu" + os.sep not in native.lib()._name


def test_two_processes_building_at_once_both_load(tmp_path):
    """Each process compiles to its own temporary file and moves it into
    place with os.replace: both load a valid library, and no temporary
    is left behind."""
    code = (
        "import sys; from pathlib import Path; import libskylark_tpu_torch.native as n; "
        f"n.BUILD_DIR = Path({str(tmp_path)!r}); "
        "assert n.available(), 'no library'; "
        "print(n.lib()._name, n.parse_libsvm_bytes(b'1 2:3.5\\n')[3].tolist())"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[-1] == "[3.5]"
    names = {out.split()[0] for out, _ in outs}
    assert names == {str(tmp_path / native.library_path().name)}
    assert sorted(f.name for f in tmp_path.iterdir()) == [native.library_path().name]


class TestRNGParity:
    def test_integer_draws_bit_identical(self):
        out = np.empty(1000, np.float64)
        native.lib().sl_sample(12345, 777, 1000, 2, 0, out)
        ref = N(sample("rademacher", 12345, 777, 1000, dtype=torch.float64, device="cpu"))
        np.testing.assert_array_equal(out, ref)
        jout = np.empty(1000, np.float64)
        JN.lib().sl_sample(12345, 777, 1000, 2, 0, jout)
        np.testing.assert_array_equal(out, jout)

    def test_uniform_bit_identical(self):
        out = np.empty(500, np.float64)
        native.lib().sl_sample(9, 0, 500, 4, 0, out)
        ref = N(sample("uniform", 9, 0, 500, dtype=torch.float64, device="cpu"))
        np.testing.assert_array_equal(out, ref)

    def test_normal_cauchy_close(self):
        for dist, code in [("normal", 0), ("cauchy", 1), ("exponential", 3)]:
            out = np.empty(2000, np.float64)
            native.lib().sl_sample(42, 100, 2000, code, 0, out)
            ref = N(sample(dist, 42, 100, 2000, dtype=torch.float64, device="cpu"))
            np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
            jout = np.empty(2000, np.float64)
            JN.lib().sl_sample(42, 100, 2000, code, 0, jout)
            np.testing.assert_array_equal(out, jout)


class TestNativeKernelGram:
    """≙ capi/ckernel.cpp: native grams match the port's kernel layer."""

    @pytest.mark.parametrize("name,params,pykernel", [
        ("linear", {}, lambda ml, d: ml.LinearKernel(d)),
        ("gaussian", {"p1": 2.0}, lambda ml, d: ml.GaussianKernel(d, 2.0)),
        ("polynomial", {"p1": 3, "p2": 1.5, "p3": 0.5},
         lambda ml, d: ml.PolynomialKernel(d, 3, 1.5, 0.5)),
        ("laplacian", {"p1": 1.5}, lambda ml, d: ml.LaplacianKernel(d, 1.5)),
        ("matern", {"p1": 1.5, "p2": 2.0}, lambda ml, d: ml.MaternKernel(d, 1.5, 2.0)),
    ])
    def test_matches_port_kernels(self, name, params, pykernel):
        from libskylark_tpu_torch import ml

        rng = np.random.default_rng(0)
        X = rng.standard_normal((12, 5))
        Y = rng.standard_normal((7, 5))
        K = native.kernel_gram(name, X, Y, **params)
        ref = N(pykernel(ml, 5).gram(T(X), T(Y)))
        np.testing.assert_allclose(K, ref, rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(K, JN.kernel_gram(name, X, Y, **params))

    def test_expsemigroup(self):
        from libskylark_tpu_torch.ml import ExpSemigroupKernel

        rng = np.random.default_rng(1)
        X = np.abs(rng.standard_normal((8, 4)))
        K = native.kernel_gram("expsemigroup", X, p1=0.3)
        np.testing.assert_allclose(K, N(ExpSemigroupKernel(4, 0.3).gram(T(X))), rtol=1e-10)

    @pytest.mark.parametrize("kernel,params", [
        ("nope", {}), ("gaussian", {}), ("polynomial", {"p1": 2}), ("matern", {"p1": 1.5}),
    ])
    def test_missing_parameters_rejected(self, kernel, params):
        with pytest.raises(ValueError):
            native.kernel_gram(kernel, np.ones((2, 2)), **params)


class TestNativeNLA:
    """≙ capi/cnla.cpp: native randomized SVD / sketch-and-solve LS."""

    def test_svd_exact_on_low_rank(self):
        rng = np.random.default_rng(2)
        A = rng.standard_normal((120, 30)) @ rng.standard_normal((30, 40))
        r = 30
        U, S, V = native.approximate_svd(native.NativeContext(seed=7), A, r, num_iterations=2)
        rec = U @ np.diag(S) @ V.T
        assert np.linalg.norm(rec - A) / np.linalg.norm(A) < 1e-8
        np.testing.assert_allclose(U.T @ U, np.eye(r), atol=1e-10)
        np.testing.assert_allclose(V.T @ V, np.eye(r), atol=1e-10)
        np.testing.assert_allclose(S, np.linalg.svd(A, compute_uv=False)[:r], rtol=1e-8)
        for got, ref in zip((U, S, V), JN.approximate_svd(JN.NativeContext(seed=7), A, r,
                                                          num_iterations=2)):
            np.testing.assert_array_equal(got, ref)

    def test_svd_ordering_and_shapes(self):
        rng = np.random.default_rng(3)
        A = rng.standard_normal((50, 20))
        U, S, V = native.approximate_svd(native.NativeContext(seed=9), A, 5, num_iterations=3)
        assert U.shape == (50, 5) and S.shape == (5,) and V.shape == (20, 5)
        assert np.all(np.diff(S) <= 1e-12)

    def test_least_squares_residual(self):
        rng = np.random.default_rng(4)
        A = rng.standard_normal((2000, 30))
        x_true = rng.standard_normal(30)
        b = A @ x_true
        ctx = native.NativeContext(seed=11)
        x = native.approximate_least_squares(ctx, A, b)
        np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-8)
        np.testing.assert_array_equal(
            x, JN.approximate_least_squares(JN.NativeContext(seed=11), A, b))
        B = np.stack([b, 2 * b], axis=1)
        X2 = native.approximate_least_squares(ctx, A, B)
        np.testing.assert_allclose(X2[:, 1], 2 * x_true, rtol=1e-6, atol=1e-8)
        with pytest.raises(ValueError):
            native.approximate_least_squares(ctx, A, b[:5])


def _gaussian_model(tmp_path, seed, d, s, W, nmaps=1, scale=False, name="m.json"):
    from libskylark_tpu_torch.ml import FeatureMapModel, GaussianKernel

    ctx = SketchContext(seed=seed)
    kernel = GaussianKernel(d, sigma=2.0)
    maps = [kernel.create_rft(s, "regular", ctx) for _ in range(nmaps)]
    model = FeatureMapModel(maps, W, scale_maps=scale, input_dim=d, device="cpu")
    path = tmp_path / name
    model.save(path)
    return model, path


class TestNativeModelPredict:
    """≙ capi/cml.cpp: native prediction from a model the port saved."""

    def test_matches_port_predict(self, tmp_path):
        rng = np.random.default_rng(5)
        d, s, k = 6, 32, 3
        model, path = _gaussian_model(tmp_path, 31, d, s, rng.standard_normal((2 * s, k)),
                                      nmaps=2, scale=True)
        X = rng.standard_normal((20, d))
        ref = N(model.predict(T(X)))
        out = native.model_predict(path, X)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-8)
        np.testing.assert_array_equal(out, JN.model_predict(path, X))

    def test_linear_model_no_maps(self, tmp_path):
        from libskylark_tpu_torch.ml import FeatureMapModel

        rng = np.random.default_rng(6)
        W = rng.standard_normal((4, 2))
        FeatureMapModel([], W, input_dim=4, device="cpu").save(tmp_path / "lin.json")
        X = rng.standard_normal((7, 4))
        np.testing.assert_allclose(native.model_predict(tmp_path / "lin.json", X), X @ W,
                                   rtol=1e-12)

    def test_missing_file_errors(self, tmp_path):
        from libskylark_tpu_torch.utils.exceptions import SkylarkError

        with pytest.raises(SkylarkError):
            native.model_predict(tmp_path / "nope.json", np.zeros((2, 3)))

    def test_1d_coef_squeezes_like_python(self, tmp_path):
        rng = np.random.default_rng(7)
        model, path = _gaussian_model(tmp_path, 41, 4, 16, rng.standard_normal(16))
        X = rng.standard_normal((9, 4))
        ref = N(model.predict(T(X)))
        out = native.model_predict(path, X)
        assert out.shape == ref.shape  # (9,), not (9, 1)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)

    def test_handle_reuse(self, tmp_path):
        rng = np.random.default_rng(8)
        model, path = _gaussian_model(tmp_path, 43, 3, 8, rng.standard_normal((8, 2)))
        nm = native.NativeModel(path)
        assert nm.num_outputs == 2
        X = rng.standard_normal((5, 3))
        out1, out2 = nm.predict(X), nm.predict(X)
        np.testing.assert_array_equal(out1, out2)
        np.testing.assert_allclose(out1, N(model.predict(T(X))), rtol=1e-6, atol=1e-9)

    def test_old_version_sketch_warns(self):
        d = json.loads(JLT(10, 4, SketchContext(seed=1)).to_json())
        d["skylark_version"] = 1
        with pytest.warns(UserWarning, match="stream revision"):
            from_json(json.dumps(d))

    def test_c_side_stream_version(self, tmp_path):
        L = native.lib()
        assert L.sl_stream_revision() == 2
        rng = np.random.default_rng(9)
        _, path = _gaussian_model(tmp_path, 47, 3, 8, rng.standard_normal((8, 2)), name="mv.json")
        h = ctypes.c_void_p()
        assert L.sl_model_load(str(path).encode(), ctypes.byref(h)) == 0
        assert L.sl_model_stream_version(h) == 2
        L.sl_model_free(h)
        d = json.loads(path.read_text())
        d2 = {"skylark_version": 1}
        d2.update({k: v for k, v in d.items() if k != "skylark_version"})
        path.write_text(json.dumps(d2))
        h = ctypes.c_void_p()
        assert L.sl_model_load(str(path).encode(), ctypes.byref(h)) == 0
        assert L.sl_model_stream_version(h) == 1
        L.sl_model_free(h)
        with pytest.warns(UserWarning, match="stream revision 1"):
            native.NativeModel(path)

    def test_version_scoped_to_toplevel(self, tmp_path):
        L = native.lib()
        rng = np.random.default_rng(11)
        _, path = _gaussian_model(tmp_path, 48, 3, 8, rng.standard_normal((8, 2)),
                                  name="mv2.json")
        d = json.loads(path.read_text())
        assert d["maps"][0]["skylark_version"] >= 2
        d_no_top = {k: v for k, v in d.items() if k != "skylark_version"}
        d_no_top = {"maps": d_no_top.pop("maps"), **d_no_top}
        path.write_text(json.dumps(d_no_top))
        h = ctypes.c_void_p()
        assert L.sl_model_load(str(path).encode(), ctypes.byref(h)) == 0
        assert L.sl_model_stream_version(h) == 1
        L.sl_model_free(h)
        d_after = {k: v for k, v in d.items() if k != "skylark_version"}
        d_after = {"maps": d_after.pop("maps"), **d_after,
                   "skylark_version": d["skylark_version"]}
        path.write_text(json.dumps(d_after))
        h = ctypes.c_void_p()
        assert L.sl_model_load(str(path).encode(), ctypes.byref(h)) == 0
        assert L.sl_model_stream_version(h) == d["skylark_version"]
        L.sl_model_free(h)


def test_supported_sketch_transforms_introspection():
    combos = native.supported_sketch_transforms()
    assert combos == JN.supported_sketch_transforms()
    assert len(combos) == 34  # 17 types x 2 directions
    from libskylark_tpu_torch.sketch import sketch_registry

    assert {c[0] for c in combos} <= set(sketch_registry())
    for c in combos:
        assert c[1:3] == ("Matrix", "Matrix")
        assert c[3] in ("columnwise", "rowwise")


def _port(cls, n, s, seed, **kw):
    return cls(n, s, SketchContext(seed=seed), **kw)


def _apply(S, A, dim="columnwise"):
    return N(S.apply(T(A), dim))


class TestCAPI:
    def test_context_counter_matches_port(self):
        nctx = native.NativeContext(5)
        pctx = SketchContext(seed=5)
        native.NativeSketch.create(nctx, "JLT", 30, 10)
        JLT(30, 10, pctx)
        assert nctx.counter == pctx.counter
        native.NativeSketch.create(nctx, "CWT", 30, 10)
        CWT(30, 10, pctx)
        assert nctx.counter == pctx.counter

    @pytest.mark.parametrize("stype,cls", [("JLT", JLT), ("CWT", CWT)])
    def test_apply_matches_port(self, rng, stype, cls):
        n, s, m = 40, 12, 7
        A = rng.standard_normal((n, m))
        ns = native.NativeSketch.create(native.NativeContext(3), stype, n, s)
        ps = _port(cls, n, s, 3)
        np.testing.assert_allclose(ns.apply(A, "columnwise"), _apply(ps, A), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(ns.apply(A.T, "rowwise"), _apply(ps, A.T, "rowwise"),
                                   rtol=1e-9, atol=1e-11)
        js = JN.NativeSketch.create(JN.NativeContext(3), stype, n, s)
        np.testing.assert_array_equal(ns.apply(A), js.apply(A))

    def test_wzt_and_ust_match(self, rng):
        n, s, m = 30, 8, 4
        A = rng.standard_normal((n, m))
        ns = native.NativeSketch.create(native.NativeContext(8), "WZT", n, s, 1.5)
        np.testing.assert_allclose(ns.apply(A), _apply(_port(WZT, n, s, 8, p=1.5), A),
                                   rtol=1e-9, atol=1e-11)
        nu = native.NativeSketch.create(native.NativeContext(9), "UST", n, s, 0.0)
        np.testing.assert_allclose(nu.apply(A), _apply(_port(UST, n, s, 9, replace=False), A),
                                   rtol=1e-12)

    def test_serialization_cross_language(self, rng):
        n, s = 25, 6
        ns = native.NativeSketch.create(native.NativeContext(4), "JLT", n, s)
        ps = from_json(ns.to_json())
        A = rng.standard_normal((n, 3))
        np.testing.assert_allclose(ns.apply(A), _apply(ps, A), rtol=1e-9, atol=1e-11)
        ps2 = _port(JLT, n, s, 4)
        ns2 = native.NativeSketch.from_json(ps2.to_json())
        np.testing.assert_allclose(ns2.apply(A), _apply(ps2, A), rtol=1e-9, atol=1e-11)

    def test_error_codes(self):
        from libskylark_tpu_torch.utils.exceptions import SkylarkError

        with pytest.raises(SkylarkError, match="native error"):
            native.NativeSketch.create(native.NativeContext(1), "NOPE", 5, 3)


class TestLibsvmParser:
    def test_matches_python_parser(self, tmp_path, rng):
        from libskylark_tpu.io import read_libsvm as jax_read_libsvm
        from libskylark_tpu_torch.io import read_libsvm, write_libsvm

        X = rng.standard_normal((50, 12))
        X[rng.random((50, 12)) < 0.4] = 0
        y = rng.integers(0, 5, 50).astype(float)
        write_libsvm(tmp_path / "f", X, y)
        X1, _ = read_libsvm(tmp_path / "f", n_features=12)
        labels, rows, cols, vals, max_col = native.parse_libsvm_bytes((tmp_path / "f").read_bytes())
        X2 = np.zeros((len(labels), 12))
        X2[rows, cols] = vals
        np.testing.assert_allclose(X2, X, rtol=1e-15)
        np.testing.assert_allclose(labels, y)
        np.testing.assert_array_equal(X1, jax_read_libsvm(tmp_path / "f", n_features=12)[0])
        for got, ref in zip((labels, rows, cols, vals),
                            JN.parse_libsvm_bytes((tmp_path / "f").read_bytes())):
            np.testing.assert_array_equal(got, ref)

    def test_comments_and_blanks(self):
        data = b"# header\n\n1 1:2.5 3:1 # trailing\n-1 2:0.5\n"
        labels, rows, cols, vals, max_col = native.parse_libsvm_bytes(data)
        np.testing.assert_allclose(labels, [1, -1])
        assert max_col == 3
        np.testing.assert_array_equal(cols, [0, 2, 1])
        np.testing.assert_allclose(vals, [2.5, 1.0, 0.5])

    def test_large_file_multithreaded(self, tmp_path, rng):
        # >64KiB takes the threaded path; rows stay in file order.
        lines = []
        for i in range(5000):
            feats = " ".join(f"{j + 1}:{rng.standard_normal():.6f}" for j in rng.choice(100, 8))
            lines.append(f"{i % 3} {feats}")
        data = ("\n".join(lines) + "\n").encode()
        assert len(data) > (1 << 16)
        calls, nbytes = native.parse_libsvm_bytes.calls, native.parse_libsvm_bytes.bytes
        labels, rows, cols, vals, max_col = native.parse_libsvm_bytes(data)
        assert native.parse_libsvm_bytes.calls == calls + 1
        assert native.parse_libsvm_bytes.bytes == nbytes + len(data)
        assert len(labels) == 5000 and len(vals) == 5000 * 8
        assert rows[0] == 0 and rows[-1] == 4999
        np.testing.assert_allclose(labels[:3], [0, 1, 2])


def _extended(stype, cls_name, n, s, seed, params, kw, A, rtol, atol):
    import libskylark_tpu_torch.sketch as sk

    ns = native.NativeSketch.create(native.NativeContext(seed), stype, n, s, *params)
    ps = getattr(sk, cls_name)(n, s, SketchContext(seed=seed), **kw)
    np.testing.assert_allclose(ns.apply(A), _apply(ps, A), rtol=rtol, atol=atol)
    pctx = SketchContext(seed=seed)
    getattr(sk, cls_name)(n, s, pctx, **kw)
    return ns, pctx


class TestExtendedNativeTypes:
    """FJLT / RFT / RLT native applies match the port's sketches."""

    def test_fjlt_matches_port(self, rng):
        A = rng.standard_normal((100, 6))  # pads to nb = 128
        nctx = native.NativeContext(21)
        ns = native.NativeSketch.create(nctx, "FJLT", 100, 24)
        ps = _port(__import__("libskylark_tpu_torch").sketch.FJLT, 100, 24, 21)
        np.testing.assert_allclose(ns.apply(A), _apply(ps, A), rtol=1e-9, atol=1e-11)
        pctx = SketchContext(seed=21)
        __import__("libskylark_tpu_torch").sketch.FJLT(100, 24, pctx)
        assert nctx.counter == pctx.counter

    @pytest.mark.parametrize("stype,param", [("GaussianRFT", 2.5), ("LaplacianRFT", 1.5)])
    def test_rft_matches_port(self, rng, stype, param):
        _extended(stype, stype, 30, 16, 22, (param,), {"sigma": param},
                  rng.standard_normal((30, 5)), 1e-8, 1e-10)

    def test_rlt_matches_port(self, rng):
        _extended("ExpSemigroupRLT", "ExpSemigroupRLT", 20, 12, 23, (0.4,), {"beta": 0.4},
                  rng.random((20, 4)), 1e-8, 1e-10)

    def test_extended_serialization_roundtrip(self, rng):
        A = rng.standard_normal((50, 3))
        ns = native.NativeSketch.create(native.NativeContext(24), "GaussianRFT", 50, 8, 3.0)
        np.testing.assert_allclose(ns.apply(A), _apply(from_json(ns.to_json()), A),
                                   rtol=1e-8, atol=1e-10)


class TestFastfoodMaternNative:
    def test_matern_matches_port(self, rng):
        ns, pctx = _extended("MaternRFT", "MaternRFT", 24, 10, 31, (1.5, 2.0),
                             {"nu": 1.5, "l": 2.0}, rng.standard_normal((24, 4)), 1e-8, 1e-10)
        assert ns is not None

    def test_fastgaussian_matches_port(self, rng):
        nctx = native.NativeContext(32)
        native.NativeSketch.create(nctx, "FastGaussianRFT", 20, 40, 1.7)
        _, pctx = _extended("FastGaussianRFT", "FastGaussianRFT", 20, 40, 32, (1.7,),
                            {"sigma": 1.7}, rng.standard_normal((20, 3)), 1e-7, 1e-9)
        assert nctx.counter == pctx.counter

    def test_fastmatern_matches_port(self, rng):
        _extended("FastMaternRFT", "FastMaternRFT", 12, 20, 33, (1.0, 1.5),
                  {"nu": 1.0, "l": 1.5}, rng.standard_normal((12, 3)), 1e-7, 1e-9)

    def test_serialization_roundtrip_new_types(self, rng):
        A = rng.standard_normal((16, 2))
        for stype, p1, p2 in [("MaternRFT", 2.5, 1.2), ("FastGaussianRFT", 0.9, 0.0),
                              ("FastMaternRFT", 0.5, 2.0)]:
            ns = native.NativeSketch.create(native.NativeContext(34), stype, 16, 8, p1, p2)
            np.testing.assert_allclose(ns.apply(A), _apply(from_json(ns.to_json()), A),
                                       rtol=1e-7, atol=1e-9)


class TestQMCAndPPTNative:
    @pytest.mark.parametrize("stype", ["GaussianQRFT", "LaplacianQRFT"])
    def test_qrft_matches_port(self, rng, stype):
        nctx = native.NativeContext(41)
        ns = native.NativeSketch.create(nctx, stype, 12, 10, 1.8, 50.0)
        import libskylark_tpu_torch.sketch as sk

        ps = getattr(sk, stype)(12, 10, SketchContext(seed=41), sigma=1.8, skip=50)
        A = rng.standard_normal((12, 4))
        np.testing.assert_allclose(ns.apply(A), _apply(ps, A), rtol=1e-8, atol=1e-10)
        assert nctx.counter == 0  # QMC consumes no counters

    def test_qrlt_matches_port(self, rng):
        _extended("ExpSemigroupQRLT", "ExpSemigroupQRLT", 8, 12, 42, (0.3, 25.0),
                  {"beta": 0.3, "skip": 25}, rng.random((8, 3)), 1e-8, 1e-10)

    @pytest.mark.parametrize("s", [16, 12, 17, 100])
    def test_ppt_matches_port(self, rng, s):
        nctx = native.NativeContext(43)
        native.NativeSketch.create(nctx, "PPT", 10, s, 0.5, 2.0, 3.0)
        _, pctx = _extended("PPT", "PPT", 10, s, 43, (0.5, 2.0, 3.0),
                            {"q": 3, "c": 0.5, "gamma": 2.0}, rng.standard_normal((10, 5)),
                            1e-9, 1e-11)
        assert nctx.counter == pctx.counter

    def test_ppt_invalid_q_rejected(self):
        from libskylark_tpu_torch.utils.exceptions import SkylarkError

        with pytest.raises(SkylarkError):
            native.NativeSketch.create(native.NativeContext(44), "PPT", 10, 12, 1.0, 1.0, -1.0)

    def test_all_17_serialization_roundtrips(self, rng):
        A = np.abs(rng.standard_normal((16, 2)))
        cases = [
            ("JLT", 0.0, 0.0, 0.0), ("CT", 1.5, 0.0, 0.0),
            ("CWT", 0.0, 0.0, 0.0), ("MMT", 0.0, 0.0, 0.0),
            ("WZT", 1.5, 0.0, 0.0), ("UST", 1.0, 0.0, 0.0),
            ("FJLT", 0.0, 0.0, 0.0), ("GaussianRFT", 2.0, 0.0, 0.0),
            ("LaplacianRFT", 1.0, 0.0, 0.0), ("ExpSemigroupRLT", 0.4, 0.0, 0.0),
            ("MaternRFT", 1.5, 1.0, 0.0), ("FastGaussianRFT", 1.0, 0.0, 0.0),
            ("FastMaternRFT", 0.5, 1.0, 0.0), ("GaussianQRFT", 1.0, 7.0, 0.0),
            ("LaplacianQRFT", 1.0, 7.0, 0.0), ("ExpSemigroupQRLT", 0.3, 7.0, 0.0),
            ("PPT", 1.0, 1.0, 2.0),
        ]
        for stype, p1, p2, p3 in cases:
            ns = native.NativeSketch.create(native.NativeContext(45), stype, 16, 8, p1, p2, p3)
            np.testing.assert_allclose(ns.apply(A), _apply(from_json(ns.to_json()), A),
                                       rtol=1e-7, atol=1e-9, err_msg=stype)

    def test_ppt_zero_c_roundtrip(self, rng):
        from libskylark_tpu_torch.sketch import PPT

        A = rng.standard_normal((6, 2))
        ps = _port(PPT, 6, 8, 46, q=2, c=0.0, gamma=1.0)
        ns = native.NativeSketch.from_json(ps.to_json())
        np.testing.assert_allclose(ns.apply(A), _apply(ps, A), rtol=1e-9, atol=1e-11)
