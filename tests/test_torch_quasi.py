"""Port vs JAX package: the quasi-Monte-Carlo sketches — QJLT
(``sketch/quasi.py``), GaussianQRFT and LaplacianQRFT (``sketch/rft.py``)
and ExpSemigroupQRLT (``sketch/rlt.py``) — their JSON, and the "quasi"
feature tags of ``ml/kernels.py``.

Every sketch is built by the JAX package and loaded in the port from the
dict the JAX package writes (``deserialize_sketch``), then fed the same
numpy input.  Tolerances:

- f64: 1e-12 of the largest magnitude.  LaplacianQRFT's Cauchy rows
  reach |W| ~ 10^4 at these sizes (tan near its pole), so its cosine
  arguments reach ~10^5, where one f64 ulp is 1.5e-11: its f64 features
  are held at 1e-10 absolute (as ``test_torch_rft.py`` holds the
  Laplacian RFT), and its W, shifts and W·X at 1e-12 relative.
- f32: the Halton values are computed in f64 and cast once, as in the
  JAX package.  QJLT (linear) 1e-5 relative.  The QRFTs and the QRLT
  evaluate ndtri, tan and the Lévy quantile in f32 (the JAX order of
  casts); torch's f32 ndtri and tan are not XLA's and differ from them
  in the last ulps, and the W·X sums round in other orders.  The bounded
  features (cos and exp) are held at 1e-4 absolute on Z / outscale;
  LaplacianQRFT's f32 features, whose cosine arguments reach ~10^3 in
  f32, are held on W (8 ulp relative) and W·X (1e-5 of each row's largest
  magnitude) instead, and elementwise only in f64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu_torch.sketch import dense as tdense

MAPS = [
    ("QJLT", {}),
    ("GaussianQRFT", {"sigma": 1.3}),
    ("LaplacianQRFT", {"sigma": 2.0}),
    ("ExpSemigroupQRLT", {"beta": 0.5}),
]
SIZES = [(128, 256), (13, 40)]
F64_RTOL = 1e-12
F64_CAUCHY_ATOL = 1e-10
F32_ATOL = 1e-4
F32_QJLT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    """The JAX package without its policy store and plans (the port has
    neither) and with ``jax.core.trace_state_clean`` where it looks for
    it (newer jax keeps it in ``jax._src.core``)."""
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


def _pair(stype, n, s, seed=9, **params):
    Sj = J.sketch.create_sketch(stype, n, s, J.SketchContext(seed=seed), **params)
    return Sj, T.sketch.deserialize_sketch(Sj.serialize())


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _input(rng, stype, shape, dtype):
    A = rng.standard_normal(shape)
    return (np.abs(A) if stype == "ExpSemigroupQRLT" else A).astype(dtype)


@pytest.mark.parametrize("stype,params", MAPS)
def test_json_matches_jax_and_consumes_no_counters(stype, params):
    ctx_j, ctx_t = J.SketchContext(seed=1234567), T.SketchContext(seed=1234567)
    Sj = J.sketch.create_sketch(stype, 50, 20, ctx_j, **params)
    St = T.sketch.create_sketch(stype, 50, 20, ctx_t, **params)
    assert ctx_t.counter == ctx_j.counter == 0
    assert St.to_json() == Sj.to_json()
    Sd = T.sketch.deserialize_sketch(Sj.serialize())
    assert type(Sd) is type(St) and Sd.to_json() == Sj.to_json()
    assert T.sketch.from_json(St.to_json()).to_dict() == St.to_dict()
    if stype == "QJLT":
        d = St.to_dict()
        assert d["skip"] == 1234567 % (1 << 20) and d["leap"] == int(T.core.primes(51)[-1])


@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
@pytest.mark.parametrize("n,s", SIZES)
@pytest.mark.parametrize("stype,params", MAPS)
def test_apply_matches_jax_f64(rng, stype, params, n, s, dim):
    Sj, St = _pair(stype, n, s, **params)
    for shape in ((n, 7) if dim == "columnwise" else (7, n), (n,)):
        A = _input(rng, stype, shape, np.float64)
        out = St.apply(torch.from_numpy(A), dim)
        ref = Sj.apply(jnp.asarray(A), dim)
        assert out.dtype == torch.float64 and tuple(out.shape) == tuple(ref.shape)
        if stype == "LaplacianQRFT":
            assert np.abs(_np(out) - _np(ref)).max() <= F64_CAUCHY_ATOL
        else:
            assert _rel(out, ref) <= F64_RTOL


@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
@pytest.mark.parametrize("n,s", SIZES)
@pytest.mark.parametrize("stype,params", MAPS)
def test_apply_matches_jax_f32(rng, stype, params, n, s, dim):
    Sj, St = _pair(stype, n, s, **params)
    for shape in ((n, 7) if dim == "columnwise" else (7, n), (n,)):
        A = _input(rng, stype, shape, np.float32)
        out = St.apply(torch.from_numpy(A), dim)
        ref = Sj.apply(jnp.asarray(A), dim)
        assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
        if stype == "QJLT":
            assert _rel(out, ref) <= F32_QJLT_RTOL
        elif stype != "LaplacianQRFT":
            assert np.abs(_np(out) - _np(ref)).max() / St.outscale <= F32_ATOL


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("stype", ["GaussianQRFT", "LaplacianQRFT"])
def test_qrft_operands_and_wx_match_jax(rng, stype, dtype):
    Sj, St = _pair(stype, 128, 256, sigma=0.7)
    W, shifts = St.realize(torch.float64 if dtype == np.float64 else torch.float32, device="cpu")
    Wj, shj = Sj.realize(jnp.float64 if dtype == np.float64 else jnp.float32)
    assert W.dtype == shifts.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    if dtype == np.float64:
        assert _rel(W, Wj) <= F64_RTOL and _rel(shifts, shj) <= F64_RTOL
    else:
        ulp = np.spacing(np.abs(np.asarray(Wj))).astype(np.float64)
        assert np.all(np.abs(_np(W) - _np(Wj)) <= 8 * ulp)
        np.testing.assert_array_equal(shifts.numpy(), np.asarray(shj))
    X = rng.standard_normal((128, 9)).astype(dtype)
    wx, wxj = _np(W @ torch.from_numpy(X)), _np(Wj @ jnp.asarray(X))
    row_scale = np.abs(wxj).max(axis=1, keepdims=True)
    assert np.all(np.abs(wx - wxj) <= (F64_RTOL if dtype == np.float64 else 1e-5) * row_scale)


def test_shifts_are_the_last_halton_coordinate():
    S = T.sketch.GaussianQRFT(10, 16, T.SketchContext(), sigma=1.0, skip=5)
    U = T.core.LeapedHaltonSequence(11).window(5, 16, torch.float64, device="cpu")
    W, shifts = S.realize(torch.float64, device="cpu")
    assert torch.equal(shifts, U[:, 10] * (2.0 * math.pi))
    assert torch.equal(W, torch.special.ndtri(U[:, :10]) * 1.0)


def test_qjlt_realize_is_a_pure_function_of_row_and_column():
    S = T.sketch.QJLT(300, 40, T.SketchContext(seed=77))
    full = S.realize(torch.float64, device="cpu")
    assert torch.equal(S.realize(torch.float64, offset=(7, 120), shape=(20, 150), device="cpu"),
                       full[7:27, 120:270])
    # ... and bitwise the 41-digit loop without tiers (the JAX package's
    # realization), through the same ndtri and scale.
    p = torch.from_numpy(T.core.primes(300))[None, :]
    idx = (S.skip + torch.arange(40, dtype=torch.int64))[:, None] * S.leap
    u = T.core.radical_inverse(p, idx)
    assert torch.equal(full, torch.special.ndtri(u) * torch.tensor(S.scale, dtype=torch.float64))
    assert torch.equal(S.realize(device="cpu"), full.float())


def test_qjlt_panels_equal_the_whole(rng, monkeypatch):
    S = T.sketch.QJLT(500, 64, T.SketchContext(seed=3))
    whole = S.realize(torch.float32, device="cpu")
    A = torch.from_numpy(rng.standard_normal((500, 6)).astype(np.float32))
    ref = S.apply(A)
    monkeypatch.setattr(tdense, "MAX_REALIZE_ELEMENTS", 64 * 37)  # panels of 37 columns
    calls = []
    realize = S.realize

    def spy(*a, **k):
        out = realize(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(S, "realize", spy)
    out = S.apply(A)
    assert len(calls) == math.ceil(500 / 37)
    assert torch.equal(torch.cat(calls, dim=1), whole)
    assert _rel(out, ref) <= F32_QJLT_RTOL
    assert S.hoistable_operands(torch.float32, "cpu") is None  # no single Omega above the limit
    rows = S.apply(A.T.contiguous(), "rowwise")
    assert _rel(rows, ref.T) <= F32_QJLT_RTOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_qjlt_operands_are_memoized_and_bitwise_apply(rng, dtype):
    S = T.sketch.QJLT(80, 24, T.SketchContext(seed=5))
    ops = S.hoistable_operands(dtype, "cpu")
    assert ops is S.hoistable_operands(dtype, "cpu")
    assert torch.equal(ops, S.realize(dtype, device="cpu"))
    A = torch.from_numpy(rng.standard_normal((80, 5))).to(dtype)
    for dim, X in (("columnwise", A), ("rowwise", A.T.contiguous())):
        assert torch.equal(S.apply_with_operands(ops, X, dim), S.apply(X, dim))
    assert torch.equal(S.apply_with_operands(None, A), S.apply(A))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_qjlt_slices_match_jax_and_sum_to_the_apply(rng, dtype):
    Sj, St = _pair("QJLT", 40, 12)
    A = rng.standard_normal((40, 5)).astype(dtype)
    tol = F64_RTOL if dtype == np.float64 else F32_QJLT_RTOL
    got = St.apply_slice(torch.from_numpy(A[9:26]), 9)
    assert _rel(got, Sj.apply_slice(jnp.asarray(A[9:26]), 9)) <= tol
    total = sum(St.apply_slice(torch.from_numpy(A[i:i + 7]), i) for i in range(0, 40, 7))
    assert _rel(St.finalize_slices(total), St.apply(torch.from_numpy(A))) <= tol
    assert not St.supports_slice_kernel
    with pytest.raises(T.utils.UnsupportedError):
        St.apply_slice_kernel(torch.from_numpy(A[:7]), 0)


def test_qjlt_streaming_least_squares_matches_jax(rng):
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        n, d = 64, 4
        A = rng.standard_normal((n, d))
        b = A @ rng.standard_normal(d) + 0.01 * rng.standard_normal(n)
        blocks = [(A[i:i + 7], b[i:i + 7]) for i in range(0, n, 7)]
        xj, _ = J.linalg.streaming_least_squares(
            [(jnp.asarray(a), jnp.asarray(c)) for a, c in blocks], n, d, J.SketchContext(seed=11),
            J.linalg.LeastSquaresParams(sketch_type="QJLT", sketch_size=16))
        xt, _ = T.linalg.streaming_least_squares(
            [(torch.from_numpy(a), torch.from_numpy(c)) for a, c in blocks], n, d,
            T.SketchContext(seed=11), T.linalg.LeastSquaresParams(sketch_type="QJLT",
                                                                  sketch_size=16),
            stream_params=T.streaming.StreamParams(placer=T.streaming.pinned_placer("cpu")))
        assert _rel(xt, xj) <= 1e-10
    finally:
        torch.set_default_dtype(old)


def test_qjlt_least_squares_matches_jax(rng, monkeypatch):
    monkeypatch.setenv("SKYLARK_GUARD", "0")
    A = rng.standard_normal((200, 5))
    b = A @ rng.standard_normal(5) + 0.1 * rng.standard_normal(200)
    xj = J.linalg.approximate_least_squares(
        jnp.asarray(A), jnp.asarray(b), J.SketchContext(seed=4),
        J.linalg.LeastSquaresParams(sketch_type="QJLT", sketch_size=40))
    xt = T.linalg.approximate_least_squares(
        torch.from_numpy(A), torch.from_numpy(b), T.SketchContext(seed=4),
        T.linalg.LeastSquaresParams(sketch_type="QJLT", sketch_size=40))
    assert _rel(xt, xj) <= 1e-10


class _QuasiGaussian:
    """A Gaussian kernel whose "regular" features are its "quasi" map, so
    approximate KRR (which asks for "regular" or "fast") trains on QMC
    features in both packages."""

    @staticmethod
    def of(base):
        class K(base):
            def create_rft(self, s, tag, context):
                return super().create_rft(s, "quasi", context)
        return K


def test_approximate_krr_on_quasi_features_matches_jax(rng):
    X = rng.standard_normal((120, 6))
    y = rng.integers(0, 3, 120).astype(np.float64)
    Kj = _QuasiGaussian.of(J.ml.GaussianKernel)(6, 1.5)
    Kt = _QuasiGaussian.of(T.ml.GaussianKernel)(6, 1.5)
    mj = J.ml.approximate_kernel_ridge(Kj, jnp.asarray(X), jnp.asarray(y), 0.1, 64,
                                       J.SketchContext(seed=8))
    mt = T.ml.approximate_kernel_ridge(Kt, torch.from_numpy(X), torch.from_numpy(y), 0.1, 64,
                                       T.SketchContext(seed=8))
    assert type(mt.maps[0]).__name__ == "GaussianQRFT"
    assert _rel(mt.W, mj.W) <= 1e-10
