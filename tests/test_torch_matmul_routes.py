"""Port vs JAX package: the matmul routes the JAX package takes outside
its Pallas kernels, with the JAX package in its default environment.

- FJLT's subsampled-Hadamard GEMM (``sketch/fjlt.py``): ``_gemm_wins``
  gives the JAX verdict over a grid of (N, S, dtype, ``SKYLARK_NO_SRHT_
  GEMM``); ``_srht_matrix`` is bitwise the JAX matrix; the apply agrees
  with the JAX apply rowwise and columnwise, relative to the largest
  entry, within 1e-5 in f32, 1e-12 in f64 and 2^-7 in bf16 (one bf16
  rounding of each result after f32 sums in another order); the hoisted
  apply is bitwise the apply.
- Fastfood's realized W (``sketch/frft.py``): ``_realize_wins`` gives the
  JAX verdict (CPU backend) over a grid of (N, S, dtype, batch,
  ``SKYLARK_FRFT_GEMM`` / ``SKYLARK_NO_FRFT_GEMM``); the hoisted and the
  forced realized applies agree with the JAX package's at atol 5e-4
  (``tests/test_feature_maps.py``'s bound) and the hoisted apply is
  bitwise the forced one.
- PPT's matmul DFT (``sketch/ppt.py``): ``_dft_wins`` gives the JAX
  verdict; the forced DFT agrees with the JAX DFT and with the port's FFT
  within 0.02 of the feature scale (``tests/test_feature_maps.py``).
- The consumers: a rowwise Fastfood plan and streaming KRR on Fastfood
  features, both now on the realized W in both packages, held against
  the JAX package; the hoisted operand is realized once per plan and
  once per feature chunk.
- ``core.precision.mm_f32``: its CPU twin is bitwise the f32 lift.

The JAX package's plans are off (its plan path needs an API the
installed jax removed): its rowwise bucketed apply then takes the
hoisted operands eagerly, as the port's plan does.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.plans.plan as jplan
import libskylark_tpu.sketch.ppt as jppt
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
from libskylark_tpu_torch.core.precision import mm_f32
from libskylark_tpu_torch.sketch import fjlt as tfjlt
from libskylark_tpu_torch.sketch import frft as tfrft
from libskylark_tpu_torch.sketch import ppt as tppt

KNOBS = ("SKYLARK_NO_SRHT_GEMM", "SKYLARK_FRFT_GEMM", "SKYLARK_NO_FRFT_GEMM",
         "SKYLARK_PPT_DFT", "SKYLARK_NO_PPT_DFT")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float64": (jnp.float64, torch.float64), "float16": (jnp.float16, torch.float16)}
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float64": 1e-12}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in KNOBS + ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES",
                         "SKYLARK_GUARD_COND_MAX"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _rel(got, want):
    got = np.asarray(got.double().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want).astype(np.float64))
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


# -- the gates ------------------------------------------------------------------------


@pytest.mark.parametrize("knob", [None, "1", "0"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gemm_gate_gives_the_jax_verdict(monkeypatch, dtype, knob):
    if knob is not None:
        monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", knob)
    jdt, tdt = DTYPES[dtype]
    seen = set()
    for n, s in itertools.product((64, 300, 2048, 4096, 32768, 1 << 20),
                                  (16, 256, 768, 1024, 1536, 3072)):
        want = J.sketch.FJLT(n, s, J.SketchContext(seed=1))._gemm_wins(jdt)
        assert T.sketch.FJLT(n, s, T.SketchContext(seed=1))._gemm_wins(tdt) == want, (n, s)
        seen.add(want)
    assert seen == ({False} if knob == "1" else {True, False})


@pytest.mark.parametrize("knobs", [{}, {"SKYLARK_FRFT_GEMM": "1"},
                                   {"SKYLARK_FRFT_GEMM": "1", "SKYLARK_NO_FRFT_GEMM": "1"}])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_realize_gate_gives_the_jax_verdict(monkeypatch, dtype, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    jdt, tdt = DTYPES[dtype]
    seen = set()
    for n, s in itertools.product((24, 1000, 4096, 8192), (64, 2048, 4096, 16384)):
        Fj = J.sketch.FastGaussianRFT(n, s, J.SketchContext(seed=2), sigma=1.0)
        Ft = T.sketch.FastGaussianRFT(n, s, T.SketchContext(seed=2), sigma=1.0)
        for batch in (64, 128, 4096, 16384, 1 << 20):
            want = Fj._realize_wins(jdt, batch)
            assert Ft._realize_wins(tdt, batch) == want, (n, s, batch)
            seen.add(want)
    forced = knobs == {"SKYLARK_FRFT_GEMM": "1"} and dtype != "float64"
    assert seen == ({True, False} if forced else {False})


@pytest.mark.parametrize("knobs", [{}, {"SKYLARK_PPT_DFT": "1"},
                                   {"SKYLARK_PPT_DFT": "1", "SKYLARK_NO_PPT_DFT": "1"}])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dft_gate_gives_the_jax_verdict(monkeypatch, dtype, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    jdt, tdt = DTYPES[dtype]
    seen = set()
    for s, q in itertools.product((2, 16, 4096, 8192), (1, 3, 8, 9)):
        Pj = J.sketch.PPT(8, s, J.SketchContext(seed=3), q=q)
        Pt = T.sketch.PPT(8, s, T.SketchContext(seed=3), q=q)
        for batch in (8, 4095, 4096, 65536):
            want = Pj._dft_wins(jdt, batch)
            assert Pt._dft_wins(tdt, batch) == want, (s, q, batch)
            seen.add(want)
    forced = knobs == {"SKYLARK_PPT_DFT": "1"} and dtype == "bfloat16"
    assert seen == ({True, False} if forced else {False})


# -- FJLT's subsampled-Hadamard GEMM ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("n,s", [(64, 16), (300, 40), (1000, 128)])
def test_srht_matrix_is_bitwise_jax(n, s, dtype):
    jdt, tdt = DTYPES[dtype]
    Gj = J.sketch.FJLT(n, s, J.SketchContext(seed=4))._srht_matrix(jdt)
    St = T.sketch.FJLT(n, s, T.SketchContext(seed=4))
    Gt = St._srht_matrix(tdt, "cpu")
    assert Gt.dtype == tdt and tuple(Gt.shape) == (n, s)
    np.testing.assert_array_equal(Gt.double().numpy(), _np(Gj))
    # A block of its rows is those rows of the whole.
    assert torch.equal(St._srht_matrix(tdt, "cpu", rows=(7, n // 2)), Gt[7:n // 2])


@pytest.mark.parametrize("dim", ["rowwise", "columnwise"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("n,s,m", [(64, 16, 40), (300, 40, 7), (1000, 128, 33)])
def test_fjlt_gemm_route_matches_jax(rng, n, s, m, dtype, dim):
    """Both packages take the GEMM at these shapes (their gates say so), with
    a control: the port's WHT route differs from the GEMM by f32 rounding
    only, another seed's sketch by O(1)."""
    jdt, tdt = DTYPES[dtype]
    A = rng.standard_normal((m, n) if dim == "rowwise" else (n, m))
    Sj = J.sketch.FJLT(n, s, J.SketchContext(seed=5))
    St = T.sketch.FJLT(n, s, T.SketchContext(seed=5))
    assert Sj._gemm_wins(jdt) and St._gemm_wins(tdt)
    want = Sj.apply(jnp.asarray(A).astype(jdt), dim)
    At = torch.from_numpy(A).to(tdt)
    got = St.apply(At, dim)
    assert got.dtype == tdt and str(want.dtype) == dtype
    assert _rel(got, _np(want)) <= TOL[dtype]
    other = T.sketch.FJLT(n, s, T.SketchContext(seed=6)).apply(At, dim)
    assert _rel(other, _np(want)) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fjlt_hoisted_is_bitwise_the_apply(rng, dtype):
    """``tests/test_sketch.py``'s pin in the port: the hoisted G applies
    bitwise as the apply does, both orientations; f64 hoists nothing and
    keeps its exact product; no operands falls back to the apply."""
    jdt, tdt = DTYPES[dtype]
    n, s, m = 64, 16, 40
    St = T.sketch.FJLT(n, s, T.SketchContext(seed=5))
    A = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(tdt)
    ops = St.hoistable_operands(tdt, "cpu")
    assert ops is not None and ops.dtype == torch.bfloat16 and St._gemm_wins(tdt)
    assert ops is St.hoistable_operands(tdt, "cpu")  # made once per device
    assert torch.equal(St.apply_with_operands(ops, A, "rowwise"), St.apply(A, "rowwise"))
    assert torch.equal(St.apply_with_operands(ops, A.T, "columnwise"),
                       St.apply(A.T, "columnwise"))
    assert torch.equal(St.apply_with_operands(None, A, "rowwise"), St.apply(A, "rowwise"))
    assert St.hoistable_operands(torch.float64, "cpu") is None
    A64 = A.double()
    assert torch.equal(St.apply_with_operands(ops, A64, "rowwise"), St.apply(A64, "rowwise"))
    with pytest.raises(ValueError, match="sketched axis"):
        St.apply_with_operands(ops, A.T.contiguous()[:, :5], "rowwise")


def test_fjlt_gate_off_hoists_nothing_and_takes_the_wht(rng, monkeypatch):
    """Where the gate says no (the knob, or the DCT) no matrix is made and
    the apply is the WHT route's."""
    A = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    St = T.sketch.FJLT(64, 16, T.SketchContext(seed=5))
    gemm = St.apply(A, "rowwise")
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    assert St.hoistable_operands(torch.float32, "cpu") is None
    wht = St.apply(A, "rowwise")
    assert not torch.equal(wht, gemm) and _rel(wht, gemm.numpy()) <= 1e-5
    assert T.sketch.FJLT(64, 16, T.SketchContext(seed=5), fut="dct").hoistable_operands(
        torch.float32, "cpu") is None


# -- Fastfood's realized W ------------------------------------------------------------


FASTFOOD = [("FastGaussianRFT", {"sigma": 1.7}), ("FastMaternRFT", {"nu": 1.5, "l": 0.9})]


@pytest.mark.parametrize("dim", ["rowwise", "columnwise"])
@pytest.mark.parametrize("cls,kw", FASTFOOD)
def test_fastfood_forced_realized_matches_jax(rng, monkeypatch, cls, kw, dim):
    """``tests/test_feature_maps.py::test_realized_matches_streaming``'s
    shapes with ``SKYLARK_FRFT_GEMM=1`` on both sides: the realized apply
    within atol 5e-4 of the JAX package's, and of the port's streaming
    form."""
    n, s, m = 24, 64, 128
    A = rng.standard_normal((m, n)).astype(np.float32)
    arr = A if dim == "rowwise" else A.T
    Sj = getattr(J.sketch, cls)(n, s, J.SketchContext(seed=11), **kw)
    St = getattr(T.sketch, cls)(n, s, T.SketchContext(seed=11), **kw)
    monkeypatch.setenv("SKYLARK_FRFT_GEMM", "1")
    assert St._realize_wins(torch.float32, m) and Sj._realize_wins(jnp.float32, m)
    got = St.apply(torch.from_numpy(arr.copy()), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(Sj.apply(jnp.asarray(arr), dim)),
                               atol=5e-4)
    monkeypatch.setenv("SKYLARK_NO_FRFT_GEMM", "1")
    streamed = St.apply(torch.from_numpy(arr.copy()), dim)
    assert not torch.equal(got, streamed)
    np.testing.assert_allclose(got.numpy(), streamed.numpy(), atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls,kw", FASTFOOD)
def test_fastfood_hoisted_matches_jax_and_is_bitwise_the_forced_apply(rng, monkeypatch, cls,
                                                                       kw, dtype):
    """Hoisted ``(W, shifts)`` with no gate, in both packages: within atol
    5e-4 of the JAX package's hoisted apply (bf16: both round the input and
    W to bf16 and the features once), and bitwise the port's forced
    realized apply, both orientations; f64 hoists nothing."""
    jdt, tdt = DTYPES[dtype]
    n, s, m = 24, 64, 160
    A = rng.standard_normal((m, n)).astype(np.float32)
    Sj = getattr(J.sketch, cls)(n, s, J.SketchContext(seed=19), **kw)
    St = getattr(T.sketch, cls)(n, s, T.SketchContext(seed=19), **kw)
    ops_j, ops_t = Sj.hoistable_operands(jdt), St.hoistable_operands(tdt, "cpu")
    assert ops_t is not None and len(ops_t) == 2 and ops_t[0].dtype == torch.float32
    assert ops_t is St.hoistable_operands(tdt, "cpu")
    np.testing.assert_allclose(ops_t[0].numpy(), np.asarray(ops_j[0]), atol=1e-5, rtol=1e-5)
    At = torch.from_numpy(A).to(tdt)
    got = St.apply_with_operands(ops_t, At, "rowwise")
    want = Sj.apply_with_operands(ops_j, jnp.asarray(A).astype(jdt), "rowwise")
    assert got.dtype == tdt
    np.testing.assert_allclose(got.double().numpy(), _np(want),
                               atol=5e-4 if dtype == "float32" else 2e-2 * St.outscale)
    monkeypatch.setenv("SKYLARK_FRFT_GEMM", "1")
    assert torch.equal(got, St.apply(At, "rowwise"))
    assert torch.equal(St.apply_with_operands(ops_t, At.T, "columnwise"),
                       St.apply(At.T, "columnwise"))
    assert St.hoistable_operands(torch.float64, "cpu") is None
    Ai = torch.from_numpy(np.arange(m * n).reshape(m, n) % 5)
    assert torch.equal(St.apply_with_operands(ops_t, Ai, "rowwise"), St.apply(Ai, "rowwise"))


def test_fastfood_realize_cap_hoists_nothing():
    big = T.sketch.FastGaussianRFT(1 << 13, 1 << 14, T.SketchContext(seed=13), sigma=1.0)
    assert big.numblks * big._nb * big._nb > tfrft._REALIZE_MAX_ELEMENTS
    assert big.hoistable_operands(torch.float32, "cpu") is None


# -- PPT's matmul DFT -----------------------------------------------------------------


@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
def test_ppt_forced_dft_matches_jax(rng, monkeypatch, dim):
    """``tests/test_feature_maps.py::test_bf16_dft_matches_fft`` on both
    sides: the forced DFT within 0.02 of the feature scale of the JAX
    DFT, of the port's bf16 FFT route and of the f64 exact features."""
    monkeypatch.setattr(jppt, "_DFT_MIN_BATCH", 8)
    monkeypatch.setattr(tppt, "_DFT_MIN_BATCH", 8)
    monkeypatch.setenv("SKYLARK_PPT_DFT", "1")
    n, s, m = 24, 16, 64
    A = rng.standard_normal((n, m))
    arr = A if dim == "columnwise" else A.T
    Fj = J.sketch.PPT(n, s, J.SketchContext(seed=7), q=3, c=0.7, gamma=1.3)
    Ft = T.sketch.PPT(n, s, T.SketchContext(seed=7), q=3, c=0.7, gamma=1.3)
    A16 = torch.from_numpy(arr.copy()).bfloat16()
    assert Ft._dft_wins(torch.bfloat16, m)
    got = Ft.apply(A16, dim)
    assert got.dtype == torch.bfloat16
    want = Fj.apply(jnp.asarray(arr).astype(jnp.bfloat16), dim)
    Z64 = Ft.apply(torch.from_numpy(arr.copy()), dim)
    scale = float(Z64.abs().max())
    monkeypatch.setenv("SKYLARK_NO_PPT_DFT", "1")
    fft = Ft.apply(A16, dim)
    for ref in (_np(want), fft.double().numpy(), Z64.numpy()):
        assert np.abs(got.double().numpy() - ref).max() / scale < 0.02
    other = T.sketch.PPT(n, s, T.SketchContext(seed=8), q=3, c=0.7, gamma=1.3).apply(A16, dim)
    assert np.abs(other.double().numpy() - Z64.numpy()).max() / scale > 0.02


# -- the consumers --------------------------------------------------------------------


def test_rowwise_fastfood_plan_matches_jax_and_realizes_w_once(rng, monkeypatch):
    """A rowwise bucketed Fastfood apply (serving's predict, the streaming
    drivers) takes the hoisted W in both packages; the port's plan builds
    W once for all its calls and is bitwise its eager hoisted apply."""
    n, s = 24, 64
    Sj = J.sketch.FastGaussianRFT(n, s, J.SketchContext(seed=31), sigma=2.0)
    St = T.sketch.FastGaussianRFT(n, s, T.SketchContext(seed=31), sigma=2.0)
    built = []
    real = tfrft.FastRFT._realized_w
    monkeypatch.setattr(tfrft.FastRFT, "_realized_w",
                        lambda self, device: built.append(1) or real(self, device))
    T.plans.clear()
    for rows in (8, 5, 8, 13):
        X = rng.standard_normal((rows, n)).astype(np.float32)
        got = T.plans.apply_rowwise_bucketed(St, torch.from_numpy(X))
        want = J.plans.apply_rowwise_bucketed(Sj, jnp.asarray(X))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
        eager = St.apply_with_operands(St.hoistable_operands(torch.float32, "cpu"),
                                       torch.from_numpy(X), "rowwise")
        assert torch.equal(got, eager)
    assert len(built) == 2  # the plans' copy of the sketch, and St itself


def test_rowwise_fjlt_plan_takes_the_hoisted_g_once(rng, monkeypatch):
    n, s = 64, 16
    St = T.sketch.FJLT(n, s, T.SketchContext(seed=32))
    Sj = J.sketch.FJLT(n, s, J.SketchContext(seed=32))
    built = []
    real = tfjlt.FJLT._srht_matrix
    monkeypatch.setattr(tfjlt.FJLT, "_srht_matrix",
                        lambda self, *a, **k: built.append(1) or real(self, *a, **k))
    T.plans.clear()
    for rows in (8, 8, 3):
        X = rng.standard_normal((rows, n)).astype(np.float32)
        got = T.plans.apply_rowwise_bucketed(St, torch.from_numpy(X))
        want = J.plans.apply_rowwise_bucketed(Sj, jnp.asarray(X))
        assert _rel(got, np.asarray(want)) <= 1e-5
    assert len(built) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_krr_on_fastfood_matches_jax(rng, monkeypatch, dtype):
    """Streaming KRR on Fastfood features (``use_fast``): both packages
    realize each chunk's W once and stream the panels through it.  W
    within 1e-4 (f32 features) and 5e-3 (bf16, the bound
    ``tests/test_torch_streaming_solvers.py`` sets for bf16 features) of
    the JAX package's; the port builds W once per feature chunk, not per
    panel or pass."""
    jdt, tdt = DTYPES[dtype]
    n, d, br, s, split = 384, 6, 96, 64, 32
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = np.sin(X.sum(1)).astype(np.float32)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    built = []
    real = tfrft.FastRFT._realized_w
    monkeypatch.setattr(tfrft.FastRFT, "_realized_w",
                        lambda self, device: built.append(1) or real(self, device))
    kp = dict(use_fast=True, max_split=split, iter_lim=3, tolerance=0.0)
    mj = J.ml.streaming_kernel_ridge(
        J.ml.GaussianKernel(d, 2.0), lambda st, rows: jax.lax.dynamic_slice_in_dim(Xj, st, rows),
        (n, d), Y, 0.5, s, J.SketchContext(seed=4), J.ml.KrrParams(**kp), block_rows=br,
        feature_dtype=jdt)
    mt = T.ml.streaming_kernel_ridge(
        T.ml.GaussianKernel(d, 2.0), lambda st, rows: Xt[st:st + rows], (n, d),
        torch.from_numpy(Y), 0.5, s, T.SketchContext(seed=4), T.ml.KrrParams(**kp),
        block_rows=br, feature_dtype=tdt)
    assert all(isinstance(S, T.sketch.FastGaussianRFT) for S in mt.maps)
    assert len(built) == len(mt.maps) > 1
    assert _rel(mt.W, np.asarray(mj.W)) <= (1e-4 if dtype == "float32" else 5e-3)


# -- mm_f32 ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_mm_f32_cpu_twin_is_the_lift(rng, dtype):
    a = torch.from_numpy(rng.standard_normal((37, 64))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((64, 21))).to(dtype)
    out = mm_f32(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())
    assert torch.equal(mm_f32(b.T, a.T), b.T.float() @ a.T.float())
    a3, b3 = a.reshape(1, 37, 64).repeat(3, 1, 1), b.reshape(1, 64, 21).repeat(3, 1, 1)
    assert torch.equal(mm_f32(a3, b3), a3.float() @ b3.float())
    with pytest.raises(TypeError, match="bf16 or two f16"):
        mm_f32(a.float(), b.float())
    with pytest.raises(TypeError):
        mm_f32(a, b.float())
