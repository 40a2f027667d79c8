"""Port vs JAX package: the dense sketches JLT and CT and their engine
(``sketch/dense.py``), ``chi2_lanes``, and the dense sketch JSON.

Each sketch is built by the JAX package and loaded in the port from its
JSON.  Tolerances (stated once, used below):

- Omega windows: the counter contract's, in units of the dtype's
  epsilon relative to each entry: normal 4 + 1 (Box-Muller's three
  rounded transcendentals, then the scale), Cauchy 1 + 1, Lévy 8 + 1.
  A window is bitwise the same slice of the full matrix.
- W·X: 1e-5 relative in f32 and 1e-12 in f64, each row of the result
  against that row's largest magnitude (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.core import random as jrand
from libskylark_tpu.sketch import dense as jdense
from libskylark_tpu_torch.core import random as trand
from libskylark_tpu_torch.sketch import dense as tdense
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

WX_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
EPS_UNITS = {"normal": 5, "cauchy": 2, "levy": 9}
DTYPES = [np.float32, np.float64]


def _pair(stype, n, s, seed=5, **params):
    Sj = J.sketch.create_sketch(stype, n, s, J.SketchContext(seed=seed), **params)
    return Sj, T.sketch.from_json(Sj.to_json())


def _row_rel(out, ref, axis):
    """Largest |out - ref| over the largest |ref| of the same row (rows
    along ``axis`` of the sketched output)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    scale = np.maximum(np.abs(ref).max(axis=axis, keepdims=True), 1e-300)
    return float((np.abs(out - ref) / scale).max())


def _eps_units(out, ref, dtype):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    same = out == ref
    with np.errstate(divide="ignore", invalid="ignore"):
        err = np.abs(out - ref) / (np.abs(ref) * np.finfo(dtype).eps)
    return float(np.where(same, 0.0, err).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stype,dist,params", [
    ("JLT", "normal", {}), ("CT", "cauchy", {"C": 3.0}),
])
def test_realize_matches_jax(stype, dist, params, dtype):
    Sj, St = _pair(stype, 48, 40, **params)
    a = np.asarray(Sj.realize(dtype))
    b = St.realize(torch.from_numpy(np.zeros(0, dtype)).dtype, device="cpu").numpy()
    assert b.dtype == a.dtype and b.shape == (40, 48)
    assert _eps_units(b, a, dtype) <= EPS_UNITS[dist]


@pytest.mark.parametrize("dtype", DTYPES)
def test_levy_realize_matches_jax(dtype):
    Fj = J.sketch.ExpSemigroupRLT(30, 20, J.SketchContext(seed=8), beta=0.7)
    Ft = T.sketch.from_json(Fj.to_json())
    td = torch.from_numpy(np.zeros(0, dtype)).dtype
    a = np.asarray(Fj._underlying.realize(dtype))
    b = Ft._underlying.realize(td, device="cpu").numpy()
    assert _eps_units(b, a, dtype) <= EPS_UNITS["levy"]


def test_window_is_slice_of_full_bitwise():
    _, St = _pair("JLT", 50, 30)
    full = St.realize(torch.float32, device="cpu")
    win = St.realize(torch.float32, offset=(7, 11), shape=(9, 23), device="cpu")
    assert torch.equal(win, full[7:16, 11:34])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
@pytest.mark.parametrize("stype,params", [("JLT", {}), ("CT", {"C": 2.0})])
def test_apply_matches_jax(rng, stype, params, dim, dtype):
    n, s, m = 64, 24, 9
    Sj, St = _pair(stype, n, s, **params)
    A = rng.standard_normal((n, m) if dim == "columnwise" else (m, n)).astype(dtype)
    ref = np.asarray(Sj.apply(jnp.asarray(A), dim))
    out = St.apply(torch.from_numpy(A), dim)
    assert out.dtype == torch.from_numpy(A).dtype
    assert _row_rel(out.numpy(), ref, axis=0 if dim == "columnwise" else 1) \
        <= WX_RTOL[dtype]


@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
def test_vector_and_int_inputs(rng, dim):
    """1-D vectors sketch as columns columnwise and rows rowwise; integer
    input runs in f32, as in the JAX package."""
    Sj, St = _pair("JLT", 32, 8)
    x = rng.integers(-5, 5, 32).astype(np.int32)
    ref = np.asarray(Sj.apply(jnp.asarray(x), dim))
    out = St.apply(torch.from_numpy(x), dim)
    assert out.dtype == torch.float32 and out.shape == (8,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
def test_panel_blocked_apply_matches_jax(rng, monkeypatch, dim, dtype):
    """Above MAX_REALIZE_ELEMENTS both packages accumulate over column
    panels of Omega (patched small on both sides: 7 panels of 8 columns
    and a ragged one of 4 at S = 10), and agree with each other and with
    the one-shot apply."""
    n, s, m = 60, 10, 5
    Sj, St = _pair("JLT", n, s)
    A = rng.standard_normal((n, m) if dim == "columnwise" else (m, n)).astype(dtype)
    once = St.apply(torch.from_numpy(A), dim).numpy()
    monkeypatch.setattr(jdense, "MAX_REALIZE_ELEMENTS", 80)
    monkeypatch.setattr(tdense, "MAX_REALIZE_ELEMENTS", 80)
    ref = np.asarray(Sj.apply(jnp.asarray(A), dim))
    out = St.apply(torch.from_numpy(A), dim).numpy()
    axis = 0 if dim == "columnwise" else 1
    assert _row_rel(out, ref, axis) <= WX_RTOL[dtype]
    assert _row_rel(out, once, axis) <= WX_RTOL[dtype]
    assert St.hoistable_operands(torch.float32, device="cpu") is None


def test_sparse_input_dense_result(rng):
    """A sparse COO input (uncoalesced, a duplicate coordinate) gives the
    dense apply's result; above the limit it raises, as in the JAX
    package."""
    n, s, m = 40, 12, 6
    _, St = _pair("JLT", n, s)
    rows = np.array([0, 3, 3, 17, 39, 22, 3])
    cols = np.array([1, 0, 0, 5, 2, 4, 5])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = np.zeros((n, m), np.float32)
    np.add.at(A, (rows, cols), vals)
    coo = T.utils.coo_from_bcoo_arrays(vals, np.stack([rows, cols], 1), (n, m), device="cpu")
    dense_ref = St.apply(torch.from_numpy(A), "columnwise")
    torch.testing.assert_close(St.apply(coo, "columnwise"), dense_ref, rtol=1e-5, atol=1e-6)
    cooT = T.utils.coo_from_bcoo_arrays(vals, np.stack([cols, rows], 1), (m, n), device="cpu")
    torch.testing.assert_close(St.apply(cooT, "rowwise"), dense_ref.T, rtol=1e-5, atol=1e-6)
    big = T.sketch.JLT(1 << 14, 1 << 14, T.SketchContext(seed=1))
    coo_big = T.utils.coo_from_bcoo_arrays(np.ones(1, np.float32), np.array([[3, 0]]),
                                           (1 << 14, 2), device="cpu")
    with pytest.raises(UnsupportedError):
        big.apply(coo_big, "columnwise")


def test_hoisted_operands_bitwise_and_memoized(rng):
    _, St = _pair("CT", 20, 16)
    ops = St.hoistable_operands(torch.float32, device="cpu")
    assert ops is St.hoistable_operands(torch.float32, device="cpu")
    A = torch.from_numpy(rng.standard_normal((5, 20)).astype(np.float32))
    assert torch.equal(St.apply_with_operands(ops, A, "rowwise"), St.apply(A, "rowwise"))
    # A hoisted Omega of another dtype is realized again, never converted.
    A64 = A.double()
    assert torch.equal(St.apply_with_operands(ops, A64, "rowwise"), St.apply(A64, "rowwise"))


def test_shape_errors():
    _, St = _pair("JLT", 10, 4)
    with pytest.raises(ValueError):
        St.apply(torch.zeros(9, 3), "columnwise")
    with pytest.raises(ValueError):
        St.apply(torch.zeros(3, 9), "rowwise")


@pytest.mark.parametrize("stype,params", [("JLT", {}), ("CT", {"C": 0.25})])
def test_json_identical(stype, params):
    Sj, St = _pair(stype, 33, 7, seed=91, **params)
    assert St.to_dict() == Sj.to_dict()
    Tn = T.sketch.create_sketch(stype, 33, 7, T.SketchContext(seed=91), **params)
    assert Tn.to_dict() == Sj.to_dict()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dof", [1, 3, 5])
def test_chi2_lanes_matches_jax(dof, dtype):
    """Lanes 1..dof summed in lane order: each partial sum of squares
    carries the normal draws' few-ulp difference, no more."""
    base = (1 << 32) - 17
    a = np.asarray(jrand.chi2_lanes(29, base, 3000, dof, dtype))
    td = torch.from_numpy(np.zeros(0, dtype)).dtype
    b = trand.chi2_lanes(29, base, 3000, dof, td, device="cpu").numpy()
    assert b.dtype == a.dtype
    assert _eps_units(b, a, dtype) <= 2 * EPS_UNITS["normal"]
    with pytest.raises(ValueError):
        trand.chi2_lanes(1, 0, 4, 0, device="cpu")
    with pytest.raises(ValueError):
        trand.chi2_lanes(1, 0, 4, 1.5, device="cpu")
