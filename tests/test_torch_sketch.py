"""Port vs JAX package: FJLT and the hash sketches, dense apply, and the
sketch JSON interchange.  Every sketch is built by the JAX package and
loaded in the port from its JSON, so each test also pins that a
JAX-written sketch realizes the same function in the port.

Routes.  With ``SKYLARK_NO_SRHT_GEMM=1`` the JAX FJLT takes the
WHT-plus-gather route the port takes, and the two agree to 1e-5
relative (summation order only).  By default the JAX package prices
its subsampled-Hadamard GEMM for TPU MXU rates and takes it at these
sizes; that route forms the same sampled transform as a three-part
bf16-split matmul, so the two agree to f32 rounding of different sums:
1e-5 relative as well, checked separately.  The hash sketches take the
same branch in both packages (one-hot matmul at batch ≥ 16 and N·S ≤
2^27, else the row scatter) and agree to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

TOL = 1e-5


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _pair(stype, n, s, seed=5, **params):
    Sj = J.sketch.create_sketch(stype, n, s, J.SketchContext(seed=seed), **params)
    St = T.sketch.from_json(Sj.to_json())
    return Sj, St


@pytest.fixture
def no_srht_gemm(monkeypatch):
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")


FJLT_CASES = [
    (512, 128, (32, 512), "rowwise"),       # fused sampled route
    (512, 100, (16, 512), "rowwise"),       # rfut_rowwise + lane gather
    (300, 128, (300, 20), "columnwise"),    # transposed fused route, padded N
    (300, 100, (300, 1), "columnwise"),     # a vector b
    (40000, 64, (40000, 3), "columnwise"),  # NB = 2^16: torch WHT + gather
    (40000, 64, (2, 40000), "rowwise"),     # NB = 2^16 rowwise lane select
    (100, 16, (100, 6), "columnwise"),      # NB = 128 < 512: plain RFUT
]


@pytest.mark.parametrize("n,s,shape,dim", FJLT_CASES)
def test_fjlt_matches_jax_same_route(rng, no_srht_gemm, n, s, shape, dim):
    A = rng.standard_normal(shape).astype(np.float32)
    Sj, St = _pair("FJLT", n, s)
    out = St.apply(torch.from_numpy(A), dim)
    assert out.dtype == torch.float32
    assert _rel(out, Sj.apply(jnp.asarray(A), dim)) <= TOL


@pytest.mark.parametrize("n,s,shape,dim", FJLT_CASES[:4])
def test_fjlt_matches_jax_srht_gemm_route(rng, n, s, shape, dim):
    A = rng.standard_normal(shape).astype(np.float32)
    Sj, St = _pair("FJLT", n, s)
    assert Sj._gemm_wins(jnp.float32)  # the JAX package takes its GEMM route
    assert _rel(St.apply(torch.from_numpy(A), dim),
                Sj.apply(jnp.asarray(A), dim)) <= TOL


def test_fjlt_bf16_and_vector(rng, no_srht_gemm):
    A = rng.standard_normal((16, 512)).astype(np.float32)
    Sj, St = _pair("FJLT", 512, 128)
    out = St.apply(torch.from_numpy(A).bfloat16(), "rowwise")
    assert out.dtype == torch.bfloat16
    ref = Sj.apply(jnp.asarray(A, jnp.bfloat16), "rowwise")
    assert _rel(out.float(), np.asarray(ref, np.float32)) <= 2e-2
    x = rng.standard_normal(512).astype(np.float32)
    assert _rel(St.apply(torch.from_numpy(x), "columnwise"),
                Sj.apply(jnp.asarray(x), "columnwise")) <= TOL


HASH_CASES = [
    ("CWT", {}, (500, 20), "columnwise"),   # one-hot matmul
    ("CWT", {}, (500, 3), "columnwise"),    # row scatter
    ("CWT", {}, (4, 500), "rowwise"),       # row scatter, transposed
    ("SJLT", {"nnz": 4}, (500, 20), "columnwise"),
    ("SJLT", {"nnz": 4}, (7, 500), "rowwise"),
    ("SJLT", {"nnz": 3}, (500, 2), "columnwise"),
    ("MMT", {}, (500, 20), "columnwise"),   # scaled one-hot
    ("MMT", {}, (3, 500), "rowwise"),
    ("WZT", {"p": 1.5}, (20, 500), "rowwise"),
    ("WZT", {}, (500, 2), "columnwise"),
]


@pytest.mark.parametrize("stype,params,shape,dim", HASH_CASES)
def test_hash_matches_jax(rng, stype, params, shape, dim):
    A = rng.standard_normal(shape).astype(np.float32)
    Sj, St = _pair(stype, 500, 40, **params)
    out = St.apply(torch.from_numpy(A), dim)
    assert out.dtype == torch.float32
    assert _rel(out, Sj.apply(jnp.asarray(A), dim)) <= TOL


@pytest.mark.parametrize("shape,dim", [((500, 20), "columnwise"), ((500, 3), "columnwise")])
def test_hash_f64_and_bf16(rng, shape, dim):
    A = rng.standard_normal(shape)
    Sj, St = _pair("CWT", 500, 40)
    out = St.apply(torch.from_numpy(A), dim)
    assert out.dtype == torch.float64
    assert _rel(out, Sj.apply(jnp.asarray(A), dim)) <= 1e-12
    A16 = A.astype(np.float32)
    out = St.apply(torch.from_numpy(A16).bfloat16(), dim)
    ref = Sj.apply(jnp.asarray(A16, jnp.bfloat16), dim)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float(), np.asarray(ref, np.float32)) <= 1e-2


@pytest.mark.parametrize("stype,params", [
    ("FJLT", {}), ("CWT", {}), ("SJLT", {"nnz": 2}), ("MMT", {}),
    ("WZT", {"p": 1.25}), ("UST", {"replace": False}), ("UST", {}),
])
def test_json_roundtrip_realizes_same_bits(stype, params):
    Sj, St = _pair(stype, 300, 40, seed=123456789, **params)
    assert St.to_json() == Sj.to_json()
    assert T.sketch.from_json(St.to_json()).to_json() == Sj.to_json()
    if stype == "FJLT":
        np.testing.assert_array_equal(St.sample_indices("cpu").numpy(),
                                      np.asarray(Sj.sample_indices))
        np.testing.assert_array_equal(
            St._rfut.diagonal(torch.float32, "cpu").numpy(),
            np.asarray(Sj._rfut.diagonal(jnp.float32)))
    elif stype == "UST":
        np.testing.assert_array_equal(St.samples("cpu").numpy(),
                                      np.asarray(Sj.samples))
    else:
        np.testing.assert_array_equal(St.buckets(device="cpu").numpy(),
                                      np.asarray(Sj.buckets()))
        vt = St.values(torch.float32, device="cpu").numpy()
        vj = np.asarray(Sj.values(jnp.float32))
        if stype in ("CWT", "SJLT"):
            np.testing.assert_array_equal(vt, vj)
        else:  # transcendental values: cauchy / reciprocal exponential
            np.testing.assert_allclose(vt, vj, rtol=8 * np.finfo(np.float32).eps)


def test_ust_apply_matches_jax(rng):
    A = rng.standard_normal((300, 4)).astype(np.float32)
    for replace in (True, False):
        Sj, St = _pair("UST", 300, 40, replace=replace)
        np.testing.assert_array_equal(St.apply(torch.from_numpy(A)).numpy(),
                                      np.asarray(Sj.apply(jnp.asarray(A))))
        np.testing.assert_array_equal(
            St.apply(torch.from_numpy(A.T.copy()), "rowwise").numpy(),
            np.asarray(Sj.apply(jnp.asarray(A.T), "rowwise")))


def test_wht_matches_jax_and_is_orthonormal(rng):
    x = rng.standard_normal((3, 1 << 9, 2)).astype(np.float32)
    out = T.sketch.wht(torch.from_numpy(x), axis=1)
    assert _rel(out, J.sketch.wht(jnp.asarray(x), axis=1)) <= TOL
    np.testing.assert_allclose(out.norm().item(), np.linalg.norm(x), rtol=1e-5)
    with pytest.raises(ValueError):
        T.sketch.wht(torch.zeros(6))


def test_unported_inputs_raise():
    St = T.sketch.CWT(50, 8, T.SketchContext(seed=1))
    with pytest.raises(UnsupportedError):
        St.apply(torch.eye(50).to_sparse_csr())
    with pytest.raises(NotImplementedError):
        T.sketch.FJLT(50, 8, T.SketchContext(), fut="dct")
    with pytest.raises(ValueError):
        St.apply(torch.zeros(49, 3))
    with pytest.raises(ValueError):
        T.sketch.create_sketch("nope", 3, 2, T.SketchContext())


def test_sketch_reserves_like_jax():
    for stype, params in (("FJLT", {}), ("SJLT", {"nnz": 3}), ("WZT", {})):
        cj, ct = J.SketchContext(seed=2), T.SketchContext(seed=2)
        J.sketch.create_sketch(stype, 77, 10, cj, **params)
        T.sketch.create_sketch(stype, 77, 10, ct, **params)
        assert ct.counter == cj.counter
