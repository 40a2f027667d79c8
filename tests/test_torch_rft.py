"""Port vs JAX package: the random feature maps — RFT (Gaussian,
Laplacian, Matérn), Fastfood (``sketch/frft.py``), the exp-semigroup RLT
and PPT — and their JSON.

Every map is built by the JAX package and loaded in the port from its
JSON, then fed the same numpy input.  Tolerances:

- f64 features: 1e-10 absolute.
- f32 features of the Gaussian, Matérn, Fastfood, RLT and PPT maps:
  2e-5 absolute on Z / outscale (the cosine or exponential itself).  The
  W·X sums run in other orders, and XLA contracts the Matérn epilogue's
  ``WX·scales + shifts`` into an FMA where the port rounds twice: both
  are far below this.
- Laplacian (Cauchy W), and Matérn at ν = 1/2, whose row scales
  sqrt(1/χ²₁) are Cauchy-tailed too (up to 64 at S = 128): an f32 ulp of
  a large cosine argument moves the cosine by far more than 2e-5 between
  any two correct summation orders (at a W·X entry near 10^6, by
  O(1e-2)).  So their f32 is held on W·X, 1e-5 of each row's largest
  magnitude, with the scales as below, and their features elementwise
  only in f64.
- Shifts (uniform draws) bitwise; Matérn scales within the normal draws'
  few ulp (chi2 of ν = 1.5: 3 lanes).

The JAX package's Fastfood returns f64 for f32 input when x64 is on (a
numpy f64 ``outscale``); the port keeps the input's dtype, and the f32
comparison reads the JAX values at f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T

F64_ATOL = 1e-10
F32_ATOL = 2e-5
WX_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]

MAPS = [
    ("GaussianRFT", {"sigma": 1.5}),
    ("LaplacianRFT", {"sigma": 2.0}),
    ("MaternRFT", {"nu": 1.5, "l": 1.2}),
    ("MaternRFT", {"nu": 0.5, "l": 0.7}),
    ("FastGaussianRFT", {"sigma": 1.3}),
    ("FastMaternRFT", {"nu": 2.5, "l": 0.8}),
    ("ExpSemigroupRLT", {"beta": 0.5}),
    ("PPT", {"q": 3, "c": 1.0, "gamma": 0.5}),
    ("PPT", {"q": 1, "c": 0.3, "gamma": 2.0}),
]
HEAVY_TAILED = {("LaplacianRFT", 2.0), ("MaternRFT", 0.5)}
# (N, S): small widths, S not a multiple of N's block; S > NB gives
# Fastfood two blocks.
SIZES = [(24, 40), (64, 128), (13, 20)]


def _pair(stype, n, s, seed=3, **params):
    Sj = J.sketch.create_sketch(stype, n, s, J.SketchContext(seed=seed), **params)
    return Sj, T.sketch.from_json(Sj.to_json())


def _input(rng, shape, dtype):
    """Non-negative (the RLT needs histograms), O(1)-norm rows."""
    return (np.abs(rng.standard_normal(shape)) / np.sqrt(shape[-1])).astype(dtype)


def _outscale(St):
    return getattr(St, "outscale", 1.0)


def _heavy_tailed(St):
    return (St.sketch_type, getattr(St, "sigma", getattr(St, "nu", None))) in HEAVY_TAILED


def _check_features(stype, Sj, St, A, dim, dtype):
    ref = np.asarray(Sj.apply(jnp.asarray(A), dim), np.float64)
    out = St.apply(torch.from_numpy(A), dim)
    assert out.dtype == torch.from_numpy(A).dtype
    out = out.double().numpy()
    assert out.shape == ref.shape
    if dtype == np.float64:
        assert np.abs(out - ref).max() <= F64_ATOL
    elif not _heavy_tailed(St):
        assert np.abs(out - ref).max() / _outscale(St) <= F32_ATOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", ["rowwise", "columnwise"])
@pytest.mark.parametrize("n,s", SIZES)
@pytest.mark.parametrize("stype,params", MAPS, ids=lambda v: str(v))
def test_features_match_jax(rng, stype, params, n, s, dim, dtype):
    Sj, St = _pair(stype, n, s, **params)
    A = _input(rng, (9, n) if dim == "rowwise" else (n, 9), dtype)
    _check_features(stype, Sj, St, A, dim, dtype)


@pytest.mark.parametrize("dim", ["rowwise", "columnwise"])
@pytest.mark.parametrize("stype,params", [MAPS[0], MAPS[4], MAPS[6], MAPS[7]],
                         ids=lambda v: str(v))
def test_vector_input_matches_jax(rng, stype, params, dim):
    Sj, St = _pair(stype, 20, 36, **params)
    _check_features(stype, Sj, St, _input(rng, (20,), np.float64), dim, np.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stype,params", MAPS[:4], ids=lambda v: str(v))
def test_wx_matches_jax(rng, stype, params, dtype):
    """The linear half W·X of the RFTs (the Laplacian's f32 contract)."""
    Sj, St = _pair(stype, 48, 64, **params)
    A = rng.standard_normal((7, 48)).astype(dtype)
    ref = np.asarray(Sj._underlying.apply(jnp.asarray(A), "rowwise"), np.float64)
    out = St._underlying.apply(torch.from_numpy(A), "rowwise").double().numpy()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert (np.abs(out - ref) / scale).max() <= WX_RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_shifts_bitwise_and_matern_scales(dtype):
    Sj, St = _pair("MaternRFT", 10, 300, seed=44, nu=1.5, l=2.0)
    td = torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_array_equal(St.shifts(td, "cpu").numpy(), np.asarray(Sj.shifts(dtype)))
    a = np.asarray(Sj.scales(dtype), np.float64)
    b = St.scales(td, "cpu").double().numpy()
    assert (np.abs(b - a) / a).max() <= 16 * np.finfo(dtype).eps
    # Memoized per dtype and device.
    assert St.scales(td, "cpu") is St.scales(td, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", ["rowwise", "columnwise"])
@pytest.mark.parametrize("stype,params", [MAPS[4], MAPS[5]], ids=lambda v: str(v))
def test_fastfood_kernel_route_matches_jax(rng, stype, params, dim, dtype):
    """NB = 512 takes the RFUT-kernel route for f32 (its plain version on
    the CPU) and the streaming form for f64; S = 600 is two blocks, the
    second cut to 88 features."""
    Sj, St = _pair(stype, 300, 600, **params)
    A = _input(rng, (5, 300) if dim == "rowwise" else (300, 5), dtype)
    _check_features(stype, Sj, St, A, dim, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fastfood_tied_keys_stable_permutation(rng, dtype):
    """At NB = 1024 and seed 11 two of the 24-bit permutation keys tie;
    ``jnp.argsort`` is stable, and the port's Π must be the same one."""
    Sj, St = _pair("FastGaussianRFT", 1000, 64, seed=11, sigma=3.0)
    keys = St._blocks("uniform", St._p_base, torch.float32, "cpu")[0]
    assert keys.unique().numel() < keys.numel()
    np.testing.assert_array_equal(St._perms("cpu").numpy(), np.asarray(Sj._perms()))
    _check_features("FastGaussianRFT", Sj, St, _input(rng, (3, 1000), dtype), "rowwise", dtype)


def test_fastfood_routes_agree(rng):
    """The RFUT-kernel route and the streaming form are the same map."""
    _, St = _pair("FastMaternRFT", 300, 600, nu=1.5, l=1.0)
    X = torch.from_numpy(_input(rng, (4, 300), np.float32))
    kernel = St._features_rowwise(X)
    streaming = St._features(X.T).T
    torch.testing.assert_close(kernel, streaming, rtol=0, atol=1e-5 * float(streaming.abs().max()))


@pytest.mark.parametrize("stype,params", MAPS, ids=lambda v: str(v))
def test_json_identical_and_rebuilds(rng, stype, params):
    Sj, St = _pair(stype, 17, 33, seed=123, **params)
    assert St.to_dict() == Sj.to_dict()
    Tn = T.sketch.create_sketch(stype, 17, 33, T.SketchContext(seed=123), **params)
    assert Tn.to_dict() == Sj.to_dict()
    A = torch.from_numpy(_input(rng, (4, 17), np.float64))
    assert torch.equal(Tn.apply(A, "rowwise"), T.sketch.from_json(Tn.to_json()).apply(A, "rowwise"))


def test_bad_parameters():
    with pytest.raises(ValueError, match="2\\*nu"):
        T.sketch.MaternRFT(6, 64, T.SketchContext(seed=4), nu=0.7)
    with pytest.raises(ValueError, match="2\\*nu"):
        T.sketch.FastMaternRFT(6, 64, T.SketchContext(seed=4), nu=0.3)
    with pytest.raises(ValueError):
        T.sketch.PPT(6, 64, T.SketchContext(seed=4), q=0)
    F = T.sketch.GaussianRFT(6, 8, T.SketchContext(seed=4))
    with pytest.raises(ValueError):
        F.apply(torch.zeros(3, 5), "rowwise")
