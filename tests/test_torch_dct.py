"""Port vs JAX package: the orthonormal DCT-II (``sketch/fut.py``) and the
DCT backend of RFUT and FJLT.

``dct`` is one complex FFT of the even/odd reordering (torch has no
DCT); the JAX package calls ``jax.scipy.fft.dct(type=2, norm="ortho")``.
Tolerances relative to the largest magnitude: f64 1e-12, f32 1e-5 (FFT
rounding in another order).  bf16 input is computed in f32 by both
packages and returned as f32, the JAX package's dtype for it.

FJLT with ``fut="dct"`` must never take the fused WHT kernels: on CPU
tensors their plain versions stand in for them, so the test counts those
calls (none) and holds the result against the JAX package, which gates
that route on the WHT too.
"""

import jax.numpy as jnp
import jax.scipy.fft as jfft
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu_torch.sketch import kernels_fut, kernels_window

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _rel(out, ref):
    out = np.asarray(out.double() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_dct_matches_jax(rng, n, axis):
    shape = [3, 4, 5]
    shape[axis] = n
    x = rng.standard_normal(shape)
    for dtype in (np.float64, np.float32):
        out = T.sketch.dct(torch.from_numpy(x.astype(dtype)), axis=axis)
        ref = jfft.dct(jnp.asarray(x.astype(dtype)), type=2, norm="ortho", axis=axis)
        assert str(out.dtype) == f"torch.{np.asarray(ref).dtype}"
        assert _rel(out, ref) <= TOL[dtype]
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    out = T.sketch.dct(xb, axis=axis)
    ref = jfft.dct(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), type=2,
                   norm="ortho", axis=axis)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(out, ref) <= TOL[np.float32]


def test_dct_is_orthonormal_and_dtypes_follow_jax(rng):
    x = torch.from_numpy(rng.standard_normal((257, 3)))
    y = T.sketch.dct(x)
    assert torch.allclose(y.norm(dim=0), x.norm(dim=0), rtol=1e-13)
    for dt in (torch.float16, torch.int32):
        ref = jfft.dct(jnp.ones((4, 2), {torch.float16: jnp.float16, torch.int32: jnp.int32}[dt]),
                       type=2, norm="ortho", axis=0)
        assert T.sketch.dct(torch.ones(4, 2, dtype=dt)).dtype == torch.float32
        assert ref.dtype == jnp.float32


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [300, 512])
def test_rfut_dct_matches_jax(rng, n, dtype):
    ctx_j, ctx_t = J.SketchContext(seed=21), T.SketchContext(seed=21)
    Rj = J.sketch.RFUT(n, ctx_j, fut="dct")
    Rt = T.sketch.RFUT(n, ctx_t, fut="dct")
    assert Rt.s == Rj.s == n and ctx_t.counter == ctx_j.counter == n
    assert Rt.to_json() == Rj.to_json()
    A = rng.standard_normal((n, 6)).astype(dtype)
    for X, dim in ((A, "columnwise"), (A.T.copy(), "rowwise"), (A[:, 0].copy(), "columnwise")):
        out = Rt.apply(torch.from_numpy(X), dim)
        assert _rel(out, Rj.apply(jnp.asarray(X), dim)) <= TOL[dtype]


@pytest.fixture
def wht_calls(monkeypatch):
    """Counts the calls of the fused WHT kernels' wrappers (their plain
    versions on CPU tensors) and of the gather epilogue."""
    calls = {"rfut_rowwise": 0, "rfut_rowwise_sampled": 0, "gather_scaled_rows": 0}
    for mod, name in ((kernels_fut, "rfut_rowwise"), (kernels_fut, "rfut_rowwise_sampled"),
                      (kernels_window, "gather_scaled_rows")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,s", [(512, 128), (300, 40)])
def test_fjlt_dct_matches_jax_and_takes_no_wht_kernel(rng, wht_calls, n, s, dtype):
    Sj = J.sketch.FJLT(n, s, J.SketchContext(seed=8), fut="dct")
    St = T.sketch.deserialize_sketch(Sj.serialize())
    assert St.to_json() == Sj.to_json() and St._nb == n
    A = rng.standard_normal((n, 9)).astype(dtype)
    for X, dim in ((A, "columnwise"), (A.T.copy(), "rowwise"), (A[:, 0].copy(), "columnwise")):
        out = St.apply(torch.from_numpy(X), dim)
        assert _rel(out, Sj.apply(jnp.asarray(X), dim)) <= TOL[dtype]
    assert wht_calls["rfut_rowwise"] == wht_calls["rfut_rowwise_sampled"] == 0
    # The 2-D columnwise f32 apply ends in the gather kernel, as on the TPU.
    assert wht_calls["gather_scaled_rows"] == (1 if dtype == np.float32 else 0)


def test_fjlt_wht_takes_the_fused_kernels_control(rng, wht_calls):
    """The control of the test above: the same shape with the WHT takes the
    fused sampled kernel, so the counts can see a WHT route."""
    S = T.sketch.FJLT(512, 128, T.SketchContext(seed=8))
    S.apply(torch.from_numpy(rng.standard_normal((512, 9)).astype(np.float32)))
    assert wht_calls["rfut_rowwise_sampled"] == 1


def test_fjlt_dct_bf16_returns_the_jax_dtype(rng):
    Sj = J.sketch.FJLT(256, 128, J.SketchContext(seed=3), fut="dct")
    St = T.sketch.from_json(Sj.to_json())
    A = torch.from_numpy(rng.standard_normal((256, 4)).astype(np.float32)).bfloat16()
    out = St.apply(A)
    ref = Sj.apply(jnp.asarray(A.float().numpy()).astype(jnp.bfloat16))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(out, ref) <= TOL[np.float32]
