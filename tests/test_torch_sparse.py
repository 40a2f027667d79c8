"""Port vs JAX package: hash sketches of sparse input.

Each matrix is made from a seed with numpy and handed to the JAX
package as a BCOO and to the port as the sparse COO tensor
``coo_from_bcoo_arrays`` builds from the same arrays; each sketch is
built by the JAX package and loaded in the port from its JSON.

Routes and tolerances.  The JAX side runs its default CPU route, XLA's
``segment_sum`` (the Pallas kernel is held against the port's segment
sum in ``tests/test_torch_scatter.py``), except where a test forces the
kernel in interpret mode.  f32: 1e-5 relative (sums in another order).
f64: 1e-12 (both packages keep f64 sums; MMT/WZT values agree to a few
ulp).  bf16: 1e-2 (the products round to bf16 alike; JAX adds in bf16,
the port in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu_torch.utils import coo_from_bcoo_arrays
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

N, M, S, NNZ = 300, 40, 64, 2000
SKETCHES = [("CWT", {}), ("SJLT", {"nnz": 4}), ("MMT", {}), ("WZT", {})]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
       torch.bfloat16: jnp.bfloat16}


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _pair(stype, n, params, seed=7):
    Sj = J.sketch.create_sketch(stype, n, S, J.SketchContext(seed=seed), **params)
    return Sj, T.sketch.from_json(Sj.to_json())


def _arrays(rng, shape, nnz, dtype=np.float32, duplicates=False):
    idx = np.stack([rng.integers(0, d, nnz) for d in shape], axis=1).astype(np.int32)
    if duplicates:  # every tenth entry repeats an earlier coordinate
        idx[::10] = idx[1::10][: idx[::10].shape[0]]
    return rng.standard_normal(nnz).astype(dtype), idx


def _both(data, idx, shape, tdtype=torch.float32):
    Aj = jsparse.BCOO((jnp.asarray(data, JDT[tdtype]), jnp.asarray(idx)), shape=shape)
    At = coo_from_bcoo_arrays(data, idx, shape, device="cpu").to(tdtype)
    return Aj, At


def _dense(x):
    if isinstance(x, jsparse.BCOO):
        return np.asarray(x.todense().astype(jnp.float64))
    if isinstance(x, torch.Tensor) and x.layout == torch.sparse_coo:
        x = x.to_dense()
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x.astype(jnp.float64))


@pytest.mark.parametrize("dense_output", [True, False])
@pytest.mark.parametrize("dim", ["columnwise", "rowwise"])
@pytest.mark.parametrize("stype,params", SKETCHES, ids=[s for s, _ in SKETCHES])
def test_sparse_apply_matches_jax_f32(rng, stype, params, dim, dense_output):
    shape = (N, M) if dim == "columnwise" else (M, N)
    data, idx = _arrays(rng, shape, NNZ)
    Aj, At = _both(data, idx, shape)
    Sj, St = _pair(stype, N, params)
    ref = Sj.apply(Aj, dim, dense_output=dense_output)
    out = St.apply(At, dim, dense_output=dense_output)
    assert (out.layout == torch.strided) == dense_output
    if dense_output:
        assert out.dtype == torch.float32
    assert _rel(_dense(out), _dense(ref)) <= TOL[torch.float32]


@pytest.mark.parametrize("tdtype", [torch.float64, torch.bfloat16], ids=["f64", "bf16"])
@pytest.mark.parametrize("dense_output", [True, False])
@pytest.mark.parametrize("stype,params", [("SJLT", {"nnz": 4}), ("MMT", {})],
                         ids=["SJLT", "MMT"])
def test_sparse_apply_matches_jax_other_dtypes(rng, stype, params, dense_output, tdtype):
    data, idx = _arrays(rng, (N, M), NNZ, np.float64)
    Aj, At = _both(data, idx, (N, M), tdtype)
    Sj, St = _pair(stype, N, params)
    ref = Sj.apply(Aj, "columnwise", dense_output=dense_output)
    out = St.apply(At, "columnwise", dense_output=dense_output)
    if dense_output:
        assert out.dtype == tdtype
    assert _rel(_dense(out), _dense(ref)) <= TOL[tdtype]


@pytest.mark.parametrize("dense_output", [True, False])
def test_uncoalesced_duplicates_add_up(rng, dense_output):
    data, idx = _arrays(rng, (N, M), NNZ, duplicates=True)
    Aj, At = _both(data, idx, (N, M))
    assert not At.is_coalesced()
    Sj, St = _pair("SJLT", N, {"nnz": 4})
    out = St.apply(At, "columnwise", dense_output=dense_output)
    assert _rel(_dense(out), _dense(Sj.apply(Aj, dense_output=dense_output))) <= 1e-5
    # and the same as the coalesced matrix and the dense one
    assert _rel(_dense(out), _dense(St.apply(At.coalesce(), dense_output=dense_output))) <= 1e-6
    assert _rel(_dense(out), _dense(St.apply(At.to_dense()))) <= 1e-5


@pytest.mark.parametrize("dense_output", [True, False])
def test_sparse_vector(rng, dense_output):
    idx = rng.integers(0, N, (50, 1)).astype(np.int32)
    data = rng.standard_normal(50).astype(np.float32)
    Aj, At = _both(data, idx, (N,))
    Sj, St = _pair("CWT", N, {})
    out = St.apply(At, "columnwise", dense_output=dense_output)
    assert out.layout == torch.strided and tuple(out.shape) == (S,)
    assert _rel(out, _dense(Sj.apply(Aj, "columnwise", dense_output=dense_output))) <= 1e-5
    # Rowwise, a vector is one row (the JAX package fails on a 1-D BCOO
    # rowwise; the port is held against its own dense apply).
    row = St.apply(At, "rowwise", dense_output=dense_output)
    assert _rel(row, St.apply(At.to_dense(), "rowwise")) <= 1e-6


def test_interpret_kernel_route_matches(rng, monkeypatch):
    """Past the JAX gate (nnz ≥ 8192, S·batch ≥ 1024) with the Pallas
    kernel forced in interpret mode."""
    monkeypatch.setenv("SKYLARK_PALLAS_SCATTER", "interpret")
    data, idx = _arrays(rng, (N, M), 9000)
    Aj, At = _both(data, idx, (N, M))
    Sj, St = _pair("CWT", N, {})
    ref = Sj.apply(Aj, "columnwise", dense_output=True)
    assert _rel(St.apply(At, "columnwise", dense_output=True), ref) <= 1e-5


def test_dense_output_limit():
    St = T.sketch.CWT(10, 1 << 14, T.SketchContext(seed=1))
    A = coo_from_bcoo_arrays(np.ones(1, np.float32), np.zeros((1, 2), np.int32),
                             (10, (1 << 14) + 1), device="cpu")
    with pytest.raises(ValueError, match="dense_output"):
        St.apply(A, "columnwise", dense_output=True)
    assert St.apply(A, "columnwise").layout == torch.sparse_coo


def test_other_sparse_layouts_raise():
    St = T.sketch.CWT(50, 8, T.SketchContext(seed=1))
    with pytest.raises(UnsupportedError):
        St.apply(torch.eye(50).to_sparse_csr())


def test_sparse_least_squares_refused():
    A = torch.eye(40)[:, :5].to_sparse()
    with pytest.raises(UnsupportedError, match="JAX package"):
        T.linalg.approximate_least_squares(A, torch.ones(40), T.SketchContext(seed=1),
                                           T.linalg.LeastSquaresParams(sketch_type="CWT"))


def test_coo_from_bcoo_arrays_checks_shapes():
    with pytest.raises(ValueError):
        coo_from_bcoo_arrays(np.ones(3), np.zeros((2, 2)), (4, 4), device="cpu")
    with pytest.raises(ValueError):
        coo_from_bcoo_arrays(np.ones(3), np.zeros((3, 1)), (4, 4), device="cpu")
