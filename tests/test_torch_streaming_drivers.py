"""Port vs JAX package: the streaming drivers ``sketch`` (columnwise
and rowwise), ``sketch_batches``, ``sketch_least_squares`` and
``kernel_ridge``, on the same seeded numpy inputs.  Helpers, fixtures
and tolerances are ``test_torch_streaming.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import streaming as jst
from libskylark_tpu_torch import streaming as tst

from test_torch_streaming import (  # noqa: F401 (jax_plain: the autouse fixture)
    jax_plain,
    N,
    M,
    BATCH,
    KINDS,
    cpu,
    _pair,
    _rel,
    blocks_of,
    factory_of,
    _coo,
)


# ---------------------------------------------------------------------------
# Drivers


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_columnwise_matches_jax(rng, kind):
    Sj, St = _pair(kind)
    A = rng.standard_normal((N, M))
    want = np.asarray(jst.sketch(blocks_of(jnp.asarray(A)), Sj, "columnwise", ncols=M))
    got = tst.sketch(blocks_of(torch.from_numpy(A)), St, "columnwise", ncols=M,
                     dtype=torch.float64, params=cpu())
    assert _rel(got, want) <= 1e-12
    whole = St.apply(torch.from_numpy(A), "columnwise")
    assert _rel(got, whole) <= 1e-12


@pytest.mark.parametrize("kind", ["CWT", "JLT", "GaussianRFT", "FJLT"])
def test_sketch_rowwise_and_batches_match_jax(rng, kind):
    Sj, St = _pair(kind)
    A = rng.standard_normal((N, N)).astype(np.float32)
    want = np.asarray(jst.sketch(blocks_of(jnp.asarray(A)), Sj, "rowwise"))
    got = tst.sketch(blocks_of(A), St, "rowwise", params=cpu())
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5
    parts = list(tst.sketch_batches(factory_of(A), St, params=cpu(prefetch=0)))
    assert len(parts) == -(-N // BATCH) and torch.equal(torch.cat(parts), got)


def test_sketch_numpy_batches_and_f32_accumulator(rng):
    Sj, St = _pair("CWT")
    A = rng.standard_normal((N, M)).astype(np.float32)
    want = np.asarray(jst.sketch(blocks_of(jnp.asarray(A)), Sj, "columnwise", ncols=M,
                                 dtype=jnp.float32))
    got = tst.sketch(blocks_of(A), St, "columnwise", ncols=M, dtype=torch.float32,
                     params=cpu())
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5


def test_sketch_sparse_blocks_match_jax(rng):
    Sj, St = _pair("SJLT")
    A = rng.standard_normal((N, M))
    A[rng.random(A.shape) < 0.5] = 0.0
    jblocks, tblocks = zip(*(_coo(b) for b in blocks_of(A)))
    want = np.asarray(jst.sketch(list(jblocks), Sj, "columnwise", ncols=M))
    got = tst.sketch(list(tblocks), St, "columnwise", ncols=M, dtype=torch.float64,
                     params=cpu())
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("kind", ["JLT", "CWT"])
def test_sketch_least_squares_matches_jax(rng, kind):
    n, d = 60, 4
    A = rng.standard_normal((n, d))
    b = A @ rng.standard_normal(d) + 0.01 * rng.standard_normal(n)
    Sj, St = _pair(kind, n=n, s=16)
    xj, ij = jst.sketch_least_squares(blocks_of(jnp.asarray(A), jnp.asarray(b)), Sj, ncols=d)
    xt, it = tst.sketch_least_squares(blocks_of(torch.from_numpy(A), torch.from_numpy(b)),
                                      St, ncols=d, dtype=torch.float64, params=cpu())
    assert _rel(xt, xj) <= 1e-10
    assert set(it) == set(ij) == {"rows", "batches", "seconds", "recovery"}
    assert (it["rows"], it["batches"]) == (ij["rows"], ij["batches"]) == (n, -(-n // BATCH))
    assert it["recovery"]["attempts"][0]["verdict"] == ij["recovery"]["attempts"][0]["verdict"]


def test_kernel_ridge_driver_matches_jax(rng):
    n, d, s = 50, 3, 32
    X = rng.standard_normal((n, d))
    y = rng.standard_normal((n, 2))
    kj, kt = J.ml.GaussianKernel(d, 1.0), T.ml.GaussianKernel(d, 1.0)
    mj = jst.kernel_ridge(blocks_of(jnp.asarray(X), jnp.asarray(y)), kj, 0.1, s,
                          J.SketchContext(seed=12), targets=2)
    mt = tst.kernel_ridge(blocks_of(torch.from_numpy(X), torch.from_numpy(y)), kt, 0.1, s,
                          T.SketchContext(seed=12), targets=2, dtype=torch.float64,
                          params=cpu())
    assert _rel(mt.W, mj.W) <= 1e-10
    assert mt.info["rows"] == mj.info["rows"] == n
    assert mt.info["batches"] == mj.info["batches"]
