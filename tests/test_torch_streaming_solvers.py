"""Port vs JAX package: ``streaming_least_squares``,
``streaming_approximate_kernel_ridge``, ``streaming_kernel_ridge`` (f32
and bf16 features) and ``streaming_approximate_svd``, on the same seeded
numpy inputs.  Helpers, fixtures and tolerances are
``test_torch_streaming.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

from test_torch_streaming import (  # noqa: F401 (jax_plain: the autouse fixture)
    jax_plain,
    cpu,
    _rel,
    blocks_of,
    f64_default,
)

# Streaming KRR with bf16 features, port vs JAX (W, relative): 1.2e-3 to
# 3.6e-3 read over seeds 0-2 at both splits, against 1.2e-2 to 3.5e-2 for
# f32 features against the JAX package's bf16 ones.
BF16_KRR_TOL = 5e-3


def test_streaming_least_squares_matches_jax(rng, f64_default):
    n, d = 64, 4
    A = rng.standard_normal((n, d))
    b = A @ rng.standard_normal(d) + 0.01 * rng.standard_normal(n)
    jp = J.linalg.LeastSquaresParams(sketch_size=16)
    tp = T.linalg.LeastSquaresParams(sketch_size=16)
    xj, ij = J.linalg.streaming_least_squares(blocks_of(jnp.asarray(A), jnp.asarray(b)), n, d,
                                              J.SketchContext(seed=11), jp)
    xt, it = T.linalg.streaming_least_squares(
        blocks_of(torch.from_numpy(A), torch.from_numpy(b)), n, d, T.SketchContext(seed=11),
        tp, stream_params=cpu())
    assert _rel(xt, xj) <= 1e-10
    assert {"rows", "batches", "seconds", "recovery", "policy"} == set(it) == set(ij)
    assert it["policy"] == ij["policy"]
    # The default sketch is JLT at 4·d for a dense stream, as in the JAX package.
    S = T.sketch.JLT(n, 4 * d, T.SketchContext(seed=11))
    x_def, _ = T.linalg.streaming_least_squares(
        blocks_of(torch.from_numpy(A), torch.from_numpy(b)), n, d, T.SketchContext(seed=11),
        stream_params=cpu())
    want = T.linalg.exact_least_squares(S.apply(torch.from_numpy(A)),
                                        S.apply(torch.from_numpy(b)[:, None]))[:, 0]
    assert _rel(x_def, want) <= 1e-12


def test_streaming_approximate_kernel_ridge_matches_jax_and_incore(rng, f64_default):
    n, d, s = 50, 3, 32
    X = rng.standard_normal((n, d))
    y = rng.standard_normal(n)
    mj = J.ml.streaming_approximate_kernel_ridge(
        J.ml.GaussianKernel(d, 1.0), blocks_of(jnp.asarray(X), jnp.asarray(y)), 0.1, s,
        J.SketchContext(seed=12))
    mt = T.ml.streaming_approximate_kernel_ridge(
        T.ml.GaussianKernel(d, 1.0), blocks_of(torch.from_numpy(X), torch.from_numpy(y)), 0.1,
        s, T.SketchContext(seed=12), stream_params=cpu())
    assert _rel(mt.W, mj.W) <= 1e-10
    mi = T.ml.approximate_kernel_ridge(T.ml.GaussianKernel(d, 1.0), torch.from_numpy(X),
                                       torch.from_numpy(y), 0.1, s, T.SketchContext(seed=12))
    assert _rel(mt.predict(torch.from_numpy(X)), mi.predict(torch.from_numpy(X))) <= 1e-8


@pytest.mark.parametrize("split,s", [(0, 10), (8, 12)])  # one feature chunk, three
def test_streaming_kernel_ridge_matches_jax(rng, split, s):
    n, d, br = 384, 6, 96
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = np.sin(X.sum(1))
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    kp = dict(max_split=split, iter_lim=4, tolerance=0.0)
    mj = J.ml.streaming_kernel_ridge(
        J.ml.GaussianKernel(d, 2.0), lambda st, rows: jax.lax.dynamic_slice_in_dim(Xj, st, rows),
        (n, d), Y, 0.5, s, J.SketchContext(seed=4), J.ml.KrrParams(**kp), block_rows=br,
        feature_dtype=jnp.float32)
    timer = T.utils.PhaseTimer()
    mt = T.ml.streaming_kernel_ridge(
        T.ml.GaussianKernel(d, 2.0), lambda st, rows: Xt[st:st + rows], (n, d),
        torch.from_numpy(Y), 0.5, s, T.SketchContext(seed=4), T.ml.KrrParams(**kp),
        block_rows=br, feature_dtype=torch.float32, timer=timer)
    assert mt.W.dtype == torch.float32 and _rel(mt.W, mj.W) <= 1e-5
    assert timer.counts["sweep0"] == 1 and timer.counts["sweep"] == 3
    # The same sweeps in core, on the materialized X.
    ml = T.ml.large_scale_kernel_ridge(T.ml.GaussianKernel(d, 2.0), Xt, torch.from_numpy(Y),
                                       0.5, s, T.SketchContext(seed=4), T.ml.KrrParams(**kp))
    assert _rel(mt.W, ml.W) <= 1e-5


@pytest.mark.parametrize("split,s", [(0, 10), (8, 12)])
def test_streaming_kernel_ridge_bf16_matches_jax(rng, split, s):
    """The default bf16 features against the JAX package's.  Both round
    each sweep's delta to the panel dtype before R -= Z·delta, so W
    departs from the f32-feature solve (the control) by more than the two
    packages depart from each other: their f32 solves differ slightly and
    the bf16 rounding of delta flips where they do.  chip_smoke.py's
    NS_W_TOL rests on this."""
    n, d, br = 384, 6, 96
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = np.sin(X.sum(1)).astype(np.float32)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    kp = dict(max_split=split, iter_lim=4, tolerance=0.0)
    mj = J.ml.streaming_kernel_ridge(
        J.ml.GaussianKernel(d, 2.0), lambda st, rows: jax.lax.dynamic_slice_in_dim(Xj, st, rows),
        (n, d), Y, 0.5, s, J.SketchContext(seed=4), J.ml.KrrParams(**kp), block_rows=br,
        feature_dtype=jnp.bfloat16)
    mt = T.ml.streaming_kernel_ridge(
        T.ml.GaussianKernel(d, 2.0), lambda st, rows: Xt[st:st + rows], (n, d),
        torch.from_numpy(Y), 0.5, s, T.SketchContext(seed=4), T.ml.KrrParams(**kp),
        block_rows=br, feature_dtype=torch.bfloat16)
    assert mt.W.dtype == torch.float32
    assert _rel(mt.W, mj.W) <= BF16_KRR_TOL
    # The f32-feature solve the bf16 rounding departs from, by more.
    mf = T.ml.streaming_kernel_ridge(
        T.ml.GaussianKernel(d, 2.0), lambda st, rows: Xt[st:st + rows], (n, d),
        torch.from_numpy(Y), 0.5, s, T.SketchContext(seed=4), T.ml.KrrParams(**kp),
        block_rows=br, feature_dtype=torch.float32)
    assert _rel(mf.W, mj.W) > BF16_KRR_TOL


def test_streaming_kernel_ridge_bf16_features_and_block_args(rng):
    n, d, s = 256, 8, 16
    X0 = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    Y = torch.from_numpy(np.sign(rng.standard_normal(n)))

    def block_fn(start, rows, X0):
        return torch.roll(X0, start // rows, dims=0)

    m = T.ml.streaming_kernel_ridge(
        T.ml.GaussianKernel(d, 2.0), block_fn, (n, d), Y, 0.1, s, T.SketchContext(seed=7),
        T.ml.KrrParams(iter_lim=3, tolerance=0.0), block_rows=64, block_args=(X0,))
    assert m.W.dtype == torch.float32 and bool(torch.isfinite(m.W).all())
    X = torch.cat([block_fn(p * 64, 64, X0) for p in range(4)])
    ml = T.ml.large_scale_kernel_ridge(T.ml.GaussianKernel(d, 2.0), X.bfloat16(), Y, 0.1, s,
                                       T.SketchContext(seed=7),
                                       T.ml.KrrParams(iter_lim=3, tolerance=0.0))
    assert _rel(m.W, ml.W.float()) <= 2e-2  # bf16 features, f32 vs bf16 state


def test_streaming_kernel_ridge_panel_divisor():
    k = T.ml.GaussianKernel(2, 1.0)
    with pytest.raises(ValueError, match="panel divisor"):
        T.ml.streaming_kernel_ridge(k, None, (1009 * 2, 2), torch.zeros(2018), 0.1, 4,
                                    T.SketchContext(seed=1), block_rows=1000)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_streaming_svd_matches_jax(dtype):
    m, n, k, br = 2048, 48, 5, 256
    tj = jnp.float64 if dtype == np.float64 else jnp.float32
    tt = torch.float64 if dtype == np.float64 else torch.float32
    bj = J.linalg.synthetic_lowrank_blocks(J.SketchContext(seed=5), m, n, 8, noise=0.01,
                                           dtype=tj)
    bt = T.linalg.synthetic_lowrank_blocks(T.SketchContext(seed=5), m, n, 8, noise=0.01,
                                           dtype=tt, device="cpu")
    Uj, sj, Vj = J.linalg.streaming_approximate_svd(bj, (m, n), k, J.SketchContext(seed=6),
                                                    block_rows=br, materialize_u=True)
    u_block, st, Vt = T.linalg.streaming_approximate_svd(bt, (m, n), k,
                                                         T.SketchContext(seed=6), block_rows=br)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    assert st.dtype == tt and _rel(st, sj) <= tol
    Ut = torch.cat([u_block(i) for i in range(m // br)])
    rec_t = (Ut * st[None, :]) @ Vt.T
    rec_j = (np.asarray(Uj) * np.asarray(sj)[None, :]) @ np.asarray(Vj).T
    assert _rel(rec_t, rec_j) <= (1e-9 if dtype == np.float64 else 1e-4)
    U2, _, _ = T.linalg.streaming_approximate_svd(bt, (m, n), k, T.SketchContext(seed=6),
                                                  block_rows=br, materialize_u=True)
    assert torch.equal(U2, Ut)


def test_streaming_svd_errors():
    blk = T.linalg.synthetic_lowrank_blocks(T.SketchContext(seed=1), 64, 8, 2, device="cpu")
    with pytest.raises(UnsupportedError, match="item 9"):
        T.linalg.streaming_approximate_svd(blk, (64, 8), 2, T.SketchContext(), mesh=object())
    with pytest.raises(ValueError, match="divisible"):
        T.linalg.streaming_approximate_svd(blk, (64, 8), 2, T.SketchContext(), block_rows=10)
