"""The flagship forward step, a Gaussian random-feature kernel machine
(the counterpart of the JAX package's ``__graft_entry__.entry``), and
the multichip dry run (``__graft_entry__.dryrun_multichip``).

``GaussianKernel(128, sigma=2.0).create_rft(512, "regular",
SketchContext(seed=17))`` maps X (256, 128) to its random features Z
(256, 512), and the step returns the decision values ``Z @ W`` (256,
10).  X and W are the same numpy draws (``default_rng(0)``) as the JAX
entry's, so the two steps agree to f32 rounding.

:func:`dryrun_multichip` runs every step of the JAX dry run, with its
seeds, shapes and asserts, on a mesh of ``n_devices`` slots: the
sharded-input trainers and solvers (``parallel.routes``), the streaming
SVD and KRR with sharded panels, the explicit sparse schedules and the
elastic sketch at world 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.context import SketchContext
from .ml.kernels import GaussianKernel

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """``(forward, (X, W))``: the forward step and its example inputs on
    ``device`` (the default device when None)."""
    d, s, k = 128, 512, 10
    fmap = GaussianKernel(d, sigma=2.0).create_rft(s, "regular", SketchContext(seed=17))

    def forward(X, W):
        Z = fmap.apply(X, "rowwise")  # (n, s) random features
        return Z @ W                  # (n, k) decision values

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((256, d)), dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.standard_normal((s, k)) * 0.01, dtype=torch.float32, device=dev)
    return forward, (X, W)


def _close(got, want, rtol, atol, what):
    from .parallel import fully_replicated

    got, want = (fully_replicated(x).detach().cpu().numpy() for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _finite(x, what):
    from .parallel import fully_replicated

    x = fully_replicated(x)
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"dryrun_multichip: non-finite {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One fully sharded training step plus the sharded NLA pipeline on a
    mesh of ``n_devices`` slots (``__graft_entry__.py:38``).

    ``device=None`` puts one slot on each of the first ``n_devices``
    visible cards (it raises where there are fewer); a device
    (``"cpu"``, ``"cuda"``) puts every slot on it, as the tests and a
    one-card machine do.  Raises ``AssertionError`` where a step's
    result is not finite or misses its reference."""
    import time

    from . import streaming as sky_streaming
    from .linalg import (LeastSquaresParams, SVDParams, approximate_least_squares,
                         approximate_svd, streaming_approximate_svd,
                         synthetic_lowrank_blocks)
    from .ml import (ADMMParams, BlockADMMSolver, KrrParams, large_scale_kernel_ridge,
                     streaming_kernel_ridge)
    from .parallel import (COLS, ROWS, columnwise_sharded_sparse,
                           columnwise_sharded_sparse_2d, columnwise_sharded_sparse_out,
                           columnwise_sharded_sparse_out_2d, constrain_rows, make_mesh,
                           rowwise_sharded_sparse, shard)
    from .sketch import CWT, FJLT, JLT

    r = int(np.floor(np.sqrt(n_devices)))
    while n_devices % r:
        r -= 1
    mesh = make_mesh((r, n_devices // r), (ROWS, COLS), devices=device)
    dev = mesh.device(0)
    rng = np.random.default_rng(1)

    def t32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    # --- BlockADMM kernel-machine training step: data partitions = the
    # mesh's slots, X sharded on (ROWS, COLS) and resharded to rows.
    n, d = 32 * n_devices, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    Xs = shard(t32(X), mesh, (ROWS, COLS))
    kernel = GaussianKernel(d, sigma=2.0)
    ctx = SketchContext(seed=7)
    maps = [kernel.create_rft(32, "regular", ctx) for _ in range(2)]
    solver = BlockADMMSolver("hinge", "l2", maps,
                             ADMMParams(maxiter=1, data_partitions=n_devices))
    model = solver.train(Xs, y)
    _finite(model.predict(Xs), "ADMM predictions")

    # --- Sharded randomized SVD + sketched least squares (2-D mesh).
    m2, n2, k2 = 64 * r, 16 * (n_devices // r), 4
    A = shard(t32(rng.standard_normal((m2, n2))), mesh, ROWS, COLS)
    b = shard(t32(rng.standard_normal(m2)), mesh, ROWS)
    _, s, _ = approximate_svd(A, k2, SketchContext(seed=3), SVDParams(num_iterations=1))
    x = approximate_least_squares(A, b, SketchContext(seed=4),
                                  LeastSquaresParams(sketch_type="CWT", sketch_size=4 * n2))
    _finite(s, "singular values")
    _finite(x, "least-squares solution")

    # --- Memory-bounded KRR (feature-chunk BCD) on sharded data.
    Xk = shard(t32(X), mesh, (ROWS, COLS))
    model_k = large_scale_kernel_ridge(kernel, Xk, t32(y), lam=0.1, s=32,
                                       context=SketchContext(seed=21),
                                       params=KrrParams(max_split=16, iter_lim=2))
    _finite(model_k.predict(Xk), "KRR predictions")

    # --- Mesh-mode streaming randomized SVD: panels split over the mesh rows.
    mesh1d = make_mesh((n_devices,), (ROWS,), devices=device)
    ms, ns, ks = 16 * n_devices, 24, 3
    blk = synthetic_lowrank_blocks(SketchContext(seed=23), ms, ns, ks, noise=0.01,
                                   dtype=torch.float32, device=dev)
    _, s_stream, _ = streaming_approximate_svd(blk, (ms, ns), ks, SketchContext(seed=24),
                                               SVDParams(num_iterations=1),
                                               block_rows=ms // 2, mesh=mesh1d)
    _finite(s_stream, "streaming singular values")

    # --- Sharded FJLT apply: batch rows sharded, the transform per slot.
    mf, nf, sf = 8 * n_devices, 512, 64
    Af = shard(t32(rng.standard_normal((mf, nf))), mesh, ROWS)
    SF = FJLT(nf, sf, SketchContext(seed=25))
    _finite(SF.apply(Af, "rowwise"), "sharded FJLT")
    _finite(SF.apply(t32(rng.standard_normal((2, nf))), "rowwise"), "FJLT")

    # --- P6: explicit sharded sparse hash-sketch schedules.
    def coo(M):
        return torch.as_tensor(M, dtype=torch.float32, device=dev).to_sparse_coo()

    ns_, ms_, ss_ = 16 * n_devices, 8, 8
    Msp = rng.standard_normal((ns_, ms_)) * (rng.random((ns_, ms_)) < 0.2)
    Asp = coo(Msp)
    S = CWT(ns_, ss_, SketchContext(seed=9))
    _close(columnwise_sharded_sparse(S, Asp, mesh), S.apply(Asp, "columnwise").to_dense(),
           1e-5, 1e-5, "columnwise_sharded_sparse")
    S2 = CWT(ms_, ss_, SketchContext(seed=10))
    _close(rowwise_sharded_sparse(S2, Asp, mesh), S2.apply(Asp, "rowwise").to_dense(),
           1e-5, 1e-5, "rowwise_sharded_sparse")

    # --- Streaming KRR with panels row-sharded inside block_fn, held to
    # large_scale_kernel_ridge from the same context.
    nk, dk, sk = 32 * n_devices, 8, 16
    Xst = t32(rng.standard_normal((nk, dk)))
    yst = t32(rng.standard_normal(nk))
    k_st = GaussianKernel(dk, sigma=2.0)

    def krr_block_fn(start, rows, X):
        return constrain_rows(X[start:start + rows], mesh1d)

    krr_params = KrrParams(max_split=8, iter_lim=2)
    model_s = streaming_kernel_ridge(k_st, krr_block_fn, (nk, dk), yst, lam=0.1, s=sk,
                                     context=SketchContext(seed=31), params=krr_params,
                                     block_rows=nk // 2, feature_dtype=torch.float32,
                                     block_args=(Xst,))
    model_ref = large_scale_kernel_ridge(k_st, Xst, yst, lam=0.1, s=sk,
                                         context=SketchContext(seed=31), params=krr_params)
    _close(model_s.W, model_ref.W, 1e-4, 1e-6, "streaming KRR vs large-scale KRR")

    # --- P6 2-D grid: one psum over the mesh row axis.
    n2d, m2d, s2d = 16 * r, 4 * (n_devices // r), 8
    M2d = rng.standard_normal((n2d, m2d)) * (rng.random((n2d, m2d)) < 0.3)
    A2d = coo(M2d)
    S2d = CWT(n2d, s2d, SketchContext(seed=33))
    _close(columnwise_sharded_sparse_2d(S2d, A2d, mesh),
           S2d.apply(A2d, "columnwise").to_dense(), 1e-5, 1e-5, "columnwise_sharded_sparse_2d")

    # --- Sparse→sparse sharded output: the all-to-all entry exchange.
    n_so, m_so, s_so = 8 * n_devices, 6, 2 * n_devices
    M_so = rng.standard_normal((n_so, m_so)) * (rng.random((n_so, m_so)) < 0.4)
    A_so = coo(M_so)
    S_so = CWT(n_so, s_so, SketchContext(seed=37))
    out_so = columnwise_sharded_sparse_out(S_so, A_so, mesh1d)
    _close(out_so.todense(), S_so.apply(A_so, "columnwise").to_dense(), 1e-5, 1e-5,
           "columnwise_sharded_sparse_out")

    # --- 2-D grid sparse→sparse.
    S_so2 = CWT(n2d, 2 * r, SketchContext(seed=39))
    _close(columnwise_sharded_sparse_out_2d(S_so2, A2d, mesh).todense(),
           S_so2.apply(A2d, "columnwise").to_dense(), 1e-5, 1e-5,
           "columnwise_sharded_sparse_out_2d")

    # --- Device-resident chain: a second sketch of the sharded result.
    S_chain = CWT(S_so.s, n_devices, SketchContext(seed=41))
    ref_chain = S_chain.apply(S_so.apply(A_so, "columnwise"), "columnwise").to_dense()
    _close(out_so.sketch_columnwise(S_chain, dense_output=True), ref_chain, 1e-5, 1e-5,
           "chained sketch")

    # --- Elastic streaming at world 1, held to the in-core apply.
    ne, me, se, be = 64 * n_devices, 16, 24, 16
    Ae = torch.as_tensor(rng.standard_normal((ne, me)), device=dev)
    Se = JLT(ne, se, SketchContext(seed=43))
    part_e = sky_streaming.RowPartition(nrows=ne, batch_rows=be, world_size=1)

    def stream_e(start):
        return iter([Ae[lo:lo + be] for lo in range(0, ne, be)][start:])

    t0 = time.perf_counter()
    out_e = sky_streaming.sketch(
        stream_e, Se, "columnwise", ncols=me, partition=part_e,
        params=sky_streaming.ElasticParams(placer=sky_streaming.pinned_placer(dev)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_e = time.perf_counter() - t0
    _close(out_e, Se.apply(Ae, "columnwise"), 1e-5, 1e-5, "elastic stream sketch")
    print(f"MULTICHIP distributed-stream-sketch rows/s={ne / dt_e:.0f} "
          f"({ne}x{me} in {dt_e:.3f}s, world=1)", flush=True)
