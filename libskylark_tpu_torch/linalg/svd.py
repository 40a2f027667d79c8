"""Randomized SVD (Halko-Martinsson-Tropp; port of
``libskylark_tpu/linalg/svd.py``, ≙ ``nla/svd.hpp``).

A JLT sketch of the row space, optional power iterations, an eigh-based
CholeskyQR2 orthonormalization (:func:`gram_orth`), then a small SVD.
The tall products are ``torch.matmul`` in full f32 on the card (TF32 is
off, ``_device.py``), the counterpart of the JAX package's
``precision="highest"``; the small factorizations are torch's own.
``A`` may be a dense or a sparse COO tensor (only products with A are
taken), or a row-sharded
:class:`~libskylark_tpu_torch.parallel.mesh.Sharded`: then Y = A·Ω and
the power iterations' A·Z run per slot, and the Grams of
:func:`gram_orth` and ``B = AᵀQ`` (the JAX package's
``fully_replicated`` points) are psum'd in slot order onto slot 0's
device; U comes back row-sharded as A.  ``streaming_approximate_svd`` is the
matrix-free form for A too large for the card: row panels regenerated
(or re-streamed) per pass, only one panel and the small accumulators
resident; with ``mesh=`` each panel is split over a mesh's slots.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import guard
from .._device import as_tensor, is_sharded
from ..core.context import SketchContext
from ..core.matrices import gaussian_matrix
from ..core.params import Params
from ..core.random import sample_window
from ..parallel import routes
from ..resilient.chunked import ChunkedSolver
from ..sketch.base import Dimension
from ..sketch.dense import JLT
from ..utils.sparse import is_sparse, linear_ops

__all__ = [
    "SVDParams",
    "power_iteration",
    "approximate_svd",
    "approximate_svd_chunked",
    "approximate_symmetric_svd",
    "streaming_approximate_svd",
    "synthetic_lowrank_blocks",
    "gram_orth",
]


@dataclass
class SVDParams(Params):
    """≙ ``nla/svd.hpp:22-48`` (``approximate_svd_params_t``)."""

    oversampling_ratio: int = 2
    oversampling_additive: int = 0
    num_iterations: int = 0
    skip_qr: bool = False


def gram_orth(Y: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Orthonormalize the columns of tall-skinny ``Y`` through its Gram
    matrix: per pass ``G = YᵀY``, ``eigh(G)`` and ``Y ← Y·V·diag(λ^-½)``.
    Two passes give CholeskyQR2-grade orthogonality.  Eigenvalues at or
    below ``λ_max·eps·s`` get a zero scale, so a rank-deficient Y (the
    sketch of an exactly low-rank A) yields zero columns, not NaNs; the
    rank-k truncation downstream drops them."""
    for _ in range(passes):
        G = routes.tsum(lambda y: y.T @ y, Y)
        lam, V = torch.linalg.eigh(G)
        floor = torch.clamp(lam[-1], min=0) * torch.finfo(Y.dtype).eps * G.shape[0]
        scale = torch.where(lam > floor, torch.rsqrt(torch.maximum(lam, floor)),
                            torch.zeros_like(lam))
        Y = routes.rows_map(torch.matmul, Y, V * scale[None, :])
    return Y


def _sketch_size(k: int, params: SVDParams, n: int, m: int | None = None):
    """Validated (k, s): the oversampled sketch width clamped to n."""
    k = int(k)
    lim = n if m is None else min(m, n)
    if k > lim:
        raise ValueError(f"rank {k} exceeds min matrix dimension {lim}")
    s = min(k * params.oversampling_ratio + params.oversampling_additive, n)
    return k, max(s, k)


def _ops(A):
    """``(A·Z, Aᵀ·Q)``: a row-sharded A keeps A·Z row-sharded."""
    if is_sharded(A):
        return (lambda Z: routes.rows_map(torch.matmul, A, Z)), (lambda Q: routes.rmatmul(A, Q))
    return linear_ops(A)


def power_iteration(A, Q: torch.Tensor, num_iterations: int, orthogonalize: bool = True):
    """Subspace iteration ``Q <- orth((A·Aᵀ)·Q)``, repeated
    (≙ ``PowerIteration``, ``nla/svd.hpp:71-149``; pass ``A.T`` for the
    adjoint flavour).  A row-sharded A takes a Q sharded as A."""
    matvec, rmatvec = _ops(A)
    for _ in range(max(int(num_iterations), 0)):
        Q = matvec(rmatvec(Q))
        if orthogonalize:
            Q = gram_orth(Q)
    return Q


def approximate_svd_chunked(A, rank: int, context: SketchContext,
                            params: SVDParams | None = None, *, device=None) -> ChunkedSolver:
    """Chunkable randomized SVD: the power-iteration sweeps run as chunks
    whose state is the iteration count and the current basis Y; the
    sketch in ``init_state`` is counter-based, so a rebuilt solver makes
    the same test matrix.  ``extract_result`` does the trailing
    orthonormalization, ``B = AᵀQ``, the small SVD and the truncation."""
    params = params or SVDParams()
    A, _ = routes.operands(A, device=device)
    m, n = A.shape
    k, s = _sketch_size(rank, params, n, m)
    niter = max(params.num_iterations, 0)
    orthogonalize = not params.skip_qr
    rmatvec = _ops(A)[1]

    def init_state():
        # Y = A·Ωᵀ, a rowwise JLT sketch (nla/svd.hpp:255-257).
        return dict(it=0, Y=JLT(n, s, context).apply(A, Dimension.ROWWISE))

    def step_chunk(st, num_iters: int):
        steps = max(min(num_iters, niter - st["it"]), 0)
        return dict(it=st["it"] + steps,
                    Y=power_iteration(A, st["Y"], steps, orthogonalize))

    def extract_result(st):
        Y = st["Y"]
        # The sweeps end orthonormalized unless skip_qr.
        Q = Y if (niter > 0 and orthogonalize) else gram_orth(Y)
        B = rmatvec(Q)  # (n, s)
        W, sv, Zt = torch.linalg.svd(B, full_matrices=False)
        # A ≈ Q·Bᵀ = (Q·Ztᵀ)·diag(sv)·Wᵀ (nla/svd.hpp:266-285).
        U = routes.rows_map(torch.matmul, Q, Zt.T[:, :k]) if is_sharded(Q) else (Q @ Zt.T)[:, :k]
        return U, sv[:k], W[:, :k]

    return ChunkedSolver(
        init_state=init_state,
        step_chunk=step_chunk,
        extract_result=extract_result,
        is_done=lambda st: st["it"] >= niter,
        iteration=lambda st: st["it"],
        kind="approximate_svd",
    )


def approximate_svd(A, rank: int, context: SketchContext, params: SVDParams | None = None,
                    *, return_info: bool = False, device=None):
    """Randomized truncated SVD: ``(U, s, V)`` with ``A ≈ U·diag(s)·Vᵀ``,
    U (m, rank), V (n, rank) (≙ ``ApproximateSVD``, ``nla/svd.hpp:222-318``).

    Guarded (``SKYLARK_GUARD``, on by default): the factors are certified
    (``guard.certify_svd``); a failed certificate climbs the ladder
    (fresh-seed resketch → grown oversampling → dense
    ``torch.linalg.svd``).  Attempt 0 uses the caller's context, so a
    healthy run is bitwise the unguarded one.  ``return_info=True``
    returns ``((U, s, V), info)`` with the attempts in
    ``info["recovery"]``.
    """
    params = params or SVDParams()
    A, _ = routes.operands(A, device=device)

    def run(ctx, p):
        sol = approximate_svd_chunked(A, rank, ctx, p)
        return sol.extract_result(sol.step_chunk(sol.init_state(), max(p.num_iterations, 1)))

    if not guard.enabled():
        out = run(context, params)
        if return_info:
            return out, {"recovery": guard.RecoveryReport.disabled("randomized_svd").to_dict()}
        return out

    m, n = A.shape
    report = guard.RecoveryReport(stage="randomized_svd")
    out = None
    for i in range(guard.max_retries() + 1):
        if i == 0:
            action, ctx, p = "initial", context, params
        elif i == 1:
            action, ctx, p = "resketch", guard.derived_context(context, i), params
        else:
            # Grow the sketch width through the additive oversampling.
            action, ctx = "grow", guard.derived_context(context, i)
            p = replace(params, oversampling_additive=params.oversampling_additive
                        + rank * (2 ** (i - 1)))
        U, sv, V = run(ctx, p)
        cert = guard.certify_svd(A, U, sv, V)
        report.record(action, verdict=cert.verdict, detail=cert.detail,
                      sketch_size=_sketch_size(rank, p, n, m)[1])
        if cert.ok:
            report.recovered = i > 0
            out = (U, sv, V)
            break
    if out is None:
        if is_sharded(A):
            Uf, svf, Vtf = routes.dense_svd(A)
            Uf = routes.rows_map(lambda u: u[:, :rank], Uf)
        else:
            Ad = A.to_dense() if is_sparse(A) else A
            Uf, svf, Vtf = torch.linalg.svd(Ad, full_matrices=False)
            Uf = Uf[:, :rank]
        out = (Uf, svf[:rank], Vtf[:rank].T)
        report.record("fallback", verdict=guard.FALLBACK, detail="dense torch.linalg.svd")
        report.recovered = True
    if return_info:
        return out, {"recovery": report.to_dict()}
    return out


def approximate_symmetric_svd(A, rank: int, context: SketchContext,
                              params: SVDParams | None = None, *, device=None):
    """Randomized eigendecomposition of symmetric A: ``(V, lam)`` with
    ``A ≈ V·diag(lam)·Vᵀ``, eigenvalues by |lam| descending
    (≙ ``ApproximateSymmetricSVD``, ``nla/svd.hpp:321-392``)."""
    params = params or SVDParams()
    A = as_tensor(A, device)
    n = A.shape[0]
    k, s = _sketch_size(rank, params, n)
    Y = JLT(n, s, context).apply(A, Dimension.ROWWISE)  # A·Ωᵀ (A symmetric)
    Y = power_iteration(A, Y, params.num_iterations, not params.skip_qr)
    Q = Y if (params.num_iterations > 0 and not params.skip_qr) else gram_orth(Y)
    # Rayleigh-Ritz on the subspace (nla/svd.hpp:360-380).
    T = Q.T @ linear_ops(A)[0](Q)
    T = (T + T.T) / 2
    lam, W = torch.linalg.eigh(T)
    order = torch.argsort(-torch.abs(lam))
    return (Q @ W)[:, order[:k]], lam[order][:k]


def _acc_mm(a, b, acc):
    """a·b in the accumulator dtype from panel-dtype operands (exact
    upcasts): the JAX package's ``preferred_element_type=acc``."""
    return torch.matmul(a.to(acc), b.to(acc))


def _whiten(G, rel_floor):
    """``V·diag(λ^-½)`` of G's eigendecomposition, directions at or below
    ``λ_max·rel_floor`` given a zero scale."""
    lam, V = torch.linalg.eigh(G)
    floor = torch.clamp(lam[-1], min=0) * rel_floor
    scale = torch.where(lam > floor, torch.rsqrt(torch.maximum(lam, floor)),
                        torch.zeros_like(lam))
    return V * scale[None, :]


def streaming_approximate_svd(block_fn, shape: tuple[int, int], rank: int,
                              context: SketchContext, params: SVDParams | None = None,
                              block_rows: int = 65536, materialize_u: bool = False, mesh=None):
    """Randomized truncated SVD of a row-streamed A (m, n).

    ``block_fn(start_row, rows)`` returns the (rows, n) panel of A and
    must return the same panel every time (each pass asks for every panel
    again; the whitening amplifies any drift by 1/σ_min).  O(q + 3) passes
    over A, O(B·n + n·s) memory.  Math as the JAX package's (≙
    ``ApproximateSVD`` with an explicit Gaussian Ω): power sweeps
    ``W ← Aᵀ(A·W)`` orthonormalized by :func:`gram_orth`; one pass
    accumulating ``G = YᵀY`` and ``M = YᵀA`` (Y = A·Ω); a second streamed
    whitening pass (CholeskyQR2, the factors kept apart); the small SVD
    of ``B = QᵀA``.  Y panels are in the panel dtype, every accumulation
    in the panel dtype promoted to at least f32.

    Returns ``(u_block, s, V)``, ``u_block(i)`` giving rows ``[i·B,
    (i+1)·B)`` of U; with ``materialize_u=True``, U itself (m, k).  Without
    ``params`` one power iteration runs (the f32 whitening needs it on a
    noisy spectrum).

    ``mesh`` (a :class:`~libskylark_tpu_torch.parallel.mesh.Mesh`) splits
    every panel into the mesh's row blocks
    (:func:`~libskylark_tpu_torch.parallel.constrain_rows`, ≙ the
    ``[VC,*]`` long-dimension distribution): the panel products A_b·Ω are
    local to each slot, and each accumulator contraction (Aᵀ(AΩ), YᵀY,
    YᵀA) sums the slots' partial products with the mesh's ``psum`` in
    slot order on the first panel's device, the psum GSPMD inserts in the
    JAX package.  ``u_block`` recomputes Y the same way, so the factor and
    ``u_block`` keep the same bits, and a mesh of one is bitwise
    ``mesh=None``.  Explicit meshes are rejected, as the JAX package
    rejects them.
    """
    if mesh is not None and mesh.explicit:
        raise ValueError(
            "streaming_approximate_svd needs an Auto-axes mesh "
            "(make_mesh(..., explicit=False)); explicit typed-sharding "
            "would require out_sharding on every accumulator contraction")
    params = params or SVDParams(num_iterations=1)
    m, n = shape
    k, s = _sketch_size(rank, params, n, m)
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if m % block_rows:
        raise ValueError(f"m={m} not divisible by block_rows={block_rows}")
    nblocks = m // block_rows
    # Panel 0 tells the dtype and device; it serves the first pass too.
    first = [block_fn(0, block_rows)]
    if mesh is not None:
        from ..parallel.mesh import constrain_rows, fully_replicated, psum

        first = [fully_replicated(first[0])]
    dtype, dev = first[0].dtype, first[0].device
    acc = torch.promote_types(dtype, torch.float32)

    def panels():
        for i in range(nblocks):
            yield first.pop() if i == 0 and first else block_fn(i * block_rows, block_rows)

    def slots(Ab):
        """The panel's row blocks, one per slot (the panel itself without
        a mesh)."""
        return [Ab] if mesh is None else constrain_rows(Ab, mesh).shards

    def merge(parts):
        return parts[0] if mesh is None else psum(parts, dev)

    def on(x, a):
        return x if x.device == a.device else x.to(a.device)

    def panel_y(Ab, Om):
        return Ab @ on(Om, Ab).to(Ab.dtype)

    def sweep(Om):
        W = torch.zeros((n, s), dtype=acc, device=dev)
        for Ab in panels():
            W += merge([_acc_mm(a.T, panel_y(a, Om), acc) for a in slots(Ab)])
        return W

    Om = gaussian_matrix(context, (n, s), dtype=acc, device=dev)
    W = Om
    for _ in range(max(params.num_iterations, 0)):
        # skip_qr ≙ the reference's ortho flag: raw power sweeps.
        W = sweep(W) if params.skip_qr else gram_orth(sweep(W))
    Omq = W if params.num_iterations > 0 else Om

    G = torch.zeros((s, s), dtype=acc, device=dev)
    M = torch.zeros((s, n), dtype=acc, device=dev)
    for Ab in panels():
        parts = [(panel_y(a, Omq), a) for a in slots(Ab)]
        G += merge([_acc_mm(y.T, y, acc) for y, _ in parts])
        M += merge([_acc_mm(y.T, a, acc) for y, a in parts])
    # Stage 1 keeps directions a few times above the representation noise
    # (4·eps); stage 2 re-accumulates the Gram of the whitened panels,
    # where genuine directions land near 1 and noise far below (0.25).
    eps = torch.finfo(acc).eps
    T1 = _whiten(G, 4.0 * eps)
    G2 = torch.zeros((s, s), dtype=acc, device=dev)
    for Ab in panels():
        qs = [panel_y(a, Omq) @ on(T1, a).to(a.dtype) for a in slots(Ab)]
        G2 += merge([_acc_mm(q.T, q, acc) for q in qs])
    T2 = _whiten(G2, 0.25)
    # T1 and T2 stay factored: their product mixes column scales that
    # span orders of magnitude before the whitening of Y·T1.
    B = T2.T @ (T1.T @ M)  # = QᵀA (s, n)
    Ub, sv, Vt = torch.linalg.svd(B, full_matrices=False)
    rot2 = T2 @ Ub[:, :k]  # (Y·T1)·rot2 = U

    def u_block(i: int):
        """Rows [i·block_rows, (i+1)·block_rows) of U."""
        us = [(panel_y(a, Omq) @ on(T1, a).to(a.dtype)) @ on(rot2, a).to(a.dtype)
              for a in slots(block_fn(i * block_rows, block_rows))]
        return us[0] if mesh is None else torch.cat([u.to(dev) for u in us])

    if materialize_u:
        return torch.cat([u_block(i) for i in range(nblocks)], dim=0), sv[:k], Vt[:k].T
    return u_block, sv[:k], Vt[:k].T


def synthetic_lowrank_blocks(context: SketchContext, m: int, n: int, r: int,
                             noise: float = 0.0, dtype=torch.float32, decay: float = 1.0,
                             device=None):
    """Row-panel generator of ``A = L·diag(w)·Rᵀ + noise·E`` with L (m, r),
    R (n, r) and E (m, n) counter-generated and ``w[j] = decay^j``
    (≙ the synthetic ``--profile`` matrix of ``nla/skylark_svd.cpp``).
    ``block_fn(start_row, rows)`` returns rows ``[start_row, start_row +
    rows)`` of A, each a window of the logical stream, so any panel is
    bitwise the same rows of any other split."""
    base_L = context.reserve(m * r)
    base_E = context.reserve(m * n)
    R = gaussian_matrix(context, (n, r), dtype=dtype, device=device)
    wdtype = torch.promote_types(dtype, torch.float32)
    w = torch.tensor(decay, dtype=wdtype, device=R.device) ** torch.arange(
        r, device=R.device)
    Rw = (R * w[None, :].to(dtype)).T  # (r, n)
    scale = torch.tensor(noise, dtype=dtype, device=R.device)

    def block_fn(start_row: int, rows: int) -> torch.Tensor:
        Lb = sample_window("normal", context.seed, base_L, (m, r), offset=(start_row, 0),
                           shape=(rows, r), dtype=dtype, device=R.device)
        Ab = Lb @ Rw
        if noise:
            Eb = sample_window("normal", context.seed, base_E, (m, n),
                               offset=(start_row, 0), shape=(rows, n), dtype=dtype,
                               device=R.device)
            Ab = Ab + scale * Eb
        return Ab

    return block_fn
