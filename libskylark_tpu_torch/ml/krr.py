"""Kernel ridge regression: the in-core solver strategies of ``ml/krr.hpp``
(port of ``libskylark_tpu/ml/krr.py``).

1. ``kernel_ridge``: exact — Gram + Cholesky solve (≙ ``KernelRidge``,
   krr.hpp:49-92).
2. ``approximate_kernel_ridge``: feature map + ridge solve in feature
   space (≙ ``ApproximateKernelRidge``, krr.hpp:94-197), guarded.
3. ``sketched_approximate_kernel_ridge``: additionally sketches the
   feature-space ridge problem down to t rows with FJLT or CWT (≙
   ``SketchedApproximateKernelRidge``, krr.hpp:199-310).
4. ``faster_kernel_ridge``: CG on the full Gram with the random-feature
   covariance preconditioner (≙ ``FasterKernelRidge`` +
   ``feature_map_precond_t``, krr.hpp:312-543).
5. ``large_scale_kernel_ridge``: memory-bounded block coordinate descent
   over feature-map chunks with cached Cholesky factors (≙
   ``LargeScaleKernelRidge``, krr.hpp:546-727).

Convention: X (n, d) rows-as-examples; Y (n,) or (n, t).  Feature-space
solvers return ``FeatureMapModel``; kernel-space ones ``KernelModel``.
A tensor is computed where it lies; array-likes move to ``device``.

Every product that feeds a Cholesky factor runs in at least f32 with
TF32 off (``_device.py`` turns it off at import): the JAX package pins
those products to ``precision="highest"``, because a truncated product
can push ``ZᵀZ + λI`` indefinite and the factor to silent NaNs.  bf16
features keep their dtype in the returned model, and their factor is
computed in f32.  A Cholesky factor that fails comes back NaN, as
``jax.scipy.linalg.cho_factor``'s does, without a host read.

``approximate_kernel_ridge`` consults the policy layer (kind ``"krr"``)
and writes its decision into ``model.info["policy"]``: a matured
profile may run the ridge solve on bf16 features first, escalating to
the feature dtype when that solve falls back or fails its sentinel; the
run is recorded in the store.
``KrrParams.checkpoint_dir`` runs faster KRR's CG on the resilient
runner, checkpointed every ``checkpoint_every`` iterations.

Out of core: ``streaming_approximate_kernel_ridge`` accumulates the
feature normal equations over ``(X_block, y_block)`` batches
(``streaming.kernel_ridge``), and ``streaming_kernel_ridge`` streams
examples and features both (the block coordinate descent of
``large_scale_kernel_ridge`` with each chunk's features regenerated per
row panel).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import guard, plans, policy, telemetry
from .._device import as_tensor, is_sharded
from ..core.context import SketchContext
from ..core.params import Params
from ..core.precision import mm_f32
from ..core.random import _const
from ..parallel import routes
from ..sketch.base import Dimension, create_sketch
from ..solvers.krylov import KrylovParams, cg
from ..resilient import chunked
from ..utils.exceptions import NumericalHealthError
from ..utils.sparse import is_sparse
from .kernels import Kernel, _dense
from .model import FeatureMapModel, KernelModel

__all__ = [
    "KrrParams",
    "kernel_ridge",
    "approximate_kernel_ridge",
    "sketched_approximate_kernel_ridge",
    "faster_kernel_ridge",
    "large_scale_kernel_ridge",
    "streaming_kernel_ridge",
    "streaming_approximate_kernel_ridge",
]

@dataclass
class KrrParams(Params):
    """≙ ``krr_params_t`` (krr.hpp:8-46)."""

    use_fast: bool = False          # fast feature transforms (Fastfood)
    sketched_rr: bool = False       # sketch the feature ridge problem
    sketch_size: int = -1           # -1 → 4·s (krr.hpp:146)
    fast_sketch: bool = False       # CWT instead of FJLT for the sketch
    tolerance: float = 1e-3         # iterative tolerance
    res_print: int = 10
    iter_lim: int = 1000
    max_split: int = 0              # feature chunk size (large-scale)
    # Faster KRR's CG on the resilient runner (checkpoint and resume).
    checkpoint_dir: str | None = None
    checkpoint_every: int = 25
    resume: bool = False


def _psd_gram(A, B):
    """A·B for a Gram that feeds a Cholesky factor, in A's dtype promoted
    to at least f32 (bf16 products are exact in f32 and the sum stays
    f32, the JAX package's ``preferred_element_type``): two bf16 operands
    through :func:`~..core.precision.mm_f32`."""
    if A.dtype == B.dtype == torch.bfloat16:
        return mm_f32(A, B)
    acc = torch.promote_types(A.dtype, torch.float32)
    return torch.matmul(A.to(acc), B.to(acc))


def _mm(A, B):
    """A·B in the promoted dtype of the two (jnp.matmul's promotion)."""
    dt = torch.promote_types(A.dtype, B.dtype)
    return torch.matmul(A.to(dt), B.to(dt))


def _plus_lam_eye(G, lam, dtype):
    """``G + lam·I`` with lam rounded to ``dtype`` first, as the JAX
    package's ``lam * jnp.eye(n, dtype=dtype)`` rounds it."""
    eye = torch.eye(G.shape[-1], dtype=dtype, device=G.device)
    return G + _const(lam, dtype, G.device) * eye


def _cholesky(G):
    """Lower Cholesky factor of G (batched over leading axes); all NaN
    where G is not positive definite, without a host read."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _cho_solve(L, B):
    """Solve (L·Lᵀ)·X = B in the promoted dtype of L and B."""
    dt = torch.promote_types(L.dtype, B.dtype)
    return torch.cholesky_solve(B.to(dt), L.to(dt))


def _as2d(Y):
    return Y[:, None] if Y.ndim == 1 else Y


def _rows_operands(X, Y, device):
    """``(X, Y2)``: X (``routes.operands``) and Y as (n, t), split into a
    row-sharded X's row blocks (the features, ZᵀZ and ZᵀY then run per
    slot and are psum'd: the JAX package's ``fully_replicated``
    points)."""
    X, Y = routes.operands(X, Y, device)
    return X, routes.split_rows(_as2d(Y), X)


def _tag(params: KrrParams) -> str:
    return "fast" if params.use_fast else "regular"


def kernel_ridge(kernel: Kernel, X, Y, lam: float, params: KrrParams | None = None, *,
                 device=None):
    """Exact KRR: solve (K + λI)·A = Y; returns a ``KernelModel``."""
    X = _dense(X, device)
    Y2 = _as2d(as_tensor(Y, X.device))
    K = kernel.gram(X)
    # K is this call's own: λ goes onto its diagonal in place (the same
    # values as K + λI, without a second n × n buffer).
    K.diagonal().add_(_const(lam, K.dtype, K.device))
    A = _cho_solve(_cholesky(K), Y2)
    return KernelModel(kernel, X, A)


def approximate_kernel_ridge(
    kernel: Kernel,
    X,
    Y,
    lam: float,
    s: int,
    context: SketchContext,
    params: KrrParams | None = None,
    *,
    device=None,
):
    """Feature map Z = S(X) (n, s), then ridge: (ZᵀZ + λI)W = ZᵀY.

    ≙ ``ApproximateKernelRidge`` (krr.hpp:94-197).  Returns a
    ``FeatureMapModel``; under guarding (``SKYLARK_GUARD``, default on) a
    non-finite Cholesky factor (a singular or indefinite-by-rounding
    regularized Gram) falls back to the eigh pseudoinverse solve, the
    coefficients pass a finiteness sentinel, and
    ``model.info["recovery"]`` records the attempts and
    ``model.info["policy"]`` the routing decision.  A matured profile
    (``policy``) may solve on bf16 features first; a fallback or a
    failed sentinel there escalates to the feature dtype (``escalated``
    in the decision), and W keeps the feature dtype either way.
    """
    params = params or KrrParams()
    X, Y2 = _rows_operands(X, Y, device)
    S = kernel.create_rft(s, _tag(params), context)
    Z = plans.apply(S, X, Dimension.ROWWISE)  # (n, s)
    if params.sketched_rr:
        return _solve_sketched_ridge(S, Z, Y2, lam, s, context, params)
    guarded = guard.enabled()
    decision = policy.consult("krr", m=X.shape[0], n=int(s), targets=Y2.shape[1],
                              dtype=Z.dtype, sparse=is_sparse(X), device=routes.device0(Z),
                              guard_on=guarded)

    def ridge_solve(Zs):
        """(W in Zs's dtype, the recovery report, whether it fell back)."""
        report = (guard.RecoveryReport(stage="approximate_krr") if guarded
                  else guard.RecoveryReport.disabled("approximate_krr"))
        # Factor and solve in _psd_gram's ≥ f32 dtype; the coefficients
        # come back in the feature dtype.
        G = _plus_lam_eye(routes.tsum(lambda z: _psd_gram(z.T, z), Zs), lam, Zs.dtype)
        L = _cholesky(G)
        rhs = routes.tsum(lambda z, y: _mm(z.T, y), Zs, Y2)
        fellback = guarded and not guard.tree_all_finite(L)
        if fellback:
            dt = torch.promote_types(G.dtype, rhs.dtype)
            W = guard.pinv_psd_solve(G.to(dt), rhs.to(dt)).to(Zs.dtype)
            report.record("fallback", verdict=guard.FALLBACK,
                          detail="non-finite Cholesky factor; eigh pseudoinverse solve")
            report.recovered = True
        else:
            W = _cho_solve(L, rhs).to(Zs.dtype)
        if guarded:
            guard.check_finite(W, "approximate_krr", report=report)
        return W, report, fellback

    bf16_note = None
    if decision.compute_dtype == "bfloat16":
        # bf16-first: a fallback or a failed sentinel escalates the solve
        # to the feature dtype and retires the rung for this key.
        try:
            W, report, fellback = ridge_solve(
                routes.map_shards(Z, lambda z: z.to(torch.bfloat16)))
        except NumericalHealthError:
            fellback = True
        if fellback:
            decision.escalated = True
            bf16_note = "fail"
            W, report, _ = ridge_solve(Z)
        else:
            W = W.to(Z.dtype)
    else:
        W, report, _ = ridge_solve(Z)
    model = FeatureMapModel([S], W)
    model.info = {"recovery": report.to_dict(), "policy": decision.to_dict()}
    policy.observe(decision, model.info, bf16=bf16_note)
    telemetry.run_summary("approximate_krr", model.info)
    return model


def _solve_sketched_ridge(S, Z, Y2, lam, s, context, params):
    """Sketch the (n, s) ridge problem down to t rows (krr.hpp:135-180)."""
    n = Z.shape[0]
    t = params.sketch_size if params.sketch_size != -1 else min(4 * s, n)
    sk_type = "CWT" if params.fast_sketch else "FJLT"
    R = create_sketch(sk_type, n, t, context)
    SZ = plans.apply(R, Z, Dimension.COLUMNWISE)  # (t, s)
    SY = plans.apply(R, Y2, Dimension.COLUMNWISE)  # (t, k)
    G = _plus_lam_eye(_psd_gram(SZ.T, SZ), lam, Z.dtype)
    W = _cho_solve(_cholesky(G), _mm(SZ.T, SY)).to(Z.dtype)
    return FeatureMapModel([S], W)


def sketched_approximate_kernel_ridge(
    kernel, X, Y, lam, s, context, params: KrrParams | None = None, *, device=None
):
    """≙ ``SketchedApproximateKernelRidge`` (krr.hpp:199-310)."""
    params = dataclasses.replace(params or KrrParams(), sketched_rr=True)
    return approximate_kernel_ridge(kernel, X, Y, lam, s, context, params, device=device)


class _FeatureMapPrecond:
    """(ZᵀZ + λI)⁻¹ as a preconditioner for (K + λI), via Woodbury.

    ≙ ``feature_map_precond_t`` (krr.hpp:312-450): U = Z (s, n) features;
    C = I + U·Uᵀ/λ, L = chol(C), Ũ = L⁻¹U/λ; apply(B) = B/λ − Ũᵀ(Ũ·B).
    Pure tensor work on fixed operands, so CG's step over it can be
    captured as a CUDA graph (``graphable``).
    """

    graphable = True

    def __init__(self, kernel, lam, X, s, context, params):
        S = kernel.create_rft(s, _tag(params), context)
        U = plans.apply(S, X, Dimension.ROWWISE).T  # (s, n)
        lam = _const(lam, U.dtype, U.device)
        C = torch.eye(s, dtype=U.dtype, device=U.device) + _psd_gram(U, U.T) / lam
        L = _cholesky(C)
        # Solve in C's ≥ f32 dtype, store Ũ back in the feature dtype —
        # the (s, n) buffer is the preconditioner's memory footprint.
        self.U = (torch.linalg.solve_triangular(L, U.to(C.dtype), upper=False)
                  / lam).to(U.dtype)
        self.lam = lam

    def apply(self, B):
        return B / self.lam - self.U.T @ (self.U @ B)

    def apply_adjoint(self, B):
        return self.apply(B)


def faster_kernel_ridge(
    kernel: Kernel,
    X,
    Y,
    lam: float,
    s: int,
    context: SketchContext,
    params: KrrParams | None = None,
    *,
    device=None,
):
    """CG on (K + λI)·A = Y preconditioned by the random-feature
    covariance (≙ ``FasterKernelRidge``, krr.hpp:452-543).  ``model.info``
    is CG's ``{"iterations", "flag", "resid"}``.

    With ``params.checkpoint_dir`` the CG runs on the resilient runner
    (``cg_chunked``, a checkpoint every ``checkpoint_every`` iterations,
    ``resume`` to restart from the newest one).  The Gram and the
    preconditioner are rebuilt from ``(X, context)`` on resume, so only
    the CG state is checkpointed; chunked CG steps are the one-shot
    steps, so the result is bitwise the unchecked solve's."""
    params = params or KrrParams()
    X = _dense(X, device)
    Y2 = _as2d(as_tensor(Y, X.device))
    K = kernel.gram(X)
    K.diagonal().add_(_const(lam, K.dtype, K.device))  # K + λI, in place
    P = _FeatureMapPrecond(kernel, lam, X, s, context, params)
    kp = KrylovParams(tolerance=params.tolerance, iter_lim=params.iter_lim)
    dt = torch.promote_types(K.dtype, Y2.dtype)
    if params.checkpoint_dir:
        from ..resilient import ResilientParams, ResilientRunner
        from ..solvers.krylov import cg_chunked

        A, info = ResilientRunner(
            cg_chunked(K.to(dt), Y2.to(dt), precond=P, params=kp),
            ResilientParams(am_i_printing=params.am_i_printing, log_level=params.log_level,
                            prefix=params.prefix, checkpoint_dir=params.checkpoint_dir,
                            checkpoint_every=params.checkpoint_every, resume=params.resume),
        ).run()
    else:
        A, info = cg(K.to(dt), Y2.to(dt), precond=P, params=kp)
    model = KernelModel(kernel, X, A)
    model.info = info
    return model


def _chunk_sizes(d: int, s: int, params: KrrParams) -> list[int]:
    """Feature-chunk sizes (≙ krr.hpp:573-592), the JAX package's split."""
    sinc = d if params.max_split == 0 else max(1, params.max_split // 2)
    sizes = []
    remains = s
    while remains > 0:
        this = remains if remains <= 2 * sinc else sinc
        sizes.append(this)
        remains -= this
    return sizes


def large_scale_kernel_ridge(
    kernel: Kernel,
    X,
    Y,
    lam: float,
    s: int,
    context: SketchContext,
    params: KrrParams | None = None,
    *,
    device=None,
):
    """Memory-bounded block coordinate descent over feature chunks.

    ≙ ``LargeScaleKernelRidge`` (krr.hpp:546-727): chunk the s features
    into C transforms of ~max_split/2 each; iterate
      ZR = Z_c·R − λ·W_c;  δ = (Z_cZ_cᵀ + λI)⁻¹·ZR  (cached Cholesky);
      W_c += δ;  R −= Z_cᵀ·δ
    until the relative update is below tolerance.  Each chunk's Z is
    recomputed from its counter-based map on every sweep and released
    before the next chunk's (PyTorch's allocator reuses its memory in
    stream order); only the per-chunk factors are cached.  One host read
    per sweep gives the relative update.
    """
    params = params or KrrParams()
    X, Y2 = _rows_operands(X, Y, device)
    n, d = X.shape
    dev = routes.device0(X)

    sizes = _chunk_sizes(d, s, params)
    maps = [kernel.create_rft(sz, _tag(params), context) for sz in sizes]

    def chunk_Z(c):
        return plans.apply(maps[c], X, Dimension.ROWWISE)  # (n, sz), per slot

    t = Y2.shape[1]
    factors, Ws, R = [], None, None

    def sweep():
        """One pass over the chunks; the first builds the cached factors
        (krr.hpp:608-660) and takes the state's dtype from the first
        chunk's features.  Returns Σ‖δ‖² (f64, on the device).  A
        sharded X keeps Z and R per slot; Z·R and Z·Zᵀ are psum'd."""
        nonlocal Ws, R, dtype, lam_
        delsize = torch.zeros((), dtype=torch.float64, device=dev)
        for c in range(len(maps)):
            Z = chunk_Z(c)
            if Ws is None:
                dtype = Z.dtype
                lam_ = _const(lam, dtype, dev)
                Ws = [torch.zeros((sz, t), dtype=dtype, device=dev) for sz in sizes]
                R = routes.map_shards(Y2, lambda y: y.to(dtype))
            if len(factors) == c:
                factors.append(_cholesky(_plus_lam_eye(
                    routes.tsum(lambda z: _psd_gram(z.T, z), Z), lam, dtype)))
            ZR = routes.tsum(lambda z, r: z.T @ r, Z, R) - lam_ * Ws[c]
            # cast back: the f32 factor solve must not promote the resident
            # (n, t) R / Ws state out of the feature dtype
            delta = _cho_solve(factors[c], ZR).to(dtype)
            Ws[c] = Ws[c] + delta
            R = routes.rows_map(lambda z, r, dl: r - z @ dl, Z, R, delta)
            delsize = delsize + torch.sum(delta * delta).double()
            del Z  # release chunk c before chunk c + 1 is made
        return delsize

    dtype = lam_ = None
    sweep()
    for it in range(1, params.iter_lim):
        delsize = sweep()
        wnorm = torch.sqrt(sum(torch.sum(W * W) for W in Ws)).double()
        delsize, wnorm = torch.stack([delsize, wnorm]).tolist()  # one host read
        reldel = (delsize ** 0.5) / max(wnorm, 1e-30)
        params.log(2, f"iteration {it}, relupdate = {reldel:.2e}")
        if reldel < params.tolerance:
            break

    W = torch.cat(Ws, dim=0)
    return FeatureMapModel(maps, W)


def streaming_approximate_kernel_ridge(kernel: Kernel, source, lam: float, s: int,
                                       context: SketchContext, params: KrrParams | None = None,
                                       *, targets: int = 1, stream_params=None,
                                       fault_plan=None):
    """One-pass :func:`approximate_kernel_ridge` over ``(X_block,
    y_block)`` batches, X never resident: the normal equations accumulate
    per batch through the ``streaming`` engine, which brings the prefetch
    pipeline and checkpoint/resume (``stream_params``, a
    :class:`~libskylark_tpu_torch.streaming.StreamParams`).  Trained on
    the same ``context`` the model equals the in-core solver's up to the
    per-batch order of summation.  A batch that NaN-poisons the
    accumulators is replayed at its chunk boundary, a non-finite Cholesky
    factor reroutes to the eigh pseudoinverse, and ``fault_plan``
    (``nan_at``/``bad_sketch_at`` by batch index) injects those faults;
    ``model.info["recovery"]`` records them."""
    from .. import streaming

    return streaming.kernel_ridge(source, kernel, lam, s, context, targets=targets,
                                  krr_params=params, params=stream_params,
                                  fault_plan=fault_plan)


def _panel_mm(a, b):
    """a·b in f32 from operands in the feature dtype or f32: the JAX
    package's ``dot_general(..., preferred_element_type=f32)`` — exact
    upcasts, products and sums in f32; two bf16 operands through
    :func:`~..core.precision.mm_f32`."""
    if a.dtype == b.dtype == torch.bfloat16:
        return mm_f32(a, b)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def streaming_krr_chunk_programs(maps, c, sz, nb, block_rows, t, lam, block_fn, feature_dtype):
    """The three panel passes of feature chunk ``c`` in the streaming-KRR
    sweep: ``(gram(*bargs), zr(out, R3, Wc, *bargs), apply_delta(R3,
    delta, *bargs))``.

    Each pass regenerates the chunk's (block_rows, sz) feature panel from
    ``block_fn(start, block_rows, *bargs)`` panel by panel, with the map's
    W realized once (``hoistable_operands``), and contracts it in f32:

    - ``gram``: ``Σ_p Z_pᵀ·Z_p + λI``, returned;
    - ``zr``: ``Σ_p Z_pᵀ·R_p − λ·W_c`` written into ``out``;
    - ``apply_delta``: ``R_p ← R_p − Z_p·δ`` in place on the panel-major
      (nb, block_rows, t) residual.

    ``zr`` and ``apply_delta`` write into their arguments and create no
    tensor from a Python number, so a whole pass can be captured as a
    CUDA graph over fixed buffers and replayed.

    A ``block_fn`` may return a row-sharded panel (a
    :class:`~libskylark_tpu_torch.parallel.mesh.Sharded`, the JAX
    package's ``constrain_rows(panel, mesh)``): each slot makes its rows'
    features, the Gram and ``Zᵀ·R`` are psum'd in slot order, and each
    slot updates its rows of R.
    """
    S = maps[c]
    ops_by_device = {}

    def features(x):
        key = str(x.device)
        if key not in ops_by_device:
            ops_by_device[key] = S.hoistable_operands(feature_dtype, x.device)
        return S.apply_with_operands(ops_by_device[key], x.to(feature_dtype), Dimension.ROWWISE)

    def panels(bargs):
        for p in range(nb):
            Xp = block_fn(p * block_rows, block_rows, *bargs)
            yield p, routes.rows_map(features, routes.operand(Xp))

    def gram(*bargs, device=None):
        G = None
        for _, Zp in panels(bargs):
            blk = routes.tsum(lambda z: _panel_mm(z.T, z), Zp, device=device)
            G = blk if G is None else G + blk
        return G + _const(lam, torch.float32, G.device) * torch.eye(
            sz, dtype=torch.float32, device=G.device)

    def zr(out, R3, Wc, lam_t, *bargs):
        acc = torch.zeros((sz, t), dtype=torch.float32, device=R3.device)
        for p, Zp in panels(bargs):
            acc += routes.tsum(lambda z, r: _panel_mm(z.T, r), Zp,
                               routes.split_rows(R3[p], Zp), device=R3.device)
        out.copy_(acc - lam_t * Wc)
        return out

    def apply_delta(R3, delta, *bargs):
        for p, Zp in panels(bargs):
            if routes.is_sharded(Zp):
                for z, (r0, r1) in zip(Zp.shards, routes.row_blocks(Zp)):
                    R3[p, r0:r1] -= _panel_mm(z, delta.to(z.device, z.dtype)).to(R3.device)
            else:
                R3[p] -= _panel_mm(Zp, delta.to(Zp.dtype))
        return R3

    return gram, zr, apply_delta


class _Pass:
    """A panel pass run eagerly, or captured once as a CUDA graph over
    its (fixed) argument tensors and replayed: the same kernels on the
    same buffers, so the two are bitwise the same.  The passes of one
    solve share a memory ``pool``: only their temporaries live there,
    and they are replayed in the order they were captured."""

    def __init__(self, fn, args, graphed: bool, pool=None):
        self.fn, self.args, self.graph = fn, args, None
        if graphed:
            device = args[0].device
            side = chunked._capture_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool)
                try:
                    fn(*args)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)

    def __call__(self):
        if self.graph is None:
            self.fn(*self.args)
        else:
            self.graph.replay()


def streaming_kernel_ridge(
    kernel: Kernel,
    block_fn,
    shape: tuple[int, int],
    Y,
    lam: float,
    s: int,
    context: SketchContext,
    params: KrrParams | None = None,
    block_rows: int = 262_144,
    feature_dtype=torch.bfloat16,
    block_args: tuple = (),
    timer=None,
    *,
    device=None,
):
    """Row-streamed block coordinate descent: the single-card face of the
    10M × 4096 north-star shape, where neither X (80 GB in bf16) nor a
    chunk's (n, s) features fit.

    ``block_fn(start_row, rows, *block_args)`` returns rows ``[start_row,
    start_row + rows)`` of X; it must return the same panel every time it
    is called.  Each chunk's features are regenerated per panel, so only
    O(panel · max(d, sz)) feature memory plus the (n, t) f32 residual is
    resident.  Per sweep each chunk makes two panel passes (ZR = Z_c·R,
    then R ← R − Z_cᵀ·δ) with ``large_scale_kernel_ridge``'s update
    equations; sweep 0 also accumulates the chunk's Gram and caches its
    Cholesky factor.  Features are in ``feature_dtype`` (bf16 by
    default), every contraction in f32.

    On the card each ZR and update pass is captured as a CUDA graph at
    its first use and replayed on later sweeps (the panels' shapes
    repeat); ``resilient.chunked.CUDA_GRAPHS = False`` runs them eagerly,
    bitwise the same.  A captured ``block_fn`` must not read the host.

    ``timer``: an optional ``utils.PhaseTimer``; sweep 0 lands in phase
    ``"sweep0"``, later sweeps in ``"sweep"``.  ``model.info`` holds
    ``"residual"`` (‖R‖ after each sweep, read with the relative update)
    and ``"relupdate"``.
    """
    import contextlib

    params = params or KrrParams()
    n, d = shape
    if n % block_rows:
        # The largest divisor of n up to the request, unless n splits only
        # into tiny panels (the panel size shapes memory, not results).
        best = max(b for b in range(1, block_rows + 1) if n % b == 0)
        if best < n and best < max(256, block_rows // 16):
            raise ValueError(
                f"n={n} has no usable panel divisor <= {block_rows} (best is {best}); pad "
                "n to a composite size or pass a block_rows that divides it")
        block_rows = best
    nb = n // block_rows
    Y2 = _as2d(as_tensor(Y, device))
    dev = Y2.device
    t = Y2.shape[1]

    sizes = _chunk_sizes(d, s, params)
    maps = [kernel.create_rft(sz, _tag(params), context) for sz in sizes]
    kinds = set()  # whether block_fn's panels were sharded

    def panel_fn(start, rows, *bargs):
        Xp = block_fn(start, rows, *bargs)
        kinds.add(is_sharded(Xp))
        return Xp

    programs = [streaming_krr_chunk_programs(maps, c, sizes[c], nb, block_rows, t, lam,
                                             panel_fn, feature_dtype)
                for c in range(len(maps))]
    graphed, pool = None, None  # decided once sweep 0's first Gram pass has read the panels
    lam_t = _const(lam, torch.float32, dev)
    factors = []
    Ws = [torch.zeros((sz, t), dtype=torch.float32, device=dev) for sz in sizes]
    ZRs = [torch.empty((sz, t), dtype=torch.float32, device=dev) for sz in sizes]
    deltas = [torch.empty((sz, t), dtype=torch.float32, device=dev) for sz in sizes]
    # Panel-major residual, this solver's own buffer (updated in place).
    R = Y2.to(torch.float32).reshape(nb, block_rows, t).clone()
    passes = [None] * len(maps)
    residuals, relupdates = [], []

    # Sweep 0 always runs (the factors must exist): iter_lim=0 is one pass.
    for it in range(max(params.iter_lim, 1)):
        phase = (timer.phase("sweep0" if it == 0 else "sweep") if timer is not None
                 else contextlib.nullcontext())
        with phase as ph:
            delsize = torch.zeros((), dtype=torch.float64, device=dev)
            for c, (gram, zr, apply_delta) in enumerate(programs):
                if it == 0:
                    factors.append(_cholesky(gram(*block_args, device=dev)))
                if graphed is None:
                    # A sharded panel runs its slots eagerly: a capture
                    # would hold the copies between the slots' devices.
                    graphed = chunked.graphable(Y2) and True not in kinds
                    pool = torch.cuda.graph_pool_handle() if graphed else None
                if passes[c] is None:
                    passes[c] = (
                        _Pass(zr, (ZRs[c], R, Ws[c], lam_t, *block_args), graphed, pool),
                        _Pass(apply_delta, (R, deltas[c], *block_args), graphed, pool))
                passes[c][0]()
                deltas[c].copy_(_cho_solve(factors[c], ZRs[c]))
                Ws[c] += deltas[c]
                passes[c][1]()
                delsize = delsize + torch.sum(deltas[c] * deltas[c]).double()
            if ph is not None:
                ph.result = R
        wnorm = torch.sqrt(sum(torch.sum(W * W) for W in Ws)).double()
        rnorm = torch.linalg.vector_norm(R.double())
        delsize, wnorm, rnorm = torch.stack([delsize, wnorm, rnorm]).tolist()  # one host read
        reldel = (delsize ** 0.5) / max(wnorm, 1e-30)
        residuals.append(rnorm)
        relupdates.append(reldel)
        params.log(2, f"iteration {it}, relupdate = {reldel:.2e}")
        if it > 0 and reldel < params.tolerance:
            break

    model = FeatureMapModel(maps, torch.cat(Ws, dim=0))
    model.info = {"residual": residuals, "relupdate": relupdates}
    return model
