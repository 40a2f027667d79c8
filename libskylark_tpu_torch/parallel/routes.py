"""Sharded-input routes: what the JAX package leaves to GSPMD, run slot
by slot on a mesh.

The JAX package hands a sharded ``jax.Array`` to jitted code and XLA
picks the schedule, with ``fully_replicated(...)`` marking the small
replicated matrices.  Torch has no such propagation, so the routes that
take a :class:`~.mesh.Sharded` run one schedule, written here once:

- :func:`operands`: the one place an entry point tells a sharded input
  from a tensor.  A :class:`~.mesh.Sharded` A goes through
  :func:`operand`: resharded once to rows over all of its mesh's axes
  (:func:`~.mesh.reshard`, no slot gathers it); a mesh of one gives its
  one tensor, so the call is the unsharded call, bit for bit;
- :func:`rows_map`: the tall work, per slot on the slot's own rows,
  giving a row-sharded result;
- :func:`tsum`: a per-slot product summed with :func:`~.mesh.psum` in
  slot order onto slot 0's device — the points the JAX package marks
  ``fully_replicated``.  On a tensor both run the function once, so the
  unsharded route is the same code;
- :func:`sketch_apply`: ``S.apply`` of a sharded input.  Rowwise, each
  slot sketches its rows.  Columnwise, each slot sketches its rows at
  their global offset (its counter windows) and one psum merges: a dense
  sketch's Omega window (``collectives._window_product``), a hash
  sketch's bucket and value windows through the ``scatter_rows`` kernel,
  and the FJLT by the route its gate picks (:func:`_fjlt_columnwise`):
  the subsampled-Hadamard GEMM on each slot's rows of G, or the
  Kronecker split of the Walsh-Hadamard transform; a DCT FJLT moves A to
  column blocks and sketches each slot's columns whole;
- :func:`linear_ops`: the matvec and rmatvec of a sharded A for the
  Krylov solvers, ``cond_est`` and the guard: ``A_k·x`` per slot laid
  out in the mesh's row blocks on slot 0's device, ``Σ_k A_kᵀ·y_k`` by
  psum;
- :func:`tsqr`: the QR of a tall sharded A from the slots' R factors.

No route gathers A onto one slot.  Row-space vectors (a right-hand side
b, LSQR's iterates, predictions) are laid out on slot 0's device in the
mesh's row order; they are the size of a column of A, not of A.  A
failure raises; nothing falls back to the unsharded path.
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor, is_sharded
from . import mesh as _mesh
from .mesh import Sharded, _blocks, constrain_rows, psum

__all__ = [
    "is_sharded",
    "operand",
    "operands",
    "row_blocks",
    "device0",
    "rows_map",
    "tsum",
    "split_rows",
    "map_shards",
    "sketch_apply",
    "linear_ops",
    "rmatmul",
    "tsqr",
    "dense_svd",
]


def operand(A):
    """``A`` for a sharded route: a tensor (or anything not sharded) as it
    is; a :class:`Sharded` on a mesh of one, its one tensor; any other
    :class:`Sharded` row-sharded over all of its mesh's axes, resharded
    once without a gather (the JAX package's ``constrain_rows``)."""
    if not isinstance(A, Sharded):
        return A
    if A.mesh.size == 1:
        return A.shards[0]
    if A.shape[0] % A.mesh.size:
        raise ValueError(
            f"a sharded route splits rows over the mesh's {A.mesh.size} slots and "
            f"{A.shape[0]} rows do not divide: pad with parallel.shard_rows_padded")
    return constrain_rows(A, A.mesh)


def operands(A, B=None, device=None):
    """``(A, B)`` for an entry point that takes a sharded A.  A: a
    :class:`Sharded` through :func:`operand`, a ``(matvec, rmatvec)``
    pair as it is, anything else :func:`~.._device.as_tensor` on
    ``device``.  B (None stays None): one tensor in row order on A's
    device, slot 0's for a sharded A (``device`` for a pair); a sharded B
    is gathered there, being a column block of A's height, not A."""
    if isinstance(A, Sharded):
        A = operand(A)
    elif not isinstance(A, tuple):
        A = as_tensor(A, device)
    if B is None:
        return A, None
    if isinstance(A, tuple):
        return A, as_tensor(B, device)
    dev = device0(A)
    if isinstance(B, Sharded):
        B = _mesh.fully_replicated(B).to(dev)
    return A, as_tensor(B, dev)


def row_blocks(A: Sharded) -> list:
    """Per slot, its ``(start, stop)`` rows of the global array."""
    return [(sl[0].start, sl[0].stop) for sl in _blocks(A.mesh, A.spec, A.shape)]


def device0(A) -> torch.device:
    """Where a route's replicated results live: slot 0's device."""
    return A.mesh.device(0) if isinstance(A, Sharded) else A.device


def _lead(xs):
    for x in xs:
        if isinstance(x, Sharded):
            return x
    return None


def _slot_args(xs, lead: Sharded, k: int):
    dev = lead.mesh.device(k)
    out = []
    for x in xs:
        if isinstance(x, Sharded):
            if x.mesh != lead.mesh or row_blocks(x) != row_blocks(lead):
                raise ValueError(f"{x!r} is not laid out as {lead!r}")
            out.append(x.shards[k])
        elif isinstance(x, torch.Tensor):
            out.append(x.to(dev))
        else:
            out.append(x)
    return out


def rows_map(fn, *xs):
    """``fn`` on each slot's rows of the row-sharded arguments (a tensor
    argument goes whole to every slot, on the slot's device): a
    :class:`Sharded` of the results, laid out as the first sharded
    argument.  Without one, ``fn(*xs)``."""
    lead = _lead(xs)
    if lead is None:
        return fn(*xs)
    outs = [fn(*_slot_args(xs, lead, k)) for k in range(lead.mesh.size)]
    shape = (lead.shape[0],) + tuple(outs[0].shape[1:])
    return Sharded(lead.mesh, lead.spec[:1], shape, outs)


def tsum(fn, *xs, device=None):
    """``Σ_k fn(slot k's arguments)``, summed with :func:`~.mesh.psum` in
    slot order on ``device`` (slot 0's by default).  Without a sharded
    argument, ``fn(*xs)``."""
    lead = _lead(xs)
    if lead is None:
        return fn(*xs)
    parts = [fn(*_slot_args(xs, lead, k)) for k in range(lead.mesh.size)]
    return psum(parts, lead.mesh.device(0) if device is None else device)


def split_rows(t, like):
    """A row-space tensor ``t`` split into ``like``'s row blocks, each on
    its slot's device; ``t`` itself where ``like`` is not sharded."""
    if not isinstance(like, Sharded):
        return t
    if isinstance(t, Sharded):
        return t if row_blocks(t) == row_blocks(like) and t.mesh == like.mesh else \
            _mesh.shard(t, like.mesh, *like.spec[:1])
    return Sharded(like.mesh, like.spec[:1], t.shape,
                   [t[a:b].to(like.mesh.device(k)) for k, (a, b) in enumerate(row_blocks(like))])


def map_shards(x, fn):
    """``fn`` on every shard of ``x`` (a dtype cast, a rounding), or on
    ``x`` itself."""
    if not isinstance(x, Sharded):
        return fn(x)
    return Sharded(x.mesh, x.spec, x.shape, [fn(t) for t in x.shards])


# -- sketches ----------------------------------------------------------------


def sketch_apply(S, A, dim):
    """``S.apply(A, dim)`` of a sharded ``A``.  ROWWISE on row-sharded A:
    a row-sharded result, each slot sketching its rows.  COLUMNWISE: the
    (S, m) sketch as one tensor on slot 0's device, each slot's partial
    ``S[:, rows_k]·A_k`` merged by one psum in slot order."""
    from ..sketch.base import Dimension

    dim = Dimension.of(dim)
    A = operand(A)
    if not isinstance(A, Sharded):
        return S.apply(A, dim)
    if A.ndim == 1:
        # A vector's only axis is the sharded and the sketched one.
        out = sketch_apply(S, rows_map(lambda a: a[:, None], A), Dimension.COLUMNWISE)
        return out[:, 0]
    if dim is Dimension.ROWWISE:
        return rows_map(lambda a: S.apply(a, Dimension.ROWWISE), A)
    if A.shape[0] != S.n:
        raise ValueError(f"columnwise apply needs A with {S.n} rows, got {A.shape}")
    A = map_shards(A, lambda t: t if t.is_floating_point() else t.to(torch.float32))
    from ..sketch.dense import DenseSketch
    from ..sketch.fjlt import FJLT

    if isinstance(S, FJLT):
        return _fjlt_columnwise(S, A)
    if isinstance(S, DenseSketch):
        from .collectives import _window_product

        part = _window_product
    else:
        def part(S, a, off):
            return S.apply_slice(a, off, Dimension.COLUMNWISE)

    parts = [part(S, a, r0) for a, (r0, _) in zip(A.shards, row_blocks(A))]
    return S.finalize_slices(psum(parts, A.mesh.device(0)), Dimension.COLUMNWISE)


def _block_rfut(x: torch.Tensor, d: torch.Tensor, o: int, L: int) -> torch.Tensor:
    """The orthonormal WHT of length ``L`` of ``d ⊙ x`` placed at rows
    ``[o, o + len)`` of a zero block, as (L, m): the ``rfut_rowwise``
    kernel where its gate holds at that length (x transposed in and out),
    else the plain Kronecker ``wht``."""
    from ..sketch import kernels_fut
    from ..sketch.fut import wht

    k, m = x.shape
    if x.dtype in (torch.float32, torch.bfloat16) and kernels_fut.supported(m, o + k, L):
        if o == 0:
            xr, dr = x.T.contiguous(), d.contiguous()
        else:
            xr = x.new_zeros((m, o + k))
            xr[:, o:] = x.T
            dr = d.new_zeros((o + k,))
            dr[o:] = d
        return kernels_fut.rfut_rowwise(xr, dr, L).T.contiguous()
    X = x.new_zeros((L, m))
    X[o:o + k] = x * d[:, None]
    return wht(X, axis=0)


def _fjlt_columnwise(S, A: Sharded) -> torch.Tensor:
    """Columnwise FJLT of a row-sharded A, by the route the unsharded
    apply's gate picks: the DCT by :func:`_fjlt_dct_columnwise`; the WHT
    by the subsampled-Hadamard GEMM where ``S._gemm_wins`` holds (each
    slot multiplies its rows of G with its block, one psum in slot order,
    then the scale: the JAX package's GSPMD matmul), else by the
    Kronecker split of the Walsh-Hadamard transform: with q a power of
    two up to the slot count and L = NB/q, ``H_NB = H_q ⊗ H_L`` in
    Sylvester order, so output row j (sample c = c_hi·L + c_lo) is
    ``√(L/S)·Σ_a H_q[c_hi, a]·T_a[c_lo]`` with ``T_a`` the length-L RFUT
    of block a of D ⊙ A.  Each slot transforms the blocks its rows touch
    (its rows in place, zeros elsewhere: linearity covers a slot that
    straddles two blocks, and N < NB), gathers the sampled rows with
    ``gather_scaled_rows`` and the sign ``H_q[c_hi, a] =
    (-1)^popcount(c_hi & a)``; one psum merges.  The WHT routes agree
    with the unsharded apply to rounding: the adds run in another
    order."""
    from ..core.random import _const
    from ..sketch import kernels_window
    from ..sketch.fjlt import _parity

    if S._fut_name != "wht":
        return _fjlt_dct_columnwise(S, A)
    if S._gemm_wins(A.dtype):
        parts = [S._srht_sum(a, False, rows=(r0, r1))
                 for a, (r0, r1) in zip(A.shards, row_blocks(A))]
        return S._srht_scale(psum(parts, A.mesh.device(0)), A.dtype)
    nb, p = S._nb, A.mesh.size
    bits = min(p.bit_length() - 1, nb.bit_length() - 1)
    L = nb >> bits
    scale = math.sqrt(L / S.s)
    parts = []
    for a, (r0, r1) in zip(A.shards, row_blocks(A)):
        dev, dtype = a.device, a.dtype
        D = S._rfut.diagonal(dtype, dev)[r0:r1]
        idx = S.sample_indices(dev).long()
        c_hi, c_lo = idx // L, (idx % L).to(torch.int32)
        part = None
        for blk in range(r0 // L, (r1 - 1) // L + 1):
            lo, hi = max(r0, blk * L), min(r1, (blk + 1) * L)
            T = _block_rfut(a[lo - r0:hi - r0], D[lo - r0:hi - r0], lo - blk * L, L)
            if dtype in (torch.float32, torch.bfloat16):
                g = kernels_window.gather_scaled_rows(T, c_lo, scale)
            else:
                g = T.index_select(0, c_lo.long()) * _const(scale, dtype, dev)
            sign = (1 - 2 * _parity(c_hi & blk)).to(dtype)
            g = g * sign[:, None]
            part = g if part is None else part + g
        parts.append(part)
    return psum(parts, A.mesh.device(0))


def _fjlt_dct_columnwise(S, A: Sharded) -> torch.Tensor:
    """Columnwise FJLT of a row-sharded A under a transform that does not
    split over row blocks (the DCT).  A columnwise sketch acts on each
    column alone, so A is moved to column blocks, slot k receiving its
    columns of every row block (the all-to-all of ``mesh.reshard``, with
    blocks as ``torch.tensor_split`` cuts them, so any width works), each
    slot runs the unsharded apply on its (N, m_k) block, and the (S, m_k)
    results are joined on slot 0's device.  Each column takes the same
    transform and gather as in the unsharded apply; only an FFT library's
    blocking of a batch may round it differently."""
    from ..sketch.base import Dimension

    dev0, m = A.mesh.device(0), A.shape[1]
    outs = []
    for k, cols in enumerate(torch.arange(m).tensor_split(A.mesh.size)):
        if not len(cols):
            continue
        c0, c1 = int(cols[0]), int(cols[-1]) + 1
        dev = A.mesh.device(k)
        block = torch.cat([a[:, c0:c1].to(dev) for a in A.shards])
        outs.append(S.apply(block, Dimension.COLUMNWISE).to(dev0))
    return torch.cat(outs, dim=1)


# -- operators and factorizations ----------------------------------------------


def linear_ops(A):
    """``(matvec, rmatvec)`` of a sharded A: ``x ↦ [A_0·x; …; A_{p-1}·x]``
    on slot 0's device in the mesh's row order, and ``y ↦ Σ_k A_kᵀ·y_k``
    (y split into the row blocks, or already sharded as A) by psum.  A
    mesh of one gives the unsharded pair."""
    from ..utils.sparse import linear_ops as local_ops

    A = operand(A)
    if not isinstance(A, Sharded):
        return local_ops(A)
    dev0 = A.mesh.device(0)
    blocks = row_blocks(A)

    def matvec(x):
        return torch.cat([(a @ x.to(a.device)).to(dev0) for a in A.shards])

    def rmatvec(y):
        pieces = y.shards if isinstance(y, Sharded) else [y[r0:r1] for r0, r1 in blocks]
        return psum([a.T @ t.to(a.device) for a, t in zip(A.shards, pieces)], dev0)

    return matvec, rmatvec


def rmatmul(A, Y):
    """``Aᵀ·Y`` for Y laid out as A (or a row-space tensor, split)."""
    return tsum(lambda a, y: a.T @ y, A, split_rows(Y, A))


def tsqr(A):
    """``(Q, R)`` of a tall row-sharded A, ``A = Q·R`` with Q row-sharded
    as A: each slot factors its rows, the stacked R factors are factored
    once on slot 0's device (the TSQR tree of depth one), and each slot
    multiplies its Q by its block of that Q.  A tensor takes
    ``torch.linalg.qr``."""
    if not isinstance(A, Sharded):
        return torch.linalg.qr(A, mode="reduced")
    dev0 = A.mesh.device(0)
    qr = [torch.linalg.qr(a, mode="reduced") for a in A.shards]
    Q2, R = torch.linalg.qr(torch.cat([r.to(dev0) for _, r in qr]), mode="reduced")
    outs, at = [], 0
    for q, r in qr:
        h = r.shape[0]
        outs.append(q @ Q2[at:at + h].to(q.device))
        at += h
    return Sharded(A.mesh, A.spec[:1], (A.shape[0], R.shape[1]), outs), R


def dense_svd(A):
    """The thin SVD ``(U, s, Vh)`` of a tall A, U row-sharded as a sharded
    A: the SVD of the TSQR's R, its U carried back through Q."""
    if not isinstance(A, Sharded):
        return torch.linalg.svd(A, full_matrices=False)
    Q, R = tsqr(A)
    Ur, s, Vh = torch.linalg.svd(R, full_matrices=False)
    return rows_map(torch.matmul, Q, Ur), s, Vh
