"""Synchronous randomized block Gauss-Seidel (port of
``libskylark_tpu/solvers/gauss_seidel.py``).

≙ ``algorithms/asynch/AsyRGS.hpp`` (Avron-Druinsky-Gupta): the reference
runs lock-free asynchronous randomized coordinate sweeps with OpenMP
atomics; the JAX package keeps the *mathematics* — randomized block
coordinate descent on SPD ``A X = B`` — with a synchronous *schedule*:
per sweep, a counter-derived random permutation of blocks, each block
update solving the ``block × block`` diagonal system exactly.

The schedule is the JAX package's permutation, bit for bit: the same
f32 uniforms from the counter stream, ordered by a STABLE argsort (24-bit
keys can tie; ``jnp.argsort`` is stable).  It is computed on the device
and read to the host once per call; the sweeps are then a host loop over
blocks, each a handful of launches (the row panel's GEMM, the diagonal
block's dense solve, the update) with no host read.  The diagonal solve
is ``torch.linalg.solve_ex``: ``jnp.linalg.solve``'s LU solve without
the error check that would read the card once per block.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import sample

__all__ = ["randomized_block_gauss_seidel", "gs_num_blocks"]


def gs_num_blocks(n: int, block_size: int) -> int:
    """Number of (clamped, possibly overlapping) blocks a GS sweep visits —
    the schedule consumes ``sweeps * gs_num_blocks(n, bs)`` counters.
    Exposed so callers reserving per-outer-iteration counter windows
    (``asy_fcg``) share this arithmetic instead of re-deriving it."""
    bs = min(block_size, n)
    return (n + bs - 1) // bs


def gs_schedule(seed: int, base: int, sweeps: int, nblocks: int, offset=0,
                device=None) -> torch.Tensor:
    """The (sweeps, nblocks) block orders of one call: a stable argsort of
    the f32 uniforms of counters ``base + offset ...`` per sweep.
    ``offset`` is a host int or a 0-d int64 tensor below 2^32 on the
    device (read without a host sync)."""
    u = sample("uniform", seed, base, sweeps * nblocks, dtype=torch.float32,
               offset=offset, device=device)
    return torch.argsort(u.reshape(sweeps, nblocks), dim=1, stable=True)


def randomized_block_gauss_seidel(
    A,
    B,
    context: SketchContext,
    block_size: int = 64,
    sweeps: int = 10,
    x0=None,
    counter_offset=0,
    *,
    device=None,
):
    """Solve SPD ``A X = B`` by randomized block Gauss-Seidel sweeps.

    Returns ``(X, info)`` with ``info = {"sweeps", "resid"}`` (the
    columns' ``‖B - A X‖``).  n must be ≥ block_size; a trailing ragged
    block is clamped into the last full block (``start = min(j·bs, n −
    bs)``: updates overlap harmlessly — GS tolerates overlapping blocks).

    ``counter_offset`` shifts the schedule's counter window: a host int,
    or a 0-d int64 tensor below 2^32 on the device (``asy_fcg`` passes
    ``it · sweeps · nblocks`` mod 2^32 per outer iteration).
    """
    A = as_tensor(A, device)
    B = as_tensor(B, A.device if device is None else device)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    n = A.shape[0]
    bs = min(block_size, n)
    nblocks = gs_num_blocks(n, block_size)
    seed = context.seed
    base = context.reserve(sweeps * nblocks)
    if x0 is None:
        X = torch.zeros_like(B)
    else:
        X = as_tensor(x0, B.device).reshape(B.shape).clone()
    # The one host read of the call: every sweep's block order.
    orders = gs_schedule(seed, base, sweeps, nblocks, offset=counter_offset,
                         device=B.device).tolist()
    for order in orders:
        for j in order:
            start = min(j * bs, n - bs)
            Ablk = A[start:start + bs]  # (bs, n)
            Rblk = B[start:start + bs] - Ablk @ X
            delta = torch.linalg.solve_ex(Ablk[:, start:start + bs], Rblk)[0]
            X[start:start + bs] += delta
    R = B - A @ X
    info = {"sweeps": torch.tensor(sweeps, device=B.device),
            "resid": torch.linalg.vector_norm(R, dim=0)}
    return (X[:, 0] if squeeze else X), info
