"""Randomized-preconditioned flexible CG (port of
``libskylark_tpu/solvers/asynch.py``, ≙ ``algorithms/asynch/``).

``AsyFCG`` in the reference pairs FlexibleCG with an *asynchronous*
randomized Gauss-Seidel inner solve as a (varying) preconditioner
(``AsyFCG.hpp:8``, ``asynch/precond.hpp:7-22``).  The JAX package keeps
the math — FCG with an inexact, iteration-varying randomized GS
preconditioner — with the synchronous randomized sweeps of
``gauss_seidel``, and so does the port.  Determinism: the sweep schedule
is counter-derived per outer iteration, the JAX package's window
exactly (its uint32 ``it · per_iter``, which wraps mod 2^32).

The preconditioner is a plain function, so the Krylov step runs eagerly
(never captured as a CUDA graph): each inner GS call reads its schedule
to the host once, which no capture can hold.
"""

from __future__ import annotations

from .._device import as_tensor
from ..core.context import SketchContext
from .gauss_seidel import gs_num_blocks, randomized_block_gauss_seidel
from .krylov import KrylovParams, flexible_cg

__all__ = ["asy_fcg"]


def _window(it, per_iter: int):
    """Outer iteration ``it``'s counter offset, ``it · per_iter`` wrapped
    mod 2^32 as the JAX package's uint32 product wraps; ``it`` is the
    Krylov state's 0-d int64 device tensor (no host read)."""
    return (it * per_iter) % (1 << 32)


def _gs_precond(A, seed: int, base: int, per_iter: int, inner_sweeps: int,
                block_size: int):
    """``precond(R, it)``: ``inner_sweeps`` randomized GS sweeps on
    ``A Z = R`` from the counter window of outer iteration ``it``."""

    def precond(R, it):
        Z, _ = randomized_block_gauss_seidel(
            A, R, SketchContext(seed=seed, counter=base), block_size=block_size,
            sweeps=inner_sweeps, counter_offset=_window(it, per_iter))
        return Z

    return precond


def asy_fcg(
    A,
    B,
    context: SketchContext,
    params: KrylovParams | None = None,
    inner_sweeps: int = 2,
    block_size: int = 64,
    *,
    device=None,
):
    """Solve SPD ``A X = B`` by FCG with a randomized block-GS inner
    preconditioner.  Returns ``(X, info)``."""
    A = as_tensor(A, device)
    params = params or KrylovParams()
    # One counter block PER OUTER ITERATION drives the inner sweeps'
    # schedule, so each FCG iteration sees a fresh randomized GS sweep —
    # matching AsyFCG's per-call randomization (``AsyFCG.hpp:8``,
    # ``asynch/precond.hpp:7-22``).
    per_iter = inner_sweeps * gs_num_blocks(A.shape[0], block_size)
    base = context.reserve(params.iter_lim * per_iter)
    precond = _gs_precond(A, context.seed, base, per_iter, inner_sweeps, block_size)
    return flexible_cg(A, B, precond=precond, params=params, device=device)
