"""Plain least-squares reference in float64: the FJLT sketch of
``counter_contract.md`` and exact solves by a blocked QR.

Nothing here comes from the program.  The FJLT is written from its
definition: ``S·A = (1/sqrt(S)) · H_NB[idx] · (D ⊙ A)``, with D the N
Rademacher signs and idx the S uniform integers in [0, NB) that the
sketch reserves, in that order, at its counter base, and H_NB the
Sylvester Hadamard matrix (entry (i, j) is ``(-1)^popcount(i & j)``).
"""

from __future__ import annotations

import math

import torch

from . import counter

# Largest Hadamard factor applied at once (2^7 = 128).
_FACTOR_LOG2 = 7


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def hadamard(k: int, dtype, device) -> torch.Tensor:
    """Unnormalised 2^k × 2^k Sylvester Hadamard matrix."""
    H = torch.ones((1, 1), dtype=dtype, device=device)
    for _ in range(k):
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return H


def wht_rows(X: torch.Tensor) -> torch.Tensor:
    """Unnormalised Walsh-Hadamard transform along axis 0 (size 2^k) of
    a 2-D X, as one small Hadamard factor per group of index bits."""
    nb, cols = X.shape
    k = nb.bit_length() - 1
    if nb != 1 << k:
        raise ValueError(f"wht needs a power-of-2 length, got {nb}")
    done = 0
    while done < k:
        c = min(_FACTOR_LOG2, k - done)
        f = 1 << c
        # Row index bits: [high: nb >> (done + c)] [f] [low: 1 << done].
        Xv = X.reshape(nb >> (done + c), f, (1 << done) * cols)
        X = torch.matmul(hadamard(c, X.dtype, X.device), Xv).reshape(nb, cols)
        done += c
    return X


def fjlt_draws(seed: int, base: int, n: int, s: int, device):
    """(D, idx): the FJLT's diagonal and sampled coordinates."""
    nb = next_pow2(n)
    D = counter.rademacher(seed, base, n, device, torch.float64)
    idx = counter.uniform_int(seed, base + n, s, nb - 1, device)
    return D, idx


def fjlt_columnwise(A: torch.Tensor, seed: int, base: int, s: int, *, block_cols: int = 64,
                    round_input=None) -> torch.Tensor:
    """``S·A`` in float64 for the FJLT reserved at ``base``.
    ``round_input`` (the control) rounds each block of A first."""
    m, k = A.shape
    nb = next_pow2(m)
    D, idx = fjlt_draws(seed, base, m, s, A.device)
    out = torch.empty((s, k), dtype=torch.float64, device=A.device)
    for c0 in range(0, k, block_cols):
        c1 = min(k, c0 + block_cols)
        blk = A[:, c0:c1]
        if round_input is not None:
            blk = round_input(blk)
        X = torch.zeros((nb, c1 - c0), dtype=torch.float64, device=A.device)
        X[:m] = blk.double() * D[:, None]
        out[:, c0:c1] = wht_rows(X)[idx]
        del X
    return out / math.sqrt(s)


def qr_augmented(A: torch.Tensor, B: torch.Tensor, *, block_rows: int = 1 << 17,
                 round_input=None) -> torch.Tensor:
    """The (n + k) × (n + k) upper R of ``[A | B]`` in float64, by
    stacking the running R over row blocks.  Its leading n × n block is
    A's R and its top-right block is Qᵀ·B."""
    R = None
    for r0 in range(0, A.shape[0], block_rows):
        r1 = min(A.shape[0], r0 + block_rows)
        a, b = A[r0:r1], B[r0:r1]
        if round_input is not None:
            a, b = round_input(a), round_input(b)
        M = torch.cat([a.double(), b.double()], 1)
        if R is not None:
            M = torch.cat([R, M], 0)
        R = torch.linalg.qr(M, mode="r")[1]
    return R


def solve_from_r(R: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(X, R_A): the least-squares solutions of every right-hand side
    held in an augmented R, and A's n × n factor."""
    Ra = R[:n, :n]
    return torch.linalg.solve_triangular(Ra, R[:n, n:], upper=True), Ra


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest, ties away from zero: the control's precision."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
