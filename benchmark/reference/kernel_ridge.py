"""Plain random-feature kernel ridge regression reference.

The Gaussian random Fourier features of ``counter_contract.md``: W is
the (S, d) row-major block of normals at the map's counter base, scaled
by 1/sigma, then S uniform shifts in [0, 2*pi).  A feature is
``sqrt(2/S) · cos(x·wᵀ + shift)``.  The configuration states bf16
features: W, the shifts, the product and each step of the epilogue
are rounded to bf16, with the product's sum taken exactly (float64)
and rounded through float32 as an f32-accumulating GEMM rounds it.  The
ridge system ``(ZᵀZ + λI) W = Zᵀy`` is formed and solved in float64.
"""

from __future__ import annotations

import math

import torch

from . import counter

BF16 = torch.bfloat16


def rft_draws(seed: int, base: int, d: int, s: int, sigma: float, device):
    """(W, shifts) in bf16, as the feature map realizes them."""
    w = counter.normal_f32(seed, base, s * d, device).reshape(s, d).to(BF16)
    W = w * torch.tensor(1.0 / sigma, dtype=BF16, device=device)
    u = counter.uniform01_f32(seed, base + s * d, s, device).to(BF16)
    shifts = u * torch.tensor(2.0 * math.pi, dtype=BF16, device=device) \
        + torch.tensor(0.0, dtype=BF16, device=device)
    return W, shifts


def features(Xp, W, shifts, s: int, round_cos=None) -> torch.Tensor:
    """bf16 features of a panel, each step rounded to bf16; ``round_cos``
    (the control) rounds the cosines to a narrower type first."""
    pre = (Xp.double() @ W.double().T).float().to(BF16)
    c = (pre + shifts).cos()
    if round_cos is not None:
        c = round_cos(c)
    return c * torch.tensor(math.sqrt(2.0 / s), dtype=BF16, device=c.device)


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 and back: the control's precision."""
    return x.float().to(torch.float8_e4m3fn).to(x.dtype)


def solve(panels, y_panels, W, shifts, s: int, lam: float, round_cos=None,
          chunk: int = 32768) -> torch.Tensor:
    """The ridge solution (S, 1) in float64 over the panels of X, each
    taken ``chunk`` rows at a time."""
    G = torch.zeros((s, s), dtype=torch.float64, device=W.device)
    c = torch.zeros((s, 1), dtype=torch.float64, device=W.device)
    for Xp, yp in zip(panels, y_panels):
        for r0 in range(0, Xp.shape[0], chunk):
            Z = features(Xp[r0:r0 + chunk], W, shifts, s, round_cos).double()
            G += Z.T @ Z
            c += Z.T @ yp[r0:r0 + chunk].double().reshape(-1, 1)
            del Z
    G += lam * torch.eye(s, dtype=torch.float64, device=W.device)
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(c, L)
