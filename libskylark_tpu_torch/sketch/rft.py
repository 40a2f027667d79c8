"""Random Fourier feature maps (Rahimi-Recht), port of
``libskylark_tpu/sketch/rft.py``.

``Z = outscale · cos(scales ⊙ (W·X) + shifts)``, W the dense counter
sketch pre-scaled by ``inscale`` (``DenseSketch``, one matmul), then one
elementwise epilogue (:func:`_epilogue`) that every apply calls.

- GaussianRFT(sigma):   W ~ N, inscale 1/σ, outscale √(2/S)
- LaplacianRFT(sigma):  W ~ Cauchy, inscale 1/σ, outscale √(2/S)
- MaternRFT(nu, l):     W ~ N with the per-row multivariate-t correction
  ``sqrt(2ν/χ²_{2ν})``, inscale 1/l
- GaussianQRFT / LaplacianQRFT(sigma, skip): quasi-Monte-Carlo rows

Counter budget as the reference's: N·S for W, then S shifts, then S
scales for Matérn.  Shifts and scales are memoized per dtype and device;
2π, ``outscale`` and 2ν are rounded to the sample dtype as the JAX
package rounds its weakly typed Python floats.  XLA contracts the
epilogue's ``WX·scales + shifts`` into an FMA; here they are two rounded
operations, so Matérn features may differ from the JAX ones by one ulp
of the cosine's argument.  Streaming slices delegate the linear half
W·A to the dense engine; :meth:`RFT.finalize_slices` applies the
epilogue once to the merged sum.

The QRFTs (Yang et al, ICML'14) take W and the shifts from a leaped
Halton sequence of dimension N + 1 (``core.quasirand``): W[j, c] =
invCDF(u(skip + j, c))·inscale, shift_j = 2π·u(skip + j, N).  They
consume no counters.  As in the JAX package, U is cast to the input's
dtype before the inverse CDF, so an f32 apply evaluates ndtri and tan in
f32; torch's f32 ndtri and tan are not XLA's and differ from them in the
last ulps, which the Cauchy tail magnifies.
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor, resolve_device
from ..core.context import SketchContext
from ..core.quasirand import LeapedHaltonSequence
from ..core.random import _const, chi2_lanes, sample
from .base import Dimension, SketchTransform, register_sketch
from .dense import DenseSketch

__all__ = ["RFT", "GaussianRFT", "LaplacianRFT", "MaternRFT", "QRFT", "GaussianQRFT",
           "LaplacianQRFT"]

_TWO_PI = 2.0 * math.pi


def _epilogue(WX: torch.Tensor, shifts: torch.Tensor, scales, outscale: float,
              columnwise: bool) -> torch.Tensor:
    """``outscale · cos(scales ⊙ WX + shifts)``, per feature: along rows of
    a columnwise (S, m) WX, along columns of a rowwise (m, S) one.  WX is
    the apply's own temporary, so the chain runs in place on it."""
    if columnwise and WX.ndim > 1:
        shifts = shifts[:, None]
        scales = None if scales is None else scales[:, None]
    if scales is not None:
        WX.mul_(scales)
    WX.add_(shifts).cos_()
    # A host 0-d constant: no host-to-card copy, so a CUDA graph can
    # capture the epilogue.
    return WX.mul_(_const(outscale, WX.dtype))


class _Underlying(DenseSketch):
    """The dense W, pre-scaled by inscale; internal, not registered."""

    def __init__(self, n, s, context, scale, dist):
        self.dist = dist
        super().__init__(n, s, context, scale=scale)


class RFT(SketchTransform):
    """Base engine: Z = outscale · cos(scales ⊙ (W·X) + shifts)."""

    w_dist = "normal"

    def __init__(self, n: int, s: int, context: SketchContext, inscale: float,
                 outscale: float):
        super().__init__(n, s, context)
        self._seed = context.seed
        self.inscale = float(inscale)
        self.outscale = float(outscale)
        self._underlying = _Underlying(n, s, context, inscale, self.w_dist)
        self._shift_base = context.reserve(s)
        self._memo: dict = {}

    def _memoized(self, what: str, dtype, device, make):
        key = (what, dtype, resolve_device(device))
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = make(dtype, key[2])
        return hit

    def shifts(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The S phase shifts, uniform in [0, 2π)."""
        return self._memoized("shifts", dtype, device, lambda dt, dev: sample(
            "uniform", self._seed, self._shift_base, self.s, dtype=dt, device=dev,
            low=0.0, high=_TWO_PI))

    def scales(self, dtype=torch.float32, device=None):
        """Per-feature scaling; none unless a subclass has one."""
        return None

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *,
              device=None):
        dim = Dimension.of(dim)
        return self._epilogue(self._underlying.apply(A, dim, device=device), dim)

    def _epilogue(self, WX: torch.Tensor, dim: Dimension) -> torch.Tensor:
        return _epilogue(WX, self.shifts(WX.dtype, WX.device),
                         self.scales(WX.dtype, WX.device), self.outscale,
                         dim is Dimension.COLUMNWISE)

    # -- streaming slices: the linear half W·A decomposes over row blocks
    # like the dense engine's; the cos epilogue waits for the merged sum.

    supports_slice_kernel = True

    def _apply_slice_columnwise(self, A_block, start: int):
        return self._underlying._apply_slice_columnwise(A_block, start)

    def apply_slice_kernel(self, A_block, start):
        return self._underlying.apply_slice_kernel(A_block, start)

    def finalize_slices(self, acc, dim: Dimension | str = Dimension.COLUMNWISE):
        """COLUMNWISE slice-sums hold the merged W·A: the epilogue runs
        once here, on a copy (the caller's sum is left as it was).
        ROWWISE blocks were finished by :meth:`apply`."""
        self._underlying.finalize_slices(acc, dim)
        if Dimension.of(dim) is Dimension.ROWWISE:
            return acc
        return self._epilogue(acc.clone(), Dimension.COLUMNWISE)

    def hoistable_operands(self, dtype=torch.float32, device=None):
        """The realized (S, N) W, delegated to the dense engine (one
        gate, one memo)."""
        return self._underlying.hoistable_operands(dtype, device)

    def apply_with_operands(self, ops, A, dim: Dimension | str = Dimension.COLUMNWISE,
                            *, device=None):
        dim = Dimension.of(dim)
        return self._epilogue(self._underlying.apply_with_operands(ops, A, dim, device=device),
                              dim)


@register_sketch
class GaussianRFT(RFT):
    """Features of the Gaussian kernel exp(−‖x−y‖²/(2σ²))."""

    sketch_type = "GaussianRFT"
    w_dist = "normal"

    def __init__(self, n: int, s: int, context: SketchContext, sigma: float = 1.0):
        self.sigma = float(sigma)
        super().__init__(n, s, context, 1.0 / sigma, math.sqrt(2.0 / s))

    def _param_dict(self):
        return {"sigma": self.sigma}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, sigma=d["sigma"])


@register_sketch
class LaplacianRFT(RFT):
    """Features of the Laplacian kernel exp(−‖x−y‖₁/σ): Cauchy W."""

    sketch_type = "LaplacianRFT"
    w_dist = "cauchy"

    def __init__(self, n: int, s: int, context: SketchContext, sigma: float = 1.0):
        self.sigma = float(sigma)
        super().__init__(n, s, context, 1.0 / sigma, math.sqrt(2.0 / s))

    def _param_dict(self):
        return {"sigma": self.sigma}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, sigma=d["sigma"])


def matern_scales(nu: float, seed: int, base: int, size: int, dtype, device):
    """``sqrt(2ν/χ²_{2ν})`` per feature row, χ² summed over 2ν lanes."""
    chi2 = chi2_lanes(seed, base, size, int(round(2 * nu)), dtype, device=device)
    return torch.sqrt(_const(2.0 * nu, dtype, chi2.device) / chi2)


def check_two_nu(name: str, nu: float) -> None:
    two_nu = 2.0 * nu
    if abs(two_nu - round(two_nu)) > 1e-9 or round(two_nu) < 1:
        raise ValueError(f"{name} needs 2*nu a positive integer, got nu={nu}")


@register_sketch
class MaternRFT(RFT):
    """Features of the Matérn(ν, ℓ) kernel: multivariate-t rows, a
    Gaussian row times ``sqrt(2ν/χ²_{2ν})``; needs integer 2ν."""

    sketch_type = "MaternRFT"
    w_dist = "normal"

    def __init__(self, n: int, s: int, context: SketchContext, nu: float = 1.0,
                 l: float = 1.0):
        check_two_nu("MaternRFT", nu)
        self.nu = float(nu)
        self.l = float(l)
        super().__init__(n, s, context, 1.0 / l, math.sqrt(2.0 / s))
        self._scales_base = context.reserve(s)

    def scales(self, dtype=torch.float32, device=None):
        return self._memoized("scales", dtype, device, lambda dt, dev: matern_scales(
            self.nu, self._seed, self._scales_base, self.s, dt, dev))

    def _param_dict(self):
        return {"nu": self.nu, "l": self.l}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, nu=d["nu"], l=d["l"])


def _inverse_cdf(dist: str, u: torch.Tensor) -> torch.Tensor:
    """The inverse CDF of ``dist`` ("normal" or "cauchy") at ``u``, in
    ``u``'s dtype."""
    if dist == "normal":
        return torch.special.ndtri(u)
    if dist == "cauchy":
        return torch.tan(_const(math.pi, u.dtype, u.device) * (u - _const(0.5, u.dtype, u.device)))
    raise ValueError(f"no inverse CDF for {dist}")


class QRFT(SketchTransform):
    """Quasi-Monte-Carlo random features: ``Z = outscale · cos(W·X +
    shifts)`` with W and the shifts from the Halton sequence (≙
    ``QRFT_data_t``; sequence dimension N + 1)."""

    w_dist = "normal"

    def __init__(self, n: int, s: int, context: SketchContext, inscale: float,
                 outscale: float, skip: int = 0):
        super().__init__(n, s, context)
        self.inscale = float(inscale)
        self.outscale = float(outscale)
        self.skip = int(skip)
        self._sequence = LeapedHaltonSequence(n + 1)

    def realize(self, dtype=torch.float32, device=None):
        """(W, shifts): W is (S, N), both in ``dtype``."""
        U = self._sequence.window(self.skip, self.s, dtype=dtype, device=device)  # (S, N+1)
        W = _inverse_cdf(self.w_dist, U[:, :self.n]) * _const(self.inscale, dtype, U.device)
        return W, _const(_TWO_PI, dtype, U.device) * U[:, self.n]

    def apply(self, A, dim: Dimension | str = Dimension.COLUMNWISE, *, device=None):
        dim = Dimension.of(dim)
        A = as_tensor(A, device)
        if not A.is_floating_point():
            A = A.to(torch.float32)
        columnwise = dim is Dimension.COLUMNWISE
        if (A.shape[0] if columnwise else A.shape[-1]) != self.n:
            raise ValueError(f"{dim.value} apply needs {self.n} on the sketched axis, "
                             f"got {tuple(A.shape)}")
        W, shifts = self.realize(A.dtype, A.device)
        WX = torch.matmul(W, A) if columnwise else torch.matmul(A, W.T)
        return _epilogue(WX, shifts, None, self.outscale, columnwise)

    def _param_dict(self):
        return {"skip": self.skip}


class _SigmaQRFT(QRFT):
    """A QRFT of bandwidth sigma: inscale 1/σ, outscale √(2/S)."""

    def __init__(self, n: int, s: int, context: SketchContext, sigma: float = 1.0,
                 skip: int = 0):
        self.sigma = float(sigma)
        super().__init__(n, s, context, 1.0 / sigma, math.sqrt(2.0 / s), skip)

    def _param_dict(self):
        return {"sigma": self.sigma, "skip": self.skip}

    @classmethod
    def _from_param_dict(cls, d, context):
        return cls(d["N"], d["S"], context, sigma=d["sigma"], skip=d.get("skip", 0))


@register_sketch
class GaussianQRFT(_SigmaQRFT):
    """QMC features of the Gaussian kernel: normal inverse CDF."""

    sketch_type = "GaussianQRFT"
    w_dist = "normal"


@register_sketch
class LaplacianQRFT(_SigmaQRFT):
    """QMC features of the Laplacian kernel: Cauchy inverse CDF."""

    sketch_type = "LaplacianQRFT"
    w_dist = "cauchy"
