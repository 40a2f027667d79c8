"""Kernel library (port of ``libskylark_tpu/ml/kernels.py``).

``Kernel.gram(X, Y)`` computes the kernel matrix and
``create_rft(s, tag, context)`` builds the matching random feature map
(tags "regular", "fast", "sparse" and "quasi" where the kernel has
them; "quasi" gives the quasi-Monte-Carlo maps of ``sketch/rft.py`` and
``sketch/rlt.py``).  Examples are rows:
X is (n, d), and ``gram(X, Y)[i, j] = k(X[i], Y[j])``.

Squared distances use the ‖x‖² + ‖y‖² − 2·X·Yᵀ expansion, clamped at
0, with the cross term a full-f32 matmul (TF32 is off, ``_device.py``):
TF32 would put O(1) absolute errors into the differences of clustered
data.  L1 and semigroup distances are row-blocked broadcasts whose
intermediate stays under ``_PAIRWISE_LIMIT`` elements.  A tensor is
computed where it lies; array-likes move to ``device``; a sparse COO
input is densified (the outputs are dense anyway).
"""

from __future__ import annotations

import abc
import json
import math
from typing import Any

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import _const
from ..sketch import (
    CWT,
    FJLT,
    JLT,
    PPT,
    ExpSemigroupQRLT,
    ExpSemigroupRLT,
    FastGaussianRFT,
    FastMaternRFT,
    GaussianQRFT,
    GaussianRFT,
    LaplacianQRFT,
    LaplacianRFT,
    MaternRFT,
)

__all__ = [
    "Kernel",
    "LinearKernel",
    "GaussianKernel",
    "PolynomialKernel",
    "LaplacianKernel",
    "ExpSemigroupKernel",
    "MaternKernel",
    "kernel_by_name",
    "from_dict",
]

# Broadcast intermediates above this many elements are computed in row
# blocks, so peak memory is one (block, m, d) slab.
_PAIRWISE_LIMIT = 1 << 27


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``like``'s dtype, on its device."""
    return _const(x, like.dtype, like.device)


def _dense(X, device=None) -> torch.Tensor:
    X = as_tensor(X, device)
    if X.layout == torch.sparse_coo:
        X = X.to_dense()
    return X if X.is_floating_point() else X.to(torch.float32)


def _operands(X, Y, device=None):
    """X and Y (Y = X when None) as dense floating tensors of one dtype,
    Y on X's device."""
    X = _dense(X, device)
    Y = X if Y is None else _dense(Y, X.device)
    dt = torch.promote_types(X.dtype, Y.dtype)
    return X.to(dt), Y.to(device=X.device, dtype=dt)


def _sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances (n, m): (‖x‖² + ‖y‖²) − 2·x·y,
    clamped at 0, in the operands' dtype."""
    xx = torch.sum(X * X, dim=1)[:, None]
    yy = torch.sum(Y * Y, dim=1)[None, :]
    D = xx + yy
    D.sub_(torch.matmul(X, Y.T).mul_(2.0))
    return D.clamp_(min=0.0)


def _blocked_rows(pair_fn, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    n, d = X.shape
    m = Y.shape[0]
    if n * m * d <= _PAIRWISE_LIMIT:
        return pair_fn(X, Y)
    block = max(1, _PAIRWISE_LIMIT // max(m * d, 1))
    return torch.cat([pair_fn(X[i:i + block], Y) for i in range(0, n, block)], 0)


def _l1dist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 distances (row-blocked broadcast)."""
    return _blocked_rows(
        lambda a, b: torch.sum(torch.abs(a[:, None, :] - b[None, :, :]), dim=-1), X, Y)


def _semigroup_dist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise semigroup "distance" Σ_k √(x_k + y_k) on nonnegative
    inputs (row-blocked broadcast)."""
    return _blocked_rows(
        lambda a, b: torch.sum(
            torch.sqrt(torch.clamp(a[:, None, :] + b[None, :, :], min=0.0)), dim=-1),
        X, Y)


class Kernel(abc.ABC):
    """A positive-definite kernel on R^n."""

    kernel_type: str = "abstract"

    def __init__(self, n: int):
        self.n = int(n)

    @abc.abstractmethod
    def gram(self, X, Y=None, *, device=None) -> torch.Tensor:
        """K[i, j] = k(X[i], Y[j]); Y = None means Y = X."""

    @abc.abstractmethod
    def create_rft(self, s: int, tag: str, context: SketchContext):
        """Feature map with s features approximating this kernel."""

    def _param_dict(self) -> dict[str, Any]:
        return {}

    def to_dict(self) -> dict[str, Any]:
        d = {"kernel_type": self.kernel_type, "N": self.n}
        d.update(self._param_dict())
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def __repr__(self):
        params = ", ".join(f"{k}={v}" for k, v in self._param_dict().items())
        return f"{type(self).__name__}(N={self.n}{', ' + params if params else ''})"


class LinearKernel(Kernel):
    """k(x, y) = xᵀy."""

    kernel_type = "linear"

    def gram(self, X, Y=None, *, device=None):
        X, Y = _operands(X, Y, device)
        return torch.matmul(X, Y.T)

    def create_rft(self, s, tag, context):
        if tag == "regular":
            return JLT(self.n, s, context)
        if tag == "fast":
            return FJLT(self.n, s, context)
        if tag == "sparse":
            return CWT(self.n, s, context)
        raise ValueError(f"linear kernel has no {tag!r} feature transform")


class GaussianKernel(Kernel):
    """k(x, y) = exp(−‖x−y‖²/(2σ²))."""

    kernel_type = "gaussian"

    def __init__(self, n: int, sigma: float):
        super().__init__(n)
        self.sigma = float(sigma)

    def gram(self, X, Y=None, *, device=None):
        D = _sqdist(*_operands(X, Y, device))
        return D.div_(_scalar(2.0 * self.sigma ** 2, D)).neg_().exp_()

    def create_rft(self, s, tag, context):
        if tag == "regular":
            return GaussianRFT(self.n, s, context, sigma=self.sigma)
        if tag == "fast":
            return FastGaussianRFT(self.n, s, context, sigma=self.sigma)
        if tag == "quasi":
            return GaussianQRFT(self.n, s, context, sigma=self.sigma)
        raise ValueError(f"gaussian kernel has no {tag!r} feature transform")

    def _param_dict(self):
        return {"sigma": self.sigma}


class PolynomialKernel(Kernel):
    """k(x, y) = (γ·xᵀy + c)^q."""

    kernel_type = "polynomial"

    def __init__(self, n: int, q: int = 2, c: float = 1.0, gamma: float = 1.0):
        super().__init__(n)
        self.q = int(q)
        self.c = float(c)
        self.gamma = float(gamma)

    def gram(self, X, Y=None, *, device=None):
        X, Y = _operands(X, Y, device)
        G = torch.matmul(X, Y.T)
        return (_scalar(self.gamma, G) * G + _scalar(self.c, G)) ** self.q

    def create_rft(self, s, tag, context):
        if tag in ("regular", "fast"):
            return PPT(self.n, s, context, q=self.q, c=self.c, gamma=self.gamma)
        raise ValueError(f"polynomial kernel has no {tag!r} feature transform")

    def _param_dict(self):
        return {"q": self.q, "c": self.c, "gamma": self.gamma}


class LaplacianKernel(Kernel):
    """k(x, y) = exp(−‖x−y‖₁/σ)."""

    kernel_type = "laplacian"

    def __init__(self, n: int, sigma: float):
        super().__init__(n)
        self.sigma = float(sigma)

    def gram(self, X, Y=None, *, device=None):
        D = _l1dist(*_operands(X, Y, device))
        return D.div_(_scalar(self.sigma, D)).neg_().exp_()

    def create_rft(self, s, tag, context):
        if tag == "regular":
            return LaplacianRFT(self.n, s, context, sigma=self.sigma)
        if tag == "quasi":
            return LaplacianQRFT(self.n, s, context, sigma=self.sigma)
        raise ValueError(f"laplacian kernel has no {tag!r} feature transform")

    def _param_dict(self):
        return {"sigma": self.sigma}


class ExpSemigroupKernel(Kernel):
    """k(x, y) = exp(−β·Σ_i √(x_i + y_i)) on histograms."""

    kernel_type = "expsemigroup"

    def __init__(self, n: int, beta: float):
        super().__init__(n)
        self.beta = float(beta)

    def gram(self, X, Y=None, *, device=None):
        D = _semigroup_dist(*_operands(X, Y, device))
        return D.mul_(_scalar(-self.beta, D)).exp_()

    def create_rft(self, s, tag, context):
        if tag == "regular":
            return ExpSemigroupRLT(self.n, s, context, beta=self.beta)
        if tag == "quasi":
            return ExpSemigroupQRLT(self.n, s, context, beta=self.beta)
        raise ValueError(f"expsemigroup kernel has no {tag!r} feature transform")

    def _param_dict(self):
        return {"beta": self.beta}


class MaternKernel(Kernel):
    """Matérn(ν, ℓ) kernel for half-integer ν = p + ½, in closed form:
    k(r) = exp(−a)·(p!/(2p)!)·Σ_{i≤p} ((p+i)!/(i!(p−i)!))·(2a)^(p−i),
    a = √(2ν)·r/ℓ."""

    kernel_type = "matern"

    def __init__(self, n: int, nu: float = 0.5, l: float = 1.0):
        super().__init__(n)
        two_nu = 2.0 * nu
        if abs(two_nu - round(two_nu)) > 1e-9 or round(two_nu) % 2 != 1:
            raise ValueError(
                f"MaternKernel gram supports half-integer nu (0.5, 1.5, ...), got {nu}")
        self.nu = float(nu)
        self.l = float(l)

    def gram(self, X, Y=None, *, device=None):
        r = torch.sqrt(_sqdist(*_operands(X, Y, device)))
        p = int(round(self.nu - 0.5))
        arg = _scalar(math.sqrt(2.0 * self.nu), r) * r / _scalar(self.l, r)
        total = torch.zeros_like(arg)
        for i in range(p + 1):
            coef = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
            total = total + _scalar(coef, arg) * (_scalar(2.0, arg) * arg) ** (p - i)
        scale = math.factorial(p) / math.factorial(2 * p)
        return torch.exp(-arg) * _scalar(scale, arg) * total

    def create_rft(self, s, tag, context):
        if tag == "regular":
            return MaternRFT(self.n, s, context, nu=self.nu, l=self.l)
        if tag == "fast":
            return FastMaternRFT(self.n, s, context, nu=self.nu, l=self.l)
        raise ValueError(f"matern kernel has no {tag!r} feature transform")

    def _param_dict(self):
        return {"nu": self.nu, "l": self.l}


_KERNELS = {
    "linear": LinearKernel,
    "gaussian": GaussianKernel,
    "polynomial": PolynomialKernel,
    "laplacian": LaplacianKernel,
    "expsemigroup": ExpSemigroupKernel,
    "matern": MaternKernel,
}


def kernel_by_name(name: str, n: int, **params) -> Kernel:
    """String-typed kernel factory."""
    if name not in _KERNELS:
        raise ValueError(f"unknown kernel {name!r}; known: {sorted(_KERNELS)}")
    return _KERNELS[name](n, **params)


def from_dict(d: dict) -> Kernel:
    """Rebuild a kernel from the dict either package writes."""
    d = dict(d)
    name = d.pop("kernel_type")
    n = d.pop("N")
    return kernel_by_name(name, n, **d)
