"""Class-based nonlinear regression/classification models (port of
``libskylark_tpu/ml/nonlinear.py``, ≙ ``python-skylark/skylark/ml/
nonlinear.py``).

- ``RLS`` — exact kernel regularized least squares: Gram + PSD solve,
  predict via ``k(X_test, X_train) @ alpha``.
- ``SketchRLS`` — random-feature RLS: feature map from
  ``kernel.create_rft`` (a CWT for the linear kernel's "sparse" tag),
  normal-equation solve in feature space.
- ``NystromRLS`` — Nyström features: l landmark rows drawn by ``NURST``
  (uniform or ridge-leverage weighted), whitened with the landmark
  Gram's inverse square root.
- ``SketchPCR`` — sketched kernel principal component regression:
  random features Z (n, s), a CWT of t rows to factor Z cheaply, the
  top-``rank`` right basis and whitener from its SVD, regression on the
  projected features, weights folded back to feature space (the JAX
  package's reconstruction of the reference's missing ``lowrank`` step).

Multiclass labels are ±1 dummy-coded for training and argmax-decoded at
prediction; with ``multiclass=False`` targets pass through untouched.
The coding matrix lies on X's device in X's dtype promoted to at least
f32 (``coding.label_dtype``).
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..core.context import SketchContext
from ..core.random import _const
from ..sketch.base import Dimension
from ..sketch.hash import CWT
from ..sketch.sampling import NURST
from .coding import decode_labels, dummy_coding, label_dtype
from .kernels import Kernel, _dense
from .krr import _cho_solve, _cholesky, _mm, _plus_lam_eye, _psd_gram

__all__ = ["RLS", "SketchRLS", "NystromRLS", "SketchPCR"]


class _LabeledModel:
    """Shared ±1 dummy-coding / argmax-decoding label plumbing."""

    def __init__(self, kernel: Kernel):
        self.kernel = kernel
        self.multiclass = True
        self.classes = None

    def _encode(self, Y, multiclass, X):
        self.multiclass = bool(multiclass)
        if not self.multiclass:
            Y = as_tensor(Y, X.device)
            self.classes = None
            return Y[:, None] if Y.ndim == 1 else Y
        T, self.classes = dummy_coding(Y, dtype=label_dtype(X), device=X.device)
        return T

    def _decode(self, O):
        if not self.multiclass:
            return O[:, 0] if O.shape[1] == 1 else O
        return decode_labels(O, self.classes)

    def _ridge_weights(self, Z, T, regularization):
        """(ZᵀZ + r·I)⁻¹ZᵀT, the Gram in ≥ f32."""
        A = _plus_lam_eye(_psd_gram(Z.T, Z), regularization, Z.dtype)
        return _cho_solve(_cholesky(A), _mm(Z.T, T))


class RLS(_LabeledModel):
    """Exact kernel RLS (≙ nonlinear.py ``rls``)."""

    def train(self, X, Y, regularization: float = 1.0, multiclass: bool = True, *,
              device=None):
        X = _dense(X, device)
        T = self._encode(Y, multiclass, X)
        K = self.kernel.gram(X, X)
        K.diagonal().add_(_const(regularization, K.dtype, K.device))  # K + r·I, in place
        self.alpha = _cho_solve(_cholesky(K), T)
        self.X_train = X
        return self

    def predict(self, Xt):
        K = self.kernel.gram(_dense(Xt, self.X_train.device), self.X_train)
        return self._decode(_mm(K, self.alpha))


class SketchRLS(_LabeledModel):
    """Random-feature RLS (≙ nonlinear.py ``sketchrls``)."""

    def train(
        self,
        X,
        Y,
        context: SketchContext,
        random_features: int = 100,
        regularization: float = 1.0,
        multiclass: bool = True,
        subtype: str = "regular",
        *,
        device=None,
    ):
        X = as_tensor(X, device)
        T = self._encode(Y, multiclass, X)
        self.rft = self.kernel.create_rft(random_features, subtype, context)
        Z = self.rft.apply(X, Dimension.ROWWISE)  # (n, s)
        self.weights = self._ridge_weights(Z, T, regularization)
        return self

    def predict(self, Xt):
        Zt = self.rft.apply(as_tensor(Xt, self.weights.device), Dimension.ROWWISE)
        return self._decode(_mm(Zt, self.weights))


class NystromRLS(_LabeledModel):
    """Nyström-feature RLS (≙ nonlinear.py ``nystromrls``).

    Landmarks are drawn with ``NURST`` under ``probdist`` ∈ {"uniform",
    "leverages"}; "leverages" weights rows by the ridge leverage scores
    diag(K·(K+λI)⁻¹), computed with a PSD solve.
    """

    _EPS = 1e-8  # eigenvalue floor for the landmark Gram (≙ eps in ref)

    def train(
        self,
        X,
        Y,
        context: SketchContext,
        random_features: int = 100,
        regularization: float = 1.0,
        probdist: str = "uniform",
        multiclass: bool = True,
        *,
        device=None,
    ):
        X = _dense(X, device)
        n = X.shape[0]
        T = self._encode(Y, multiclass, X)
        if probdist == "uniform":
            probs = torch.full((n,), 1.0 / n, dtype=torch.float64)
        elif probdist == "leverages":
            K = self.kernel.gram(X, X)
            A = _plus_lam_eye(K, regularization, K.dtype)
            lev = torch.clamp(torch.diagonal(_cho_solve(_cholesky(A), K)), min=0.0)
            probs = (lev / torch.sum(lev)).cpu()
        else:
            raise ValueError(f"unknown probdist {probdist!r}")
        sampler = NURST(n, random_features, context, probs.numpy())
        SX = sampler.apply(X, Dimension.COLUMNWISE)  # (l, d) landmarks
        K_ll = self.kernel.gram(SX, SX)
        evals, evecs = torch.linalg.eigh(_plus_lam_eye(K_ll, self._EPS, K_ll.dtype))
        evals = torch.clamp(evals, min=self._EPS)
        self.U = evecs / torch.sqrt(evals)[None, :]  # whitener K_ll^{-1/2}
        Z = self.kernel.gram(X, SX) @ self.U  # (n, l) Nyström features
        self.weights = self._ridge_weights(Z, T, regularization)
        self.SX = SX
        return self

    def predict(self, Xt):
        Zt = self.kernel.gram(_dense(Xt, self.SX.device), self.SX) @ self.U
        return self._decode(_mm(Zt, self.weights))


class SketchPCR(_LabeledModel):
    """Sketched kernel PCR (≙ nonlinear.py ``sketchpcr``; see the module
    docstring)."""

    def train(
        self,
        X,
        Y,
        context: SketchContext,
        rank: int,
        s: int | None = None,
        t: int | None = None,
        multiclass: bool = True,
        subtype: str = "regular",
        *,
        device=None,
    ):
        if s is None:
            s = 2 * rank
        if t is None:
            t = 2 * s
        if not (rank <= s <= t):
            raise ValueError(f"need rank <= s <= t, got {rank}, {s}, {t}")
        X = as_tensor(X, device)
        T = self._encode(Y, multiclass, X)
        self.rft = self.kernel.create_rft(s, subtype, context)
        Z = self.rft.apply(X, Dimension.ROWWISE)  # (n, s)
        n = Z.shape[0]
        # Second-level sketch: a t × s subspace embedding of Z's column
        # space, then the SVD of the small factor.
        SZ = CWT(n, min(t, n), context).apply(Z, Dimension.COLUMNWISE)
        _, sig, Vt = torch.linalg.svd(SZ, full_matrices=False)
        if rank > sig.shape[0]:
            raise ValueError(
                f"rank {rank} exceeds sketched factor rank {sig.shape[0]}"
            )
        whiten = Vt[:rank].T / torch.clamp(sig[:rank], min=1e-12)  # (s, rank)
        # Projected (≈ orthonormal) principal features and regression;
        # weights fold back to feature space (≙ ref train's R⁻¹·V·w0).
        Zp = Z @ whiten
        dt = torch.promote_types(Zp.dtype, T.dtype)
        w0 = torch.linalg.lstsq(Zp.to(dt), T.to(dt)).solution  # (rank, k)
        self.weights = whiten.to(dt) @ w0  # (s, k)
        self.rank, self.s, self.t = rank, s, t
        return self

    def predict(self, Xt):
        Zt = self.rft.apply(as_tensor(Xt, self.weights.device), Dimension.ROWWISE)
        return self._decode(_mm(Zt, self.weights))
