"""Loss / regularizer prox library (port of
``libskylark_tpu/solvers/prox.py``, ≙ ``algorithms/regression/loss.hpp``,
``regularizers.hpp``): the ADMM building blocks.

Each loss provides ``evaluate(O, Y)`` (total loss over the batch) and
``prox(V, lam, Y)`` = argmin_X  lam·loss(X, Y) + ½‖X − V‖².  O and V are
(k, n): k outputs (1 for regression or binary, #classes for multiclass)
by n examples; Y is (n,) (labels) or (k, n) (targets).  Every operation
is per example, so a leading batch axis (BlockADMM's data partitions,
(P, k, n) with Y (P, n) or (P, k, n)) is computed in one call, and a
batched ``evaluate`` sums over the batch too.

``graphable`` says whether ``prox`` runs without reading the device, so
that a step around it can be captured as a CUDA graph: true for the
elementwise losses, false for the logistic loss, whose damped Newton
stops when every example has converged.  It runs its Newton steps in
chunks of :data:`NEWTON_CHUNK` and reads that flag once per chunk, as
the Krylov solvers read theirs; its Armijo search reads nothing (every
step size is tried at once).  Steps are masked per example, so an
example that has converged keeps its value exactly, a step past the
point where all have converged changes nothing, and the iteration
counts are the JAX package's ``lax.while_loop``'s.
"""

from __future__ import annotations

import torch

__all__ = [
    "SquaredLoss",
    "LadLoss",
    "HingeLoss",
    "LogisticLoss",
    "EmptyRegularizer",
    "L2Regularizer",
    "L1Regularizer",
    "LOSSES",
    "REGULARIZERS",
    "get_loss",
    "get_regularizer",
]

#: Masked Newton steps of the logistic prox between two reads of its
#: convergence flag.  In BlockADMM every example had converged after 2-3
#: steps (the last one finding all done), so most calls read once.
NEWTON_CHUNK = 3


def _one_hot(Y, k: int, dtype) -> torch.Tensor:
    """(..., k, n) indicator of the class indices Y (..., n); an index
    outside [0, k) gives a zero column, as ``jax.nn.one_hot`` does.  A
    comparison, so that no device value is read."""
    cls = Y.to(torch.int64).unsqueeze(-2)
    return (cls == torch.arange(k, device=Y.device)[:, None]).to(dtype)


def _multiclass(O) -> bool:
    return O.ndim >= 2 and O.shape[-2] > 1


class SquaredLoss:
    """½‖O − Y‖² (≙ ``squaredloss_t``, loss.hpp:26-105)."""

    name = "squared"
    label_based = False  # takes numeric targets (coded ±1 for classes)
    graphable = True

    def evaluate(self, O, Y):
        return 0.5 * torch.sum((O - Y) ** 2)

    def prox(self, V, lam, Y):
        # argmin lam/2 (x-y)² + ½(x-v)² = (v + lam·y)/(1 + lam)
        return (V + lam * Y) / (1.0 + lam)


class LadLoss:
    """‖O − Y‖₁ — least absolute deviations (≙ ``ladloss_t``,
    loss.hpp:107-201)."""

    name = "lad"
    label_based = False
    graphable = True

    def evaluate(self, O, Y):
        return torch.sum(torch.abs(O - Y))

    def prox(self, V, lam, Y):
        D = V - Y
        return Y + torch.sign(D) * torch.clamp(torch.abs(D) - lam, min=0.0)


class HingeLoss:
    """Σ max(0, 1 − y·o) with the reference's multiclass extension
    (≙ ``hingeloss_t``, loss.hpp:203-306).

    Binary: Y ∈ {−1, +1}, O (1, n).  Multiclass: Y holds class indices
    (0..k−1), O (k, n); class c is coded +1 in row c and −1 elsewhere,
    and the binary hinge applies per row.
    """

    name = "hinge"
    label_based = True  # takes class indices (multiclass) or ±1 (binary)
    graphable = True

    def _code(self, O, Y):
        if _multiclass(O):
            return 2.0 * _one_hot(Y, O.shape[-2], O.dtype) - 1.0
        return Y.reshape(O.shape).to(O.dtype)

    def evaluate(self, O, Y):
        C = self._code(O, Y)
        return torch.sum(torch.clamp(1.0 - C * O, min=0.0))

    def prox(self, V, lam, Y):
        C = self._code(V, Y)
        yv = C * V
        # piecewise prox of x ↦ lam·max(0, 1 − yx)
        shifted = torch.where(yv < 1.0 - lam, V + lam * C, C)
        return torch.where(yv > 1.0, V, shifted)


class LogisticLoss:
    """Multinomial logistic −log softmax (≙ ``logisticloss_t``,
    loss.hpp:309-440).

    The prox is solved as the reference's ``logexp`` does: damped Newton
    with Armijo backtracking (α = 0.1, β = 0.5), stopping on the Newton
    decrement ``gᵀu < 2ε`` with ε = 1e-4 or after 100 steps
    (``loss.hpp:365-420``), at most 30 halvings per step.  Multiclass
    uses the exact softmax Hessian through a Sherman-Morrison solve
    (diag + rank 1, the reference's ``u/z/pu/pptil`` recurrence)."""

    name = "logistic"
    label_based = True
    graphable = False  # reads the convergence flag (module docstring)

    def __init__(self, max_newton_steps: int = 100, epsilon: float = 1e-4):
        self.max_newton_steps = max_newton_steps
        self.epsilon = epsilon

    _ALPHA = 0.1  # Armijo slope fraction (loss.hpp:370)
    _BETA = 0.5  # step halving factor (loss.hpp:371)
    _MAX_HALVINGS = 30

    def _is_binary(self, O):
        return not _multiclass(O)

    def evaluate(self, O, Y):
        if self._is_binary(O):
            # log(1 + exp(−y·o)), Y ∈ {−1, +1}
            yo = Y.reshape(O.shape).to(O.dtype) * O
            return torch.sum(torch.logaddexp(torch.zeros_like(yo), -yo))
        cls = Y.to(torch.int64).unsqueeze(-2)
        logZ = torch.logsumexp(O, dim=-2)
        picked = torch.take_along_dim(O, cls, dim=-2).squeeze(-2)
        return torch.sum(logZ - picked)

    def _damped_newton(self, x0, obj, grad_dir):
        """The guarded Newton loop: ``grad_dir(X) -> (G, U)`` gives the
        gradient and Newton direction; Armijo backtracking per example;
        stop when every example's Newton decrement ``ΣG·U`` is below 2ε
        (≙ the decrement test + line search of ``loss.hpp:389-416``).

        Chunks of :data:`NEWTON_CHUNK` masked steps, one read of the
        flag after each (never past ``max_newton_steps`` in all)."""
        X = x0
        done = torch.zeros(x0.shape[:-2] + x0.shape[-1:], dtype=torch.bool,
                           device=x0.device)
        # The Armijo search's step sizes β^j, j = 0..30: powers of two,
        # as exact as the JAX loop's repeated halving.
        steps = torch.tensor([self._BETA ** j for j in range(self._MAX_HALVINGS + 1)],
                             dtype=x0.dtype, device=x0.device)
        steps = steps.reshape((-1,) + (1,) * done.ndim)
        taken = 0
        while taken < self.max_newton_steps:
            for _ in range(min(NEWTON_CHUNK, self.max_newton_steps - taken)):
                X, done = self._newton_step(X, done, obj, grad_dir, steps)
            taken += NEWTON_CHUNK
            if bool(done.all()):  # one read per chunk
                break
        return X

    def _newton_step(self, X, done, obj, grad_dir, steps):
        """One masked Newton step.  The JAX loop halves the step of each
        example still failing the Armijo test, at most 30 times, so an
        example that has not converged ends with t = β^j, j the first
        step size that passes (30 if none does): every β^j is tried in
        one batched evaluation and the first that passes is taken."""
        G, U = grad_dir(X)
        dec = torch.sum(G * U, dim=-2)  # per-example Newton decrement
        done = done | (dec < 2.0 * self.epsilon)
        f0 = obj(X)
        trial = obj(X - steps.unsqueeze(-2) * U)  # (31, ..., n)
        passes = ~(trial > f0 - self._ALPHA * steps * dec)
        first = torch.where(passes.any(0), passes.to(torch.uint8).argmax(0),
                            self._MAX_HALVINGS)
        t = steps.reshape(-1)[first]
        return torch.where(done.unsqueeze(-2), X, X - t.unsqueeze(-2) * U), done

    def prox(self, V, lam, Y):
        if self._is_binary(V):
            # Guarded Newton on  lam·log(1+exp(−y·x)) + ½(x−v)²  per
            # element (shape (..., 1, n) or (n,)).
            shape = V.shape
            V2 = V.reshape(V.shape[:-2] + (1, V.shape[-1])) if V.ndim >= 2 else V[None]
            yv = Y.reshape(V2.shape).to(V.dtype)

            def obj(X):
                return torch.sum(
                    lam * torch.logaddexp(torch.zeros_like(X), -yv * X)
                    + 0.5 * (X - V2) ** 2,
                    dim=-2,
                )

            def grad_dir(X):
                sig = torch.sigmoid(-yv * X)
                g = -lam * yv * sig + (X - V2)
                h = lam * sig * (1.0 - sig) + 1.0
                return g, g / h

            return self._damped_newton(V2, obj, grad_dir).reshape(shape)

        k = V.shape[-2]
        E = _one_hot(Y, k, V.dtype)  # (..., k, n)

        def obj(X):
            logZ = torch.logsumexp(X, dim=-2)
            return lam * (logZ - torch.sum(E * X, dim=-2)) + 0.5 * torch.sum(
                (X - V) ** 2, dim=-2
            )

        def grad_dir(X):
            # Hessian = diag(lam·p + 1) − lam·p pᵀ per example; exact
            # Newton direction by Sherman-Morrison (≙ the u/z/pu/pptil
            # recurrence of loss.hpp:381-397).
            Pr = torch.softmax(X, dim=-2)
            G = lam * (Pr - E) + (X - V)
            D = lam * Pr + 1.0
            U0 = G / D
            Z = Pr / D
            pu = torch.sum(Pr * U0, dim=-2)
            pptil = 1.0 - lam * torch.sum(Pr * Z, dim=-2)
            U = U0 + (lam * pu / pptil).unsqueeze(-2) * Z
            return G, U

        return self._damped_newton(V, obj, grad_dir)


class EmptyRegularizer:
    """No regularization (≙ ``empty_regularizer_t``)."""

    name = "none"

    def evaluate(self, W):
        return torch.zeros((), dtype=W.dtype, device=W.device)

    def prox(self, V, lam):
        return V


class L2Regularizer:
    """½‖W‖² (≙ ``l2_regularizer_t``): prox = V/(1+lam)."""

    name = "l2"

    def evaluate(self, W):
        return 0.5 * torch.sum(W * W)

    def prox(self, V, lam):
        return V / (1.0 + lam)


class L1Regularizer:
    """‖W‖₁ (≙ ``l1_regularizer_t``): soft threshold."""

    name = "l1"

    def evaluate(self, W):
        return torch.sum(torch.abs(W))

    def prox(self, V, lam):
        return torch.sign(V) * torch.clamp(torch.abs(V) - lam, min=0.0)


LOSSES = {
    "squared": SquaredLoss,
    "lad": LadLoss,
    "hinge": HingeLoss,
    "logistic": LogisticLoss,
}

REGULARIZERS = {
    "none": EmptyRegularizer,
    "l2": L2Regularizer,
    "l1": L1Regularizer,
}


def get_loss(name: str):
    return LOSSES[name]()


def get_regularizer(name: str):
    return REGULARIZERS[name]()
