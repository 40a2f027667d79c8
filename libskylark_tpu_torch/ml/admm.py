"""Block-splitting consensus ADMM kernel-machine trainer (port of
``libskylark_tpu/ml/admm.py``).

≙ ``BlockADMMSolver`` (``ml/BlockADMM.hpp:16-611``): minimizes
``Σ_i loss(o_i, y_i) + λ·reg(W)`` with ``o_i = Σ_j Z_j(x_i)ᵀ W_j`` over
feature-map blocks j, by ADMM with per-(data-partition × feature-block)
local variables and cached ``(Z·Zᵀ + I)`` Cholesky factors.  The update
equations are the JAX package's (``BlockADMM.hpp:374-590``):

  per iter:  mu_ij −= Wbar;  Obar −= nu
             O    = prox_loss(Obar, 1/ρ; Y)
             W    = prox_reg(Wbar − mu, λ/ρ)
             per block j:  rhs  = Wbar_j − mu_ij_j + ZtObar_j
                                  + Z_j·(del_o/(J+1) + nu)ᵀ
                           Wi_j = (Z_jZ_jᵀ + I)⁻¹ rhs      [cached chol]
                           o_j  = Wi_jᵀ Z_j;  mu_ij_j += Wi_j
                           ZtObar_j = Z_j·o_jᵀ;  sum_o += o_j
             del_o = O − sum_o;  Obar = O − del_o/(J+1);  nu += O − Obar
             Wbar = (Σ_partitions Wi + W)/(P+1);  mu += W − Wbar

The JAX package's vmapped data-partition axis is the leading axis P of
plain tensors here, and every per-partition contraction a batched
matmul.  A feature map is columnwise over examples, so each block is
one rowwise apply to the whole X (n, d), kept as (P, n/P, s_j): the
partitions' columnwise blocks, transposed, without a copy.  The per-block
loop is a Python loop, as in the JAX code.  Each (Z·Zᵀ + I) is cached as
its inverse, from its Cholesky factor, as the reference caches it: the
JAX package's two triangular solves with k = 1..10 right-hand sides are
latency-bound on an H100 (2.6 ms per block against 0.08 ms for the
product with the inverse, at bench.py's configuration).  The Zᵀ·B
products sum over a partition's examples in runs (``_SPLIT``), since a
(s_j, k) output alone cannot fill the card.

One iteration is ~10 launches per block plus the loss prox.  Where the
blocks are dense CUDA tensors and the loss's prox reads nothing back
(every loss but the logistic one), :func:`~..resilient.chunked.stepper`
captures one iteration as a CUDA graph and replays it: the same kernels
on the same buffers, bitwise the eager steps
(``resilient.chunked.CUDA_GRAPHS = False`` runs them eagerly).  ``train``
and ``chunked`` run the same step, so their models are bitwise equal.
The Gram products and factors run in at least f32 with TF32 off (the
JAX package's ``precision="highest"``; an indefinite factor gives silent
NaNs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .._device import as_tensor
from ..core.params import Params
from ..core.random import _const
from ..resilient.chunked import ChunkedSolver, graphable, stepper
from ..sketch.base import Dimension
from ..solvers.prox import get_loss, get_regularizer
from ..utils.timer import PhaseTimer
from .coding import dummy_coding, host_labels
from .kernels import _dense
from .krr import _cholesky, _psd_gram
from .model import FeatureMapModel

__all__ = ["ADMMParams", "BlockADMMSolver"]

# Runs of examples that a partition's Zᵀ·B products are split into (the
# largest power of two up to this dividing n/P): at 65536 examples a
# (2048, 2) product split in 32 took 0.86 ms on an H100, in one 2.2 ms.
_SPLIT = 32


def _zt_mul(Z, B, split: int):
    """Σ over a partition's examples of Z[p, i, :]ᵀ B[p, i, :]:
    (P, ni, s) x (P, ni, k) → (P, s, k), summed in ``split`` runs of
    examples (one batched product over P·split, then a sum): the product
    alone has too few outputs to fill the card."""
    P, ni, s = Z.shape
    Zc = Z.reshape(P * split, ni // split, s)
    Bc = B.reshape(P * split, ni // split, B.shape[2])
    return (Zc.transpose(1, 2) @ Bc).reshape(P, split, s, B.shape[2]).sum(1)


@dataclass
class _PreparedRun:
    """What ``train``/``chunked`` need: the step (closing over the feature
    blocks, cached factors and targets) and the initial state, all
    rebuilt deterministically from (X, Y, maps, params)."""

    state0: dict
    step: Callable
    graphed: bool
    timer: PhaseTimer
    d: int
    classes: Any
    device: torch.device


@dataclass
class ADMMParams(Params):
    rho: float = 1.0
    lam: float = 0.01  # regularization weight (≙ lambda)
    maxiter: int = 20
    data_partitions: int = 1  # P (≙ MPI size)
    scale_maps: bool = False  # ≙ ScaleFeatureMaps (sqrt(sj/d) per block)


class BlockADMMSolver:
    """Trainer over a list of feature maps (≙ the ctor taking per-block
    ``featureMaps``; pass maps built by ``kernel.create_rft`` as the
    reference's ``GetSolver`` does, ``ml/hilbert.hpp:11-219``)."""

    def __init__(
        self,
        loss: str,
        regularizer: str,
        feature_maps: Sequence,
        params: ADMMParams | None = None,
    ):
        self.loss = get_loss(loss)
        self.regularizer = get_regularizer(regularizer)
        self.maps = list(feature_maps)
        if not self.maps:
            raise ValueError("BlockADMMSolver needs at least one feature map")
        self.params = params or ADMMParams()

    def _apply_map(self, S, X, P: int):
        """Feature block of X (n, d) for ``P`` partitions: (P, n/P, s),
        row i of partition p the features of example p·n/P + i."""
        n, d = X.shape
        Z = S.apply(X, Dimension.ROWWISE)
        if self.params.scale_maps:
            Z.mul_(_const(math.sqrt(S.s / d), Z.dtype, Z.device))
        return Z.reshape(P, n // P, Z.shape[1])

    def _prepare(self, X, Y, classes=None, regression: bool = False, device=None):
        """Shared setup for :meth:`train` and :meth:`chunked`: realize the
        feature blocks, cache each (Z·Zᵀ + I)⁻¹, build the step and the
        initial state."""
        p = self.params
        X = _dense(X, device)
        n, d = X.shape
        P = int(p.data_partitions)
        if n % P:
            raise ValueError(f"n={n} not divisible by data_partitions={P}")
        ni = n // P
        dev, dtype = X.device, X.dtype

        if regression:
            T = as_tensor(Y, dev)
            T = T[:, None] if T.ndim == 1 else T
            k = T.shape[1]
            Yp = T.reshape(P, ni, k).transpose(1, 2).contiguous()
        else:
            T, classes = dummy_coding(Y, classes, dtype=dtype, device=dev)
            k = T.shape[1]
            if getattr(self.loss, "label_based", False):
                # Hinge/logistic take class indices (≙ the reference's
                # crammed losses consuming the raw label vector).
                cls = np.searchsorted(np.asarray(classes), host_labels(Y))
                Yp = torch.as_tensor(cls, device=dev).to(dtype).reshape(P, ni)
            else:
                Yp = T.reshape(P, ni, k).transpose(1, 2).contiguous()

        J = len(self.maps)
        starts = np.cumsum([0] + [S.s for S in self.maps]).tolist()
        D = starts[-1]

        # Phase timers ≙ the reference's ADMM SKYLARK_TIMER instrumentation
        # (transform/iteration/prediction, BlockADMM.hpp:357-365).
        timer = PhaseTimer()
        with timer.phase("transform") as ph:
            Zs = [self._apply_map(S, X, P) for S in self.maps]  # (P, ni, sj)
            ph.result = Zs
        # Cached (Z·Zᵀ + I)⁻¹ per (partition, block), from its Cholesky
        # factor (≙ Cache[j] = inv(Z·Zᵀ + I), BlockADMM.hpp:437-441: the
        # reference caches the inverse too).  Applying it is one batched
        # product; the JAX package's two triangular solves per step with
        # k right-hand sides are latency-bound on the card.
        with timer.phase("factor") as ph:
            Cinvs = []
            for Z in Zs:
                G = _psd_gram(Z.transpose(1, 2), Z)
                L = _cholesky(G + torch.eye(G.shape[-1], dtype=G.dtype, device=dev))
                Cinvs.append(torch.cholesky_inverse(L))
            ph.result = Cinvs

        rho = _const(p.rho, dtype, dev)
        lam = _const(p.lam, dtype, dev)
        inv_rho, lam_rho = 1.0 / rho, lam / rho
        loss, reg = self.loss, self.regularizer
        split = math.gcd(ni, _SPLIT)

        def zt_mul(Z, B):
            return _zt_mul(Z, B, split)

        def step(s):
            mu_ij = s["mu_ij"] - s["Wbar"][None]
            Obar = s["Obar"] - s["nu"]
            O = loss.prox(Obar, inv_rho, Yp)
            W = reg.prox(s["Wbar"] - s["mu"], lam_rho)

            sum_o = torch.zeros_like(O)
            wbar_out = torch.zeros_like(O)
            dsum = (s["del_o"] / (J + 1.0) + s["nu"]).transpose(1, 2).contiguous()  # (P, ni, k)
            Wi, mu_ij_new, ZtObar_new = [], [], []
            for j in range(J):
                lo, hi = starts[j], starts[j + 1]
                Z, Wbar_j = Zs[j], s["Wbar"][lo:hi]
                wbar_out = wbar_out + torch.bmm(Z, Wbar_j.expand(P, -1, -1)).transpose(1, 2)
                rhs = Wbar_j[None] - mu_ij[:, lo:hi] + s["ZtObar"][:, lo:hi] + zt_mul(Z, dsum)
                C = Cinvs[j]
                Wij = torch.bmm(C, rhs.to(C.dtype)).to(dtype)  # (P, sj, k)
                o = torch.bmm(Z, Wij)  # (P, ni, k)
                Wi.append(Wij)
                mu_ij_new.append(mu_ij[:, lo:hi] + Wij)
                ZtObar_new.append(zt_mul(Z, o))
                sum_o = sum_o + o.transpose(1, 2)

            del_o = O - sum_o
            Obar = O - del_o / (J + 1.0)
            nu = s["nu"] + O - Obar
            # Consensus: the sum over partitions (≙ the MPI reduce of Wi,
            # BlockADMM.hpp:574-578).
            Wbar = (torch.cat(Wi, dim=1).sum(dim=0) + W) / (P + 1.0)
            mu = s["mu"] + W - Wbar
            obj = loss.evaluate(wbar_out, Yp) + lam * reg.evaluate(Wbar)
            return dict(
                it=s["it"] + 1, Wbar=Wbar, W=W, mu=mu, O=O, Obar=Obar, nu=nu,
                del_o=del_o, mu_ij=torch.cat(mu_ij_new, dim=1),
                ZtObar=torch.cat(ZtObar_new, dim=1), obj=obj,
                objs=s["objs"].index_copy(0, s["it"].reshape(1), obj.reshape(1)),
            )

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = dict(
            it=torch.zeros((), dtype=torch.int64, device=dev),
            Wbar=zeros(D, k), W=zeros(D, k), mu=zeros(D, k),
            O=zeros(P, k, ni), Obar=zeros(P, k, ni), nu=zeros(P, k, ni),
            del_o=zeros(P, k, ni),
            mu_ij=zeros(P, D, k), ZtObar=zeros(P, D, k),
            obj=zeros(),
            objs=zeros(max(int(p.maxiter), 1)),  # the objective trace
        )
        graphed = loss.graphable and graphable(*Zs, *Cinvs, Yp)
        return _PreparedRun(
            state0=state, step=step, graphed=graphed, timer=timer, d=d, classes=classes,
            device=dev,
        )

    def _model(self, run: _PreparedRun, state: dict) -> FeatureMapModel:
        it = int(state["it"])
        model = FeatureMapModel(
            self.maps, state["Wbar"].clone(), scale_maps=self.params.scale_maps,
            input_dim=run.d, classes=run.classes,
        )
        model.history = state["objs"][:it].tolist()
        model.val_history = []
        model.timers = run.timer
        return model

    def train(self, X, Y, classes=None, regression: bool = False,
              Xv=None, Yv=None, *, device=None):
        """X (n, d); Y (n,) labels (classification) or (n,)/(n, t) targets
        (regression).  Optional validation set (Xv, Yv) is scored every
        iteration (≙ the per-iteration validation predict,
        ``BlockADMM.hpp:509-540``) into ``model.val_history``.  Returns a
        ``FeatureMapModel`` (with ``.classes``, ``.history`` and
        ``.timers`` attached).  Sparse input is densified."""
        p = self.params
        run = self._prepare(X, Y, classes, regression, device)
        advance = stepper(run.step, run.graphed)
        state, timer, d, classes = run.state0, run.timer, run.d, run.classes
        have_val = Xv is not None and Yv is not None

        if not have_val:
            # All iterations without a read: the objective trace rides the
            # state and is read once at the end.
            with timer.phase("iteration") as ph:
                state = advance(state, p.maxiter)
                ph.result = state
            model = self._model(run, state)
            for it, obj in enumerate(model.history, 1):
                p.log(1, f"iteration {it} objective {obj:.6e}")
        else:
            Xv = _dense(Xv, run.device)
            Yv = host_labels(Yv)
            val_history = []
            for it in range(1, p.maxiter + 1):
                with timer.phase("iteration"):
                    state = advance(state, 1)
                    obj = float(state["obj"])  # the read syncs the step
                msg = f"iteration {it} objective {obj:.6e}"
                with timer.phase("prediction"):
                    interim = FeatureMapModel(self.maps, state["Wbar"],
                                              scale_maps=p.scale_maps, input_dim=d)
                    if regression:
                        pv = interim.predict(Xv).double().cpu().numpy()
                        Yv2 = Yv if Yv.ndim > 1 else Yv[:, None]
                        metric = float(np.linalg.norm(pv - Yv2)
                                       / max(np.linalg.norm(Yv2), 1e-30))
                        msg += f" val relerr {metric:.4f}"
                    else:
                        pv = interim.predict_labels(Xv, classes).cpu().numpy()
                        metric = float((pv == Yv).mean()) * 100
                        msg += f" val accuracy {metric:.2f}"
                val_history.append(metric)
                p.log(1, msg)
            model = self._model(run, state)
            model.val_history = val_history

        p.log(2, timer.report())
        return model

    def chunked(self, X, Y, classes=None, regression: bool = False, *,
                device=None) -> ChunkedSolver:
        """A :class:`ChunkedSolver` over the same step as :meth:`train`:
        its state is the iteration counter, the ADMM state and the
        objective trace; the feature blocks, factors and targets are
        rebuilt by :meth:`_prepare`.  A run in chunks of any size is
        bitwise :meth:`train`'s (without validation).  One host read per
        chunk (the iteration counter)."""
        run = self._prepare(X, Y, classes, regression, device)
        maxiter = int(self.params.maxiter)
        advance = stepper(run.step, run.graphed)

        def step_chunk(st, num_iters: int):
            k = min(int(num_iters), maxiter - int(st["it"]))
            out = advance(st, k)
            # A graph's static state is overwritten by its next replay.
            return ({key: v.clone() for key, v in out.items()}
                    if run.graphed and out is not st else out)

        return ChunkedSolver(
            init_state=lambda: {key: v.clone() for key, v in run.state0.items()},
            step_chunk=step_chunk,
            extract_result=lambda st: self._model(run, st),
            is_done=lambda st: int(st["it"]) >= maxiter,
            iteration=lambda st: int(st["it"]),
            kind="block_admm",
        )
