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
and ``chunked`` run the same step, so their models are bitwise equal;
``ml.distributed`` runs it too (``_admm_step``), over a rank's
partitions with the consensus summed over the ranks.
A row-sharded X (:class:`~libskylark_tpu_torch.parallel.mesh.Sharded`)
lays the data partitions over the mesh's slots: each slot runs the
local half on its partitions and the consensus sums are psum'd in slot
order (``_admm_step_sharded``), as the JAX package's psum over the
partition axis; ``predict`` of a sharded X is row-sharded.
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

from .._device import as_tensor, is_sharded
from ..core.params import Params
from ..core.random import _const
from ..parallel import routes
from ..parallel import mesh as pmesh
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


def _targets(loss, Y, classes, regression: bool, P: int, ni: int, dtype, dev):
    """``(Yp, k, classes)``: the targets partitioned as (P, k, ni), or,
    for the label-based losses, class indices (P, ni)."""
    if regression:
        T = as_tensor(Y, dev)
        T = T[:, None] if T.ndim == 1 else T
        k = T.shape[1]
        return T.reshape(P, ni, k).transpose(1, 2).contiguous(), k, classes
    T, classes = dummy_coding(Y, classes, dtype=dtype, device=dev)
    k = T.shape[1]
    if getattr(loss, "label_based", False):
        # Hinge/logistic take class indices (≙ the reference's crammed
        # losses consuming the raw label vector).
        cls = np.searchsorted(np.asarray(classes), host_labels(Y))
        return torch.as_tensor(cls, device=dev).to(dtype).reshape(P, ni), k, classes
    return T.reshape(P, ni, k).transpose(1, 2).contiguous(), k, classes


def _factor(Zs, timer):
    """Cached (Z·Zᵀ + I)⁻¹ per (partition, block), from its Cholesky
    factor (≙ Cache[j] = inv(Z·Zᵀ + I), BlockADMM.hpp:437-441: the
    reference caches the inverse too).  Applying it is one batched
    product; the JAX package's two triangular solves per step with k
    right-hand sides are latency-bound on the card."""
    with timer.phase("factor") as ph:
        Cinvs = []
        for Z in Zs:
            G = _psd_gram(Z.transpose(1, 2), Z)
            L = _cholesky(G + torch.eye(G.shape[-1], dtype=G.dtype, device=G.device))
            Cinvs.append(torch.cholesky_inverse(L))
        ph.result = Cinvs
    return Cinvs


_LOCAL_KEYS = ("O", "Obar", "nu", "del_o", "mu_ij", "ZtObar")


def _admm_halves(loss, reg, maps, p, Zs, Cinvs, Yp, k: int, P_total: int):
    """``(local, consensus, local0, rep0)`` of one ADMM iteration.

    ``local(s, Wbar)`` is the half over the partitions ``Zs`` holds
    (their loss prox and block updates): it returns the partitions' new
    state, their Σ Wi and their loss.  ``consensus(s, wi, obj_loss)``
    takes those summed over ALL ``P_total`` partitions and returns the
    replicated state.  ``local0``/``rep0`` are the initial states."""
    P = Zs[0].shape[0]
    ni = Zs[0].shape[1]
    dtype, dev = Zs[0].dtype, Zs[0].device
    J = len(maps)
    starts = np.cumsum([0] + [S.s for S in maps]).tolist()
    D = starts[-1]
    rho = _const(p.rho, dtype, dev)
    lam = _const(p.lam, dtype, dev)
    inv_rho, lam_rho = 1.0 / rho, lam / rho
    split = math.gcd(ni, _SPLIT)

    def zt_mul(Z, B):
        return _zt_mul(Z, B, split)

    def local(s, Wbar):
        mu_ij = s["mu_ij"] - Wbar[None]
        Obar = s["Obar"] - s["nu"]
        O = loss.prox(Obar, inv_rho, Yp)

        sum_o = torch.zeros_like(O)
        wbar_out = torch.zeros_like(O)
        dsum = (s["del_o"] / (J + 1.0) + s["nu"]).transpose(1, 2).contiguous()  # (P, ni, k)
        Wi, mu_ij_new, ZtObar_new = [], [], []
        for j in range(J):
            lo, hi = starts[j], starts[j + 1]
            Z, Wbar_j = Zs[j], Wbar[lo:hi]
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
        out = dict(O=O, Obar=Obar, nu=nu, del_o=del_o, mu_ij=torch.cat(mu_ij_new, dim=1),
                   ZtObar=torch.cat(ZtObar_new, dim=1))
        return out, torch.cat(Wi, dim=1).sum(dim=0), loss.evaluate(wbar_out, Yp)

    def consensus(s, wi, obj_loss):
        # Consensus: the sum over partitions (≙ the MPI reduce of Wi,
        # BlockADMM.hpp:574-578), over every rank's partitions.
        W = reg.prox(s["Wbar"] - s["mu"], lam_rho)
        Wbar = (wi + W) / (P_total + 1.0)
        mu = s["mu"] + W - Wbar
        obj = obj_loss + lam * reg.evaluate(Wbar)
        return dict(it=s["it"] + 1, Wbar=Wbar, W=W, mu=mu, obj=obj,
                    objs=s["objs"].index_copy(0, s["it"].reshape(1), obj.reshape(1)))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    local0 = dict(O=zeros(P, k, ni), Obar=zeros(P, k, ni), nu=zeros(P, k, ni),
                  del_o=zeros(P, k, ni), mu_ij=zeros(P, D, k), ZtObar=zeros(P, D, k))
    rep0 = dict(
        it=torch.zeros((), dtype=torch.int64, device=dev),
        Wbar=zeros(D, k), W=zeros(D, k), mu=zeros(D, k),
        obj=zeros(),
        objs=zeros(max(int(p.maxiter), 1)),  # the objective trace
    )
    return local, consensus, local0, rep0


def _ordered(rep, loc):
    """The state dict in its one key order (a graph's static state)."""
    out = {key: rep[key] for key in ("it", "Wbar", "W", "mu")}
    out.update((key, loc[key]) for key in _LOCAL_KEYS)
    out.update(obj=rep["obj"], objs=rep["objs"])
    return out


def _admm_step(loss, reg, maps, p, Zs, Cinvs, Yp, k: int, P_total: int, merge=None):
    """``(state0, step, graphed)`` of the ADMM iteration over this
    process's partitions: ``Zs`` (P_local, ni, s_j), ``Cinvs`` their
    cached inverses, ``Yp`` the partitioned targets.  The consensus needs
    Σ over ALL ``P_total`` partitions of Wi (and the loss summed over
    them): ``merge({"wi", "obj"})`` sums this process's parts over the
    ranks of a distributed trainer (it runs eagerly, between the local
    half and the consensus); None (one process) takes the local sums as
    they are, and the step is the single-process trainer's, op for op,
    captured as one CUDA graph where it can be."""
    local, consensus, local0, rep0 = _admm_halves(loss, reg, maps, p, Zs, Cinvs, Yp, k,
                                                  P_total)

    def step(s):
        loc, wi, obj_loss = local(s, s["Wbar"])
        if merge is not None:
            g = merge({"wi": wi, "obj": obj_loss})
            wi, obj_loss = g["wi"], g["obj"]
        return _ordered(consensus(s, wi, obj_loss), loc)

    graphed = merge is None and loss.graphable and graphable(*Zs, *Cinvs, Yp)
    return _ordered(rep0, local0), step, graphed


def _admm_step_sharded(loss, reg, maps, p, slots, k: int, P_total: int):
    """``(state0, step)`` of the ADMM iteration with the data partitions
    laid over a mesh's slots: ``slots`` holds per slot its ``(Zs, Cinvs,
    Yp)``.  Each slot runs the local half on its device with the
    replicated Wbar; Σ Wi and the loss are psum'd in slot order onto slot
    0's device, where the consensus runs (the JAX package's psum over
    the data-partition axis).  The state keeps each slot's partitions'
    state under ``"slots"``."""
    halves = [_admm_halves(loss, reg, maps, p, Zs, Cinvs, Yp, k, P_total)
              for Zs, Cinvs, Yp in slots]
    consensus, rep0 = halves[0][1], halves[0][3]
    dev0 = rep0["Wbar"].device

    def step(s):
        outs = [h[0](loc, s["Wbar"].to(loc["O"].device)) for h, loc in zip(halves, s["slots"])]
        wi = pmesh.psum([o[1] for o in outs], dev0)
        obj_loss = pmesh.psum([o[2] for o in outs], dev0)
        return dict(consensus(s, wi, obj_loss), slots=tuple(o[0] for o in outs))

    return dict(rep0, slots=tuple(h[2] for h in halves)), step


def _clone_state(st: dict) -> dict:
    return {key: (tuple({k: t.clone() for k, t in d.items()} for d in v)
                  if key == "slots" else v.clone()) for key, v in st.items()}


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
        X, _ = routes.operands(X, device=device)
        n, d = X.shape
        P = int(p.data_partitions)
        if n % P:
            raise ValueError(f"n={n} not divisible by data_partitions={P}")
        ni = n // P
        if is_sharded(X):
            return self._prepare_sharded(X, Y, classes, regression, P, ni)
        X = _dense(X)
        dev, dtype = X.device, X.dtype

        Yp, k, classes = _targets(self.loss, Y, classes, regression, P, ni, dtype, dev)
        # Phase timers ≙ the reference's ADMM SKYLARK_TIMER instrumentation
        # (transform/iteration/prediction, BlockADMM.hpp:357-365).
        timer = PhaseTimer()
        with timer.phase("transform") as ph:
            Zs = [self._apply_map(S, X, P) for S in self.maps]  # (P, ni, sj)
            ph.result = Zs
        Cinvs = _factor(Zs, timer)
        state, step, graphed = _admm_step(self.loss, self.regularizer, self.maps, p, Zs, Cinvs,
                                          Yp, k, P)
        return _PreparedRun(
            state0=state, step=step, graphed=graphed, timer=timer, d=d, classes=classes,
            device=dev,
        )

    def _prepare_sharded(self, X, Y, classes, regression: bool, P: int, ni: int):
        """:meth:`_prepare` for a row-sharded X: the P data partitions laid
        over the mesh's slots in order (slot k holds partitions
        ``[k·P/p, (k+1)·P/p)``, which are its rows), each slot making its
        partitions' feature blocks and factors on its device."""
        nslots = X.mesh.size
        if P % nslots:
            raise ValueError(f"data_partitions={P} must be a multiple of the mesh's "
                             f"{nslots} slots to lay the partitions over them")
        p, per = self.params, P // nslots
        dev, dtype = routes.device0(X), X.dtype
        Y = pmesh.fully_replicated(Y)  # a column of targets, not X
        Yp, k, classes = _targets(self.loss, Y, classes, regression, P, ni, dtype, dev)
        timer = PhaseTimer()
        slots = []
        for j, x in enumerate(X.shards):
            if not x.is_floating_point():
                x = x.to(torch.float32)
            with timer.phase("transform") as ph:
                Zs = [self._apply_map(S, x, per) for S in self.maps]
                ph.result = Zs
            slots.append((Zs, _factor(Zs, timer), Yp[j * per:(j + 1) * per].to(x.device)))
        state, step = _admm_step_sharded(self.loss, self.regularizer, self.maps, p, slots, k, P)
        return _PreparedRun(state0=state, step=step, graphed=False, timer=timer,
                            d=X.shape[1], classes=classes, device=dev)

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
            init_state=lambda: _clone_state(run.state0),
            step_chunk=step_chunk,
            extract_result=lambda st: self._model(run, st),
            is_done=lambda st: int(st["it"]) >= maxiter,
            iteration=lambda st: int(st["it"]),
            kind="block_admm",
        )
