"""Seed-set local community detection via time-dependent personalized
PageRank diffusion (port of ``libskylark_tpu/graph/community.py``).

≙ ``TimeDependentPPR`` + ``FindLocalCluster``
(``ml/graph/local_computations.hpp:50-374``; Avron-Horesh ICML'15): solve
the diffusion ODE

    dy/dt = −(I − α·A·D⁻¹)·y,   y(0) = s,   t ∈ [0, γ]

by Chebyshev spectral collocation in time (N points from the reference's
Bessel bound), then sweep-cut the degree-normalized y at NX time samples
by conductance.

This module is host code, as it is in the JAX package: numpy and scipy
sparse products over the graph's CSR arrays, with no device work.  Its
work scales with the cluster's volume, not the graph's: the collocation
fixed point ``Y ← G₀⁻¹(α·W·Y + BC)`` runs restricted to an active
support, and after each converged restricted solve the frontier residual
``α·(W·Y)|_inactive`` is compared against the reference's per-vertex
truncation bound ``C·deg``; violating neighbours join the support and the
solve repeats (the vectorized form of the reference's push queue).  The
sweep cut is a cumulative-volume / internal-edge-count formulation,
O(vol(support)).
"""

from __future__ import annotations

import numpy as np

from ..linalg.spectral import chebyshev_diff_matrix
from ..utils.deps import require

__all__ = ["time_dependent_ppr", "find_local_cluster"]


def _min_chebyshev_points(gamma: float, epsilon: float) -> int:
    """Bessel-function bound for the number of time collocation points
    (≙ local_computations.hpp:64-77)."""
    iv = require("scipy.special").iv

    minN = 10
    C = 20.0 * np.sqrt(minN) * np.exp(-gamma / 2)
    while (
        C * iv(minN, gamma) * 0.8**minN
        > epsilon / (gamma * (1 + (2 / np.pi) * np.log(minN - 1)))
    ):
        minN += 1
    return minN


def _truncation_constant(alpha, gamma, epsilon, N) -> float:
    """Per-vertex residual truncation scale C: a vertex participates when
    its residual exceeds ``C·deg`` (≙ local_computations.hpp:126-131)."""
    LC = 1 + (2 / np.pi) * np.log(N - 1)
    if alpha < 1:
        return (1 - alpha) * epsilon / ((1 - np.exp((alpha - 1) * gamma)) * LC)
    return epsilon / (gamma * LC)


def _active_edges(G, act):
    """(src_local, nbr_global) concatenated adjacency of the active set —
    O(vol(act)), no Python per-vertex loop."""
    counts = (G.indptr[act + 1] - G.indptr[act]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    # Concatenated [indptr[v], indptr[v]+counts[v]) ranges via one iota.
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = np.arange(total) + np.repeat(G.indptr[act] - cum, counts)
    return np.repeat(np.arange(len(act)), counts), G.indices[flat]


def time_dependent_ppr(
    G,
    seeds: dict,
    alpha: float = 0.85,
    gamma: float = 5.0,
    epsilon: float = 0.001,
    NX: int = 4,
    max_fp_iters: int = 1000,
):
    """Returns ``(times, Y)``: Y (NX, n) diffusion values at NX times.

    ``seeds``: vertex-id → initial mass (≙ the s map).  Y is dense over
    the graph but only the active support's columns are nonzero; the
    computation never touches vertices outside support ∪ frontier.
    """
    sp = require("scipy.sparse")

    n = G.n
    minN = _min_chebyshev_points(gamma, epsilon)
    N = minN if minN % NX == 0 else (minN // NX + 1) * NX
    NR = N // NX

    D, x = chebyshev_diff_matrix(N, 0.0, gamma)  # x descending γ → 0
    i0 = N - 1  # collocation row for t = 0 (initial condition)

    # G0·Y = α·(W·yᵗ rows) + BC, with W = A·D⁻¹ applied via neighbor sums.
    G0 = D + np.eye(N)
    G0[i0, :] = 0.0
    G0[i0, i0] = 1.0
    G0inv = np.linalg.inv(G0)

    C_bound = _truncation_constant(alpha, gamma, epsilon, N)
    deg_full = G.degrees.astype(np.float64)

    seed_ids = np.asarray(sorted(int(v) for v in seeds), np.int64)
    seed_mass = np.asarray([float(seeds[int(v)]) for v in seed_ids])

    # Inner solve tighter than the discretization error by 1e-3, floored so
    # loose --epsilon still converges the fixed point reasonably.
    tol = max(epsilon * 1e-3, 1e-12)

    act = seed_ids.copy()  # active support, sorted
    Y = np.zeros((N, len(act)))
    pos = np.full(n, -1, np.int64)

    max_rounds = 64  # support spreads ≤ 1 hop per round
    for _round in range(max_rounds):
        k = len(act)
        pos[:] = -1
        pos[act] = np.arange(k)
        deg_act = np.maximum(deg_full[act], 1.0)
        src, nbr = _active_edges(G, act)
        npos = pos[nbr]
        inside = npos >= 0

        # Restricted W|SS (k×k): (W y)_v = Σ_{u∈N(v)∩S} y_u/deg_u.
        W_SS = sp.csr_matrix(
            (
                1.0 / deg_act[npos[inside]],
                (src[inside], npos[inside]),
            ),
            shape=(k, k),
        )
        s_vec = np.zeros(k)
        s_vec[pos[seed_ids]] = seed_mass

        # Converge the fixed point on the current support.
        delta = np.inf
        for _ in range(max_fp_iters):
            RHS = alpha * (W_SS @ Y.T).T
            RHS[i0] = s_vec
            Y_new = G0inv @ RHS
            delta = np.max(np.abs(Y_new - Y)) if Y.size else 0.0
            Y = Y_new
            if delta < tol:
                break
        else:
            import warnings

            warnings.warn(
                f"time_dependent_ppr fixed point not converged "
                f"(delta={delta:.2e} > tol={tol:.2e} after "
                f"{max_fp_iters} iters)"
            )

        # Frontier residual: inactive u gets α Σ_{v∈N(u)∩S} y_v/deg_v;
        # activate where any component exceeds C·deg(u)
        # (≙ the |r_j| > B = C·odeg queue test, local_computations.hpp:
        # 180-196, 238-249).
        out_nbr = nbr[~inside]
        if out_nbr.size == 0:
            break
        uniq, inv = np.unique(out_nbr, return_inverse=True)
        Rf = np.zeros((N, len(uniq)))
        contrib = (Y / deg_act[None, :])[:, src[~inside]]
        np.add.at(Rf.T, inv, contrib.T)
        bound = C_bound * np.maximum(deg_full[uniq], 1.0)
        viol = uniq[np.max(np.abs(alpha * Rf), axis=0) > bound]
        if viol.size == 0:
            break
        act_new = np.union1d(act, viol)
        # Re-seat Y columns into the grown support.
        Y_grown = np.zeros((N, len(act_new)))
        Y_grown[:, np.searchsorted(act_new, act)] = Y
        act, Y = act_new, Y_grown
    else:
        import warnings

        warnings.warn(
            f"time_dependent_ppr support still growing after {max_rounds} "
            f"rounds ({viol.size} frontier vertices above the truncation "
            "bound); returning the truncated diffusion — increase epsilon "
            "or expect reduced accuracy"
        )

    sample_idx = np.arange(NX) * NR
    Y_full = np.zeros((NX, n))
    Y_full[:, act] = Y[sample_idx]
    return x[sample_idx], Y_full


def _sweep_cut(G, vals, Gvol):
    """Best-conductance prefix of the support of ``vals`` (degree-normalized
    diffusion values), vectorized (≙ the per-node loop of
    ``local_computations.hpp:316-352``).

    Returns ``(order, best_prefix, best_cond)``; ``order`` is the support
    sorted by descending value (ties by vertex id, matching the
    reference's pair sort)."""
    deg = G.degrees
    support = np.flatnonzero(vals > 1e-12)
    if support.size == 0:
        return support, 0, 1.0
    order = support[np.argsort(-vals[support], kind="stable")]
    k = len(order)
    prefix_pos = np.full(G.n, -1, np.int64)
    prefix_pos[order] = np.arange(k)

    volS = np.cumsum(deg[order].astype(np.int64))
    # An edge (u, v) with both endpoints in the support becomes internal
    # at prefix index max(pos_u, pos_v); each undirected edge appears
    # twice in the arc list, so the bincount counts 2·internal — exactly
    # the -2 the serial loop applies per internal edge.
    src, nbr = _active_edges(G, order)
    npos = prefix_pos[nbr]
    both = npos >= 0
    t_at = np.maximum(src[both], npos[both])
    intern2 = np.cumsum(np.bincount(t_at, minlength=k))
    cutS = volS - intern2
    denom = np.minimum(volS, Gvol - volS)
    cond = np.where(denom > 0, cutS / np.maximum(denom, 1), np.inf)
    best = int(np.argmin(cond))
    best_cond = float(cond[best])
    if best_cond >= 1.0:  # reference keeps bestprefix=0, bestcond=1.0
        return order, 0, 1.0
    return order, best, best_cond


def find_local_cluster(
    G,
    seeds,
    alpha: float = 0.85,
    gamma: float = 5.0,
    epsilon: float = 0.001,
    NX: int = 4,
    recursive: bool = False,
):
    """Returns ``(cluster, conductance)``; cluster is a set of vertex ids.

    ≙ ``FindLocalCluster`` (local_computations.hpp:288-374): run the
    diffusion from the (uniform-mass) seed set, sweep the
    degree-normalized values at each time sample for the best-conductance
    prefix; optionally recurse with the found cluster as the new seed.
    """
    cluster = set(int(v) for v in seeds)
    current_cond = None
    deg = G.degrees
    Gvol = G.volume

    while True:
        s = {v: 1.0 / len(cluster) for v in cluster}
        _, Y = time_dependent_ppr(G, s, alpha, gamma, epsilon, NX)
        improve = False
        for t in range(Y.shape[0]):
            vals = Y[t] / np.maximum(deg, 1)
            order, best_prefix, best_cond = _sweep_cut(G, vals, Gvol)
            if order.size == 0:
                continue
            if current_cond is None or best_cond < 0.999999 * current_cond:
                improve = True
                cluster = set(int(v) for v in order[: best_prefix + 1])
                current_cond = best_cond
        if not (recursive and improve):
            break

    return cluster, current_cond
