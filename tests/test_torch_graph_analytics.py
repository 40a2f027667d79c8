"""Port vs JAX package: the graph analytics — approximate adjacency
spectral embedding (``graph/ase.py``), local community detection
(``graph/community.py``) and the Chebyshev collocation utilities it uses
(``linalg/spectral.py``), with ``utils/deps.require``.

The community detection and the spectral utilities are host numpy code
in both packages, so they are held equal: the same collocation matrices
bitwise, the same diffusion values, the same cluster and conductance.
The ASE runs the port's randomized symmetric SVD on the same counter
stream in f64: λ within 1e-10 of the largest, the embedding within
1e-10 up to each column's sign.  The graphs are the JAX package's own
test graphs (``tests/test_graph.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.linalg import spectral as jspectral
from libskylark_tpu.utils import deps as jdeps
from libskylark_tpu_torch.linalg import spectral as tspectral
from libskylark_tpu_torch.utils import deps as tdeps

ASE_TOL = 1e-10


def _two_community_edges(rng, n_per=30, p_in=0.5, p_out=0.02):
    n = 2 * n_per
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < (p_in if (i < n_per) == (j < n_per) else p_out)]


def _locality_edges(rng, n_bg=40_000, m_bg=200_000, nc=60):
    """A planted 60-vertex cluster in a ~200k-edge background."""
    e_bg = rng.integers(0, n_bg, (m_bg, 2))
    e_in = np.argwhere(rng.random((nc, nc)) < 0.5)
    e_out = np.stack([rng.integers(0, nc, 150), rng.integers(nc, n_bg, 150)], 1)
    return list(map(tuple, np.vstack([e_bg, e_in, e_out]).tolist()))


def _graphs(edges):
    return J.graph.SimpleGraph(edges), T.graph.SimpleGraph(edges)


@pytest.mark.parametrize("N,a,b", [(2, -1.0, 1.0), (9, 0.0, 5.0), (12, 0.0, 2.0), (8, -1.0, 1.0),
                                   (31, 0.5, 3.0)])
def test_chebyshev_utilities_equal_jax(N, a, b):
    np.testing.assert_array_equal(tspectral.chebyshev_points(N, a, b),
                                  jspectral.chebyshev_points(N, a, b))
    Dt, xt = T.linalg.chebyshev_diff_matrix(N, a, b)
    Dj, xj = jspectral.chebyshev_diff_matrix(N, a, b)
    np.testing.assert_array_equal(Dt, Dj)
    np.testing.assert_array_equal(xt, xj)


def test_require_matches_jax():
    assert tdeps.require("scipy.sparse") is jdeps.require("scipy.sparse")
    for name in ("h5py_not_installed_here", "scipy.not_a_module"):
        with pytest.raises(ImportError) as et:
            tdeps.require(name)
        with pytest.raises(ImportError) as ej:
            jdeps.require(name)
        assert str(et.value) == str(ej.value)


def test_time_dependent_ppr_equals_jax(rng):
    Gj, Gt = _graphs(_two_community_edges(rng, 25))
    for seeds in ({0: 1.0}, {0: 0.5, 3: 0.5}):
        tj, Yj = J.graph.time_dependent_ppr(Gj, seeds)
        tt, Yt = T.graph.time_dependent_ppr(Gt, seeds)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(Yt, Yj)
    assert Yt.shape == (4, Gt.n)


@pytest.mark.parametrize("seeds,recursive", [([0, 1], False), ([0], False), ([0], True)])
def test_find_local_cluster_equals_jax(rng, seeds, recursive):
    Gj, Gt = _graphs(_two_community_edges(rng, 20 if recursive else 25))
    cj, condj = J.graph.find_local_cluster(Gj, seeds, recursive=recursive)
    ct, condt = T.graph.find_local_cluster(Gt, seeds, recursive=recursive)
    assert ct == cj and condt == condj
    assert condt < 0.5


def test_find_local_cluster_locality_graph_equals_jax(rng):
    Gj, Gt = _graphs(_locality_edges(rng))
    seeds = [Gt.index[i] for i in range(3) if i in Gt.index]
    tj, Yj = J.graph.time_dependent_ppr(Gj, {v: 1.0 / len(seeds) for v in seeds}, epsilon=1e-4)
    tt, Yt = T.graph.time_dependent_ppr(Gt, {v: 1.0 / len(seeds) for v in seeds}, epsilon=1e-4)
    np.testing.assert_array_equal(Yt, Yj)
    assert np.flatnonzero(np.abs(Yt).max(axis=0) > 0).size < Gt.n // 20  # local work
    cj, condj = J.graph.find_local_cluster(Gj, seeds, epsilon=1e-4)
    ct, condt = T.graph.find_local_cluster(Gt, seeds, epsilon=1e-4)
    assert ct == cj and condt == condj
    names = {Gt.vertices[v] for v in ct}
    assert sum(1 for v in names if v < 60) / len(ct) > 0.9 and condt < 0.4


def test_ase_params_defaults_match_jax():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(T.graph.ASEParams) == fields(J.graph.ASEParams)
    assert issubclass(T.graph.ASEParams, T.linalg.SVDParams)


@pytest.fixture
def f64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.mark.parametrize("params", [{}, {"sparse": True}, {"num_iterations": 2},
                                    {"sparse": True, "num_iterations": 1, "oversampling_ratio": 3},
                                    {"streamed": True, "batch_edges": 64}])
def test_approximate_ase_matches_jax(rng, f64_default, params):
    Gj, Gt = _graphs(_two_community_edges(rng, 30, p_in=0.7, p_out=0.02))
    Xj, lj = J.graph.approximate_ase(Gj, 3, J.SketchContext(seed=2), J.graph.ASEParams(**params))
    Xt, lt = T.graph.approximate_ase(Gt, 3, T.SketchContext(seed=2), T.graph.ASEParams(**params),
                                     device="cpu")
    assert Xt.dtype == lt.dtype == torch.float64 and tuple(Xt.shape) == (Gt.n, 3)
    lj, Xj = np.asarray(lj), np.asarray(Xj)
    assert np.abs(lt.numpy() - lj).max() <= ASE_TOL * np.abs(lj).max()
    signs = np.sign((Xt.numpy() * Xj).sum(axis=0))
    assert np.abs(Xt.numpy() * signs - Xj).max() <= ASE_TOL * np.abs(Xj).max()


def test_approximate_ase_takes_an_adjacency(rng, f64_default):
    Gj, Gt = _graphs(_two_community_edges(rng, 15))
    A = Gt.adjacency()
    Xt, lt = T.graph.approximate_ase(torch.from_numpy(A), 2, T.SketchContext(seed=4))
    Xg, lg = T.graph.approximate_ase(Gt, 2, T.SketchContext(seed=4), device="cpu")
    assert torch.equal(lt, lg) and torch.equal(Xt, Xg)
    Xs, ls = T.graph.approximate_ase(Gt.adjacency_coo(device="cpu"), 2, T.SketchContext(seed=4))
    assert torch.allclose(ls, lg, rtol=1e-12)
    _, lj = J.graph.approximate_ase(A, 2, J.SketchContext(seed=4))
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= ASE_TOL * np.abs(np.asarray(lj)).max()


def test_streamed_ase_refuses_power_iterations(rng):
    _, Gt = _graphs(_two_community_edges(rng, 10))
    with pytest.raises(T.utils.InvalidParameters, match="one-pass"):
        T.graph.approximate_ase(Gt, 2, T.SketchContext(),
                                T.graph.ASEParams(streamed=True, num_iterations=1), device="cpu")
