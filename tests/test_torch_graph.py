"""Port vs JAX package: the graph container, the in-core adjacency
sketch, its edge-block fold and the Nyström eigensolve.

The adjacency sketch is compared bitwise: 0/1 entries times ±1 or ±½
hash values make every partial sum an exact dyadic rational, so no
summation order can change a bit (``graph/stream.py``).  The eigensolve
is compared in f64 to 1e-6: |λ| and ``(X·sign λ) Xᵀ`` with ``X =
V·√|λ|``, which do not depend on the eigenvectors' arbitrary signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.graph import stream as jstream
from libskylark_tpu_torch.graph import stream as tstream
from libskylark_tpu_torch.utils.exceptions import InvalidParameters

pytestmark = pytest.mark.graph


def _edges(rng, n=64, m=400):
    return list(map(tuple, rng.integers(0, n, (m, 2)).tolist()))


def _graphs(edges):
    return J.graph.SimpleGraph(edges), T.graph.SimpleGraph(edges)


def _pair(stype, n, s, seed=1):
    Sj = J.sketch.create_sketch(stype, n, s, J.SketchContext(seed=seed))
    return Sj, T.sketch.from_json(Sj.to_json())


def test_simple_graph_matches_jax(rng):
    edges = _edges(rng) + [("a", "b"), ("b", "a"), ("c", "c"), (3, "a")]
    Gj, Gt = _graphs(edges)
    assert Gt.n == Gj.n and Gt.vertices == Gj.vertices
    np.testing.assert_array_equal(Gt.indptr, Gj.indptr)
    np.testing.assert_array_equal(Gt.indices, Gj.indices)
    assert Gt.volume == Gj.volume and Gt.degree(5) == Gj.degree(5)
    np.testing.assert_array_equal(Gt.neighbors(3), Gj.neighbors(3))
    np.testing.assert_array_equal(Gt.adjacency(), Gj.adjacency())
    A = Gt.adjacency_coo(torch.float64, device="cpu")
    np.testing.assert_array_equal(A.to_dense().numpy(), Gj.adjacency())
    extra = [(0, 1), (2, 5), (5, 2), (7, 7), (1, 0)]
    Gj2, new_j = Gj.with_edges(extra)
    Gt2, new_t = Gt.with_edges(extra)
    np.testing.assert_array_equal(new_t, new_j)
    np.testing.assert_array_equal(Gt2.indices, Gj2.indices)
    np.testing.assert_array_equal(Gt2.indptr, Gj2.indptr)
    with pytest.raises(KeyError):
        Gt.with_edges([("nope", 0)])


@pytest.mark.parametrize("stype", ["CWT", "SJLT"])
def test_incore_sketch_bitwise_equal_to_jax_f32(rng, stype):
    Gj, Gt = _graphs(_edges(rng))
    Sj, St = _pair(stype, Gt.n, 24)
    want = np.asarray(jstream.incore_adjacency_sketch(Gj, Sj, dtype=jnp.float32))
    got = tstream.incore_adjacency_sketch(Gt, St, dtype=torch.float32, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch_edges", [7, 64, 10_000])
def test_fold_equals_incore_bitwise(rng, batch_edges):
    _, Gt = _graphs(_edges(rng))
    _, St = _pair("SJLT", Gt.n, 24)
    init_at, step = tstream.adjacency_sketch_fold(St, Gt.n, torch.float32, device="cpu")
    acc = init_at(0)
    for i, block in enumerate(tstream.graph_block_source(Gt, batch_edges)()):
        acc = step(acc, block, i)
    assert int(acc["edge"]) == Gt.volume // 2
    want = tstream.incore_adjacency_sketch(Gt, St, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(acc["sa"].numpy(), want.numpy())


def test_fold_rejects_non_hash_sketch():
    with pytest.raises(InvalidParameters):
        tstream.adjacency_sketch_fold(T.sketch.FJLT(8, 4, T.SketchContext()), 8)
    with pytest.raises(InvalidParameters):
        tstream.incore_adjacency_sketch(torch.eye(4), T.sketch.CWT(4, 2, T.SketchContext()))


def test_ase_exact_on_complete_bipartite():
    """K_{10,14}: rank 2, eigenvalues ±√140, recovered exactly once s ≥ 2."""
    G = T.graph.SimpleGraph([(f"l{i}", f"r{j}") for i in range(10) for j in range(14)])
    S = T.sketch.SJLT(G.n, 8, T.SketchContext(seed=9))
    SA = tstream.incore_adjacency_sketch(G, S, dtype=torch.float64, device="cpu")
    V, lam = tstream.ase_from_sketch(SA, S, 2)
    lam = lam.numpy()
    np.testing.assert_allclose(np.sort(lam), [-np.sqrt(140), np.sqrt(140)], rtol=1e-10)
    X = V.numpy() * np.sqrt(np.abs(lam))[None, :]
    np.testing.assert_allclose((X * np.sign(lam)) @ X.T, G.adjacency(), atol=1e-6)


def test_ase_matches_jax_f64(rng):
    Gj, Gt = _graphs(_edges(rng, n=48, m=300))
    Sj, St = _pair("SJLT", Gt.n, 24, seed=3)
    SAj = jstream.incore_adjacency_sketch(Gj, Sj, dtype=jnp.float64)
    SAt = tstream.incore_adjacency_sketch(Gt, St, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(SAt.numpy(), np.asarray(SAj))
    Vj, lj = jstream.ase_from_sketch(SAj, Sj, 6)
    Vt, lt = tstream.ase_from_sketch(SAt, St, 6)
    lj, lt = np.asarray(lj), lt.numpy()
    np.testing.assert_allclose(np.abs(lt), np.abs(lj), rtol=1e-6)

    def recon(V, lam):
        X = np.asarray(V) * np.sqrt(np.abs(lam))[None, :]
        return (X * np.sign(lam)) @ X.T

    Rj, Rt = recon(Vj, lj), recon(Vt, lt)
    assert np.abs(Rt - Rj).max() <= 1e-6 * max(np.abs(Rj).max(), 1.0)
