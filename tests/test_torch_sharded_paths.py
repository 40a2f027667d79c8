"""Port vs JAX package: the two entry points that run the sharded
schedules, ``graph.chained_adjacency_sketch`` and
``linalg.streaming_approximate_svd(mesh=)``.

- ``chained_adjacency_sketch`` in core (the sparse-out schedule, then
  ``ShardedBCOO.sketch_columnwise``) is bitwise its streamed chain, on a
  mesh of one, of 4 slots and of 8 (2 x 4, flattened) CPU slots: an
  adjacency has 0/1 entries and CWT values are ±1, so every partial sum
  is an exact integer.  Both are bitwise the JAX package's streamed
  chain in f64 (whose in-core chain the JAX package's own test pins
  bitwise to it); its errors are the JAX package's.
- ``streaming_approximate_svd(mesh=)`` on a mesh of one is bitwise
  ``mesh=None``; on 8 CPU slots it holds the singular values to 1e-10
  relative and U·diag(s)·Vᵀ to 1e-9 of ``mesh=None`` and of the JAX call
  on an 8-device mesh (f64); in f32, 4 slots against ``mesh=None`` at
  the JAX multichip test's tolerances (σ to 1e-4 relative, |V₁ᵀV₂| to I
  at 1e-3).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.parallel as JP
import libskylark_tpu_torch as T
from libskylark_tpu import plans as jplans
import libskylark_tpu.plans.plan as jplan
from libskylark_tpu.graph import stream as jstream
from libskylark_tpu_torch import parallel as P
from libskylark_tpu_torch.graph import stream as tstream
from libskylark_tpu_torch.utils.exceptions import InvalidParameters


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)


def cpu_mesh(n):
    return P.make_mesh((n,), (P.ROWS,), devices="cpu") if n != 8 else \
        P.default_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(140)
    edges = set()
    while len(edges) < 300:
        a, b = (int(v) for v in rng.integers(0, 64, 2))
        if a != b:
            edges.add((min(a, b), max(a, b)))
    edges = sorted(edges)
    return J.graph.SimpleGraph(edges), T.graph.SimpleGraph(edges)


def chain_sketches(n):
    return (J.sketch.CWT(n, 16, J.SketchContext(seed=5)), J.sketch.CWT(16, 8, J.SketchContext(seed=5))), \
        (T.sketch.CWT(n, 16, T.SketchContext(seed=5)), T.sketch.CWT(16, 8, T.SketchContext(seed=5)))


@pytest.mark.parametrize("slots", [None, 1, 4, 8])
def test_chained_in_core_is_the_streamed_chain_bitwise(graphs, slots):
    Gj, Gt = graphs
    _, (S1, S2) = chain_sketches(Gt.n)
    mesh = None if slots is None else cpu_mesh(slots)
    for dtype in (torch.float32, torch.float64):
        incore = tstream.chained_adjacency_sketch(Gt, S1, S2, mesh=mesh, dtype=dtype,
                                                  device="cpu")
        streamed = tstream.chained_adjacency_sketch(Gt, S1, S2, streamed=True, batch_edges=23,
                                                    dtype=dtype, device="cpu")
        assert incore.dtype == dtype and incore.shape == (8, Gt.n)
        assert torch.equal(incore, streamed)


def test_chained_matches_jax_bitwise(graphs):
    Gj, Gt = graphs
    (S1j, S2j), (S1t, S2t) = chain_sketches(Gt.n)
    want = np.asarray(jstream.chained_adjacency_sketch(Gj, S1j, S2j, streamed=True,
                                                       batch_edges=23))
    for mesh in (None, cpu_mesh(8)):
        got = tstream.chained_adjacency_sketch(Gt, S1t, S2t, mesh=mesh, dtype=torch.float64,
                                               device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_chained_errors_are_jax_errors(graphs):
    Gj, Gt = graphs
    msgs = []
    for pkg, G in ((J, Gj), (T, Gt)):
        stream = jstream if pkg is J else tstream
        S1 = pkg.sketch.CWT(G.n, 8, pkg.SketchContext(seed=6))
        S2 = pkg.sketch.CWT(12, 4, pkg.SketchContext(seed=6))
        with pytest.raises(Exception, match="S2.n == S1.s") as e:
            stream.chained_adjacency_sketch(G, S1, S2)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]
    _, (S1, S2) = chain_sketches(Gt.n)
    with pytest.raises(InvalidParameters, match="needs a SimpleGraph"):
        tstream.chained_adjacency_sketch(Gt.adjacency_coo(device="cpu"), S1, S2, device="cpu")


M_ROWS, N_COLS, RANK, BLOCK = 512, 32, 6, 128


def svd_blocks(pkg, dtype, device=None):
    kw = {"device": device} if pkg is T else {}
    return pkg.linalg.synthetic_lowrank_blocks(pkg.SketchContext(seed=5), M_ROWS, N_COLS, 8,
                                               noise=0.01, dtype=dtype, **kw)


def port_svd(mesh, dtype):
    return T.linalg.streaming_approximate_svd(svd_blocks(T, dtype, "cpu"), (M_ROWS, N_COLS), RANK,
                                              T.SketchContext(seed=6), block_rows=BLOCK,
                                              materialize_u=True, mesh=mesh)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_streaming_svd_mesh_of_one_is_mesh_none_bitwise(dtype):
    none = port_svd(None, dtype)
    one = port_svd(cpu_mesh(1), dtype)
    assert all(torch.equal(a, b) for a, b in zip(none, one))


def test_streaming_svd_on_eight_slots_matches_mesh_none_and_jax():
    U, s, V = port_svd(cpu_mesh(8), torch.float64)
    U0, s0, V0 = port_svd(None, torch.float64)
    Uj, sj, Vj = J.linalg.streaming_approximate_svd(
        svd_blocks(J, jnp.float64), (M_ROWS, N_COLS), RANK, J.SketchContext(seed=6),
        block_rows=BLOCK, materialize_u=True, mesh=JP.make_mesh((8,), (JP.ROWS,)))
    rec = (U * s[None, :]) @ V.T
    for s_ref, rec_ref in (((s0, (U0 * s0[None, :]) @ V0.T)),
                           (sj, (np.asarray(Uj) * np.asarray(sj)[None, :]) @ np.asarray(Vj).T)):
        assert _rel(s, s_ref) <= 1e-10
        assert _rel(rec, rec_ref) <= 1e-9


def test_streaming_svd_f32_on_four_slots_at_the_multichip_tolerances():
    U, s, V = port_svd(cpu_mesh(4), torch.float32)
    _, s0, V0 = port_svd(None, torch.float32)
    assert _rel(s, s0) <= 1e-4
    overlap = (V.T @ V0).abs().double()
    assert torch.allclose(overlap, torch.eye(RANK, dtype=torch.float64), atol=1e-3)
    assert U.shape == (M_ROWS, RANK) and bool(torch.isfinite(U).all())
