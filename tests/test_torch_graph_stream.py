"""Port vs JAX package: the streamed adjacency sketch and the one-pass
streaming ASE (``graph/stream.py``) on the streaming engine.

Streamed ≡ in-core is bitwise, in both packages and across them: 0/1
adjacency entries times ±1 or ±½ hash values make every partial sum an
exact dyadic rational, so no block size or summation order changes a
bit.  The embedding is compared in f64 to 1e-6 on |λ| and on
``(X·sign λ)·Xᵀ``, which do not depend on the eigenvectors' signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libskylark_tpu import plans as jplans
import libskylark_tpu.plans.plan as jplan
import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu.graph import stream as jstream
from libskylark_tpu_torch.graph import stream as tstream
from libskylark_tpu_torch.resilient import FaultPlan, SimulatedPreemption
from libskylark_tpu_torch.streaming import StreamParams, pinned_placer
from libskylark_tpu_torch.utils.exceptions import InvalidParameters, UnsupportedError

pytestmark = pytest.mark.graph


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    # The JAX package's plans off (its plan path needs an API the installed
    # jax removed); the port keeps its default, planned path.
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    for knob in ("SKYLARK_GUARD", "SKYLARK_NO_OVERLAP", "SKYLARK_NO_FUSED_CHUNKS"):
        monkeypatch.delenv(knob, raising=False)


def cpu(**kw):
    return StreamParams(placer=pinned_placer("cpu"), **kw)


def _graphs(rng, n=64, m=400):
    edges = list(map(tuple, rng.integers(0, n, (m, 2)).tolist()))
    return J.graph.SimpleGraph(edges), T.graph.SimpleGraph(edges)


def _pair(stype, n, s, seed=1):
    Sj = J.sketch.create_sketch(stype, n, s, J.SketchContext(seed=seed))
    return Sj, T.sketch.from_json(Sj.to_json())


@pytest.mark.parametrize("batch_edges", [7, 64, 10_000])
@pytest.mark.parametrize("stype", ["CWT", "SJLT"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_streamed_equals_incore_bitwise(rng, stype, batch_edges, dtype):
    _, Gt = _graphs(rng)
    _, St = _pair(stype, Gt.n, 24)
    got = tstream.streamed_adjacency_sketch(tstream.graph_block_source(Gt, batch_edges), St,
                                            ncols=Gt.n, dtype=dtype, params=cpu())
    want = tstream.incore_adjacency_sketch(Gt, St, dtype=dtype, device="cpu")
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("stype", ["CWT", "SJLT"])
def test_streamed_equals_jax_streamed_bitwise(rng, stype):
    Gj, Gt = _graphs(rng)
    Sj, St = _pair(stype, Gt.n, 24)
    want = np.asarray(jstream.streamed_adjacency_sketch(
        jstream.graph_block_source(Gj, 50), Sj, ncols=Gj.n, dtype=np.float32))
    got = tstream.streamed_adjacency_sketch(tstream.graph_block_source(Gt, 50), St,
                                            ncols=Gt.n, dtype=torch.float32, params=cpu())
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefetch_overlap_and_fused_knobs_do_not_move_a_bit(rng):
    _, Gt = _graphs(rng)
    _, St = _pair("SJLT", Gt.n, 16)
    runs = [tstream.streamed_adjacency_sketch(tstream.graph_block_source(Gt, 33), St,
                                              ncols=Gt.n, dtype=torch.float32, params=cpu(**kw))
            for kw in ({}, {"prefetch": 0}, {"overlap": False}, {"checkpoint_every": 1})]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


def test_killed_and_resumed_fold_is_bitwise(rng, tmp_path):
    _, Gt = _graphs(rng)
    _, St = _pair("SJLT", Gt.n, 16)
    src = tstream.graph_block_source(Gt, 40)
    want = tstream.streamed_adjacency_sketch(src, St, ncols=Gt.n, dtype=torch.float32,
                                             params=cpu())
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedPreemption):
        tstream.streamed_adjacency_sketch(src, St, ncols=Gt.n, dtype=torch.float32,
                                          params=cpu(checkpoint_dir=ck, checkpoint_every=1),
                                          fault_plan=FaultPlan(preempt_after_chunk=2))
    got = tstream.streamed_adjacency_sketch(
        src, St, ncols=Gt.n, dtype=torch.float32,
        params=cpu(checkpoint_dir=ck, checkpoint_every=1, resume=True))
    assert torch.equal(got, want)


def test_streaming_ase_matches_jax(rng):
    # Two planted blocks: a graph of low effective rank.
    n = 60
    blocks = np.arange(n) // 30
    p = np.where(blocks[:, None] == blocks[None, :], 0.5, 0.05)
    upper = np.triu(rng.random((n, n)) < p, 1)
    edges = [tuple(e) for e in np.argwhere(upper).tolist()]
    Gj, Gt = J.graph.SimpleGraph(edges), T.graph.SimpleGraph(edges)
    k = 3
    Xj, lj = jstream.streaming_ase(jstream.graph_block_source(Gj, 64), Gj.n, k,
                                   J.SketchContext(seed=3))
    Xt, lt = tstream.streaming_ase(tstream.graph_block_source(Gt, 64), Gt.n, k,
                                   T.SketchContext(seed=3), stream_params=cpu())
    lj = np.asarray(lj)
    assert lt.dtype == torch.float64
    np.testing.assert_allclose(np.abs(lt.numpy()), np.abs(lj), rtol=1e-6)
    Xj = np.asarray(Xj)
    rec_j = (Xj * np.sign(lj)[None, :]) @ Xj.T
    rec_t = ((Xt * torch.sign(lt)[None, :]) @ Xt.T).numpy()
    assert np.abs(rec_t - rec_j).max() <= 1e-6 * np.abs(rec_j).max()
    # The in-core route on the same sketch gives the same eigenvalues.
    S = T.sketch.SJLT(Gt.n, 2 * k, T.SketchContext(seed=3))
    _, lam = tstream.ase_from_sketch(tstream.incore_adjacency_sketch(Gt, S, torch.float64,
                                                                     device="cpu"), S, k)
    assert torch.equal(lam, lt)


def test_streaming_ase_exact_on_a_low_rank_graph():
    # K_{10,14}: eigenvalues ±sqrt(140), rank 2 <= s.
    edges = [(i, 10 + j) for i in range(10) for j in range(14)]
    G = T.graph.SimpleGraph(edges)
    X, lam = tstream.streaming_ase(tstream.graph_block_source(G, 17), G.n, 2,
                                   T.SketchContext(seed=9), stream_params=cpu())
    np.testing.assert_allclose(np.sort(lam.numpy()), [-np.sqrt(140), np.sqrt(140)], rtol=1e-10)
    rec = (X * torch.sign(lam)[None, :]) @ X.T
    np.testing.assert_allclose(rec.numpy(), G.adjacency(), atol=1e-10)


def test_error_paths(rng):
    _, Gt = _graphs(rng)
    _, St = _pair("CWT", Gt.n, 8)
    # The elastic route is ported (tests/test_torch_elastic.py): a world of
    # 2 in one process, with no process group, is refused.
    with pytest.raises(InvalidParameters, match="live torch.distributed world"):
        tstream.streamed_adjacency_sketch([], St, ncols=Gt.n,
                                          partition=T.streaming.RowPartition(10, 5, 2))
    # The chained sketch is ported (tests/test_torch_sharded_paths.py): a
    # second sketch that does not take the first's rows is refused.
    with pytest.raises(InvalidParameters, match="S2.n == S1.s"):
        tstream.chained_adjacency_sketch(Gt, St, St)
    with pytest.raises(InvalidParameters, match="one-pass"):
        tstream.streaming_ase([], Gt.n, 2, T.SketchContext(),
                              T.linalg.SVDParams(num_iterations=1))
    with pytest.raises(InvalidParameters, match="hash sketch"):
        tstream.streamed_adjacency_sketch([], T.sketch.JLT(Gt.n, 8, T.SketchContext()),
                                          ncols=Gt.n, params=cpu())


def test_exports_match_jax():
    assert set(jstream.__all__) == set(tstream.__all__)
