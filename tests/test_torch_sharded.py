"""Port vs JAX package: the explicit sharded schedules
(``parallel/collectives.py``) and ``ShardedBCOO``.

Every schedule runs on the same inputs (made from a seed with numpy) in
both packages: the JAX package's on its 8 host devices (the 2 x 4
``default_mesh``), the port's on 8 CPU slots of the same shape.  The
public JAX schedules run ``shard_map`` eagerly (~20 s a call here), so
the JAX side runs each schedule's device program (``_*_program``, the
very program the public call runs) under ``jax.jit`` after the JAX
package's own host-side split (``_shard_coo_rows``,
``_validate_grid_2d``); the dense schedules take the public call under
``jax.jit``.  Tolerances are the JAX tests' (``tests/test_collectives.py``)
in f64: 1e-10 relative where no reduction crosses shards, rtol 1e-8 /
atol 1e-10 where a psum or an exchange reorders a sum; f32 cases at
1e-5 relative.

- A mesh of one is bitwise the unsharded apply, for every schedule.
- The sparse-out exchange keeps the JAX package's entries in the JAX
  package's buffer slots, so a capacity below
  ``suggest_sparse_out_capacity``'s drops the same entries in both.
- Every validation raises the JAX package's message.
- ``columnwise_batch_sharded``'s JAX ``shard_map`` passes ``check_rep``,
  which this jax removed, so it is held against the JAX unsharded
  columnwise apply (its contract: bitwise that apply).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse
from jax.sharding import Mesh as JMesh

import libskylark_tpu as J
import libskylark_tpu.parallel as JP
import libskylark_tpu.parallel.collectives as JC
import libskylark_tpu_torch as T
import libskylark_tpu_torch.sketch.dense as tdense
from libskylark_tpu_torch import parallel as P

SEED = 2110
CLASSES = {"CWT": ({}, {}), "SJLT": ({"nnz": 3}, {"nnz": 3}), "WZT": ({"p": 1.5}, {"p": 1.5}),
           "JLT": ({}, {})}


def sketches(name, n, s, seed):
    """The same sketch in both packages."""
    jkw, tkw = CLASSES[name]
    return (getattr(J.sketch, name)(n, s, J.SketchContext(seed=seed), **jkw),
            getattr(T.sketch, name)(n, s, T.SketchContext(seed=seed), **tkw))


def coo_pair(shape, density, seed, dtype=np.float64, rows_only=None):
    """One sparse matrix as a JAX BCOO and a torch COO, same entry order."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal(shape) * (rng.random(shape) < density)
    if rows_only is not None:
        M[rows_only:] = 0.0
    idx = np.argwhere(M != 0)
    data = M[idx[:, 0], idx[:, 1]].astype(dtype)
    A_j = jsparse.BCOO((jnp.asarray(data), jnp.asarray(idx.astype(np.int32))), shape=shape)
    return A_j, T.utils.coo_from_bcoo_arrays(data, idx, shape, device="cpu"), M


def dense(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.fixture(scope="module")
def meshes():
    return JP.default_mesh(), P.default_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def one():
    return P.make_mesh((1,), (P.ROWS,), devices="cpu")


def close(got, want, rtol, atol=0.0):
    """Elementwise as the JAX tests hold f64; f32 (``rtol`` 1e-5, no
    ``atol``) by the largest error over the largest |want|."""
    got = P.fully_replicated(got)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.dtype == np.float32:
        assert np.abs(got - want).max() <= rtol * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def flat(x):
    """A port :class:`Sharded` or a JAX array as one numpy array."""
    return P.fully_replicated(x).numpy() if isinstance(x, P.mesh.Sharded) else np.asarray(x)


# -- dense schedules -----------------------------------------------------------


@pytest.mark.parametrize("name", ["JLT", "CWT"])
def test_rowwise_sharded_matches_jax(meshes, name):
    jm, tm = meshes
    A = dense((64, 48), 1)
    Sj, St = sketches(name, 48, 16, 1)
    want = jax.jit(lambda a: JP.rowwise_sharded(Sj, a, jm))(JP.shard_rows(jnp.asarray(A), jm))
    got = P.rowwise_sharded(St, torch.from_numpy(A), tm)
    assert got.sharding == P.row_sharding(tm) and got.shape == (64, 16)
    close(got, want, 1e-10)


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-8, 1e-10), (np.float32, 1e-5, 0.0)])
def test_columnwise_sharded_matches_jax(meshes, scatter, dtype, rtol, atol):
    # atol 1e-10 relative to the largest entry, as a scale-free bound
    jm, tm = meshes
    A = dense((128, 24), 3, dtype)
    Sj, St = sketches("JLT", 128, 32, 3)
    want = jax.jit(lambda a: JP.columnwise_sharded(Sj, a, jm, scatter=scatter))(
        JP.shard_rows(jnp.asarray(A), jm))
    got = P.columnwise_sharded(St, torch.from_numpy(A), tm, scatter=scatter)
    assert isinstance(got, P.mesh.Sharded) == scatter
    close(got, want, rtol, atol * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("name", ["CWT", "JLT"])
def test_columnwise_batch_sharded_is_the_jax_apply(meshes, name):
    _, tm = meshes
    B = dense((128, 32), 2)
    Sj, St = sketches(name, 128, 16, 2)
    got = P.columnwise_batch_sharded(St, torch.from_numpy(B), tm)
    assert got.spec == (None, (P.ROWS, P.COLS)) and got.shape == (16, 32)
    close(got, Sj.apply(jnp.asarray(B), "columnwise"), 1e-10)
    # Each slot's block is bitwise the unsharded apply of those columns
    # (four columns take the row scatter, below the one-hot gate of 16,
    # where the whole batch of 32 takes the one-hot product).
    blocks = [St.apply(torch.from_numpy(B[:, 4 * k:4 * k + 4].copy())) for k in range(8)]
    assert all(torch.equal(a, b) for a, b in zip(got.shards, blocks))


def test_batch_sharded_program_runs_the_local_body_per_column_block(meshes):
    _, tm = meshes
    B = torch.from_numpy(dense((5, 16), 4))
    run = P.batch_sharded_program(lambda b, c: (b * 2, b + c), tm)
    twice, both = run(B, B)
    assert torch.equal(P.fully_replicated(twice), B * 2)
    assert torch.equal(P.fully_replicated(both), B + B)
    assert [t.shape for t in twice.shards] == [(5, 2)] * 8


# -- sparse schedules, dense output -----------------------------------------------


def jax_rows(Aj, mesh):
    p = mesh.size
    return JC._shard_coo_rows(Aj, p, Aj.shape[0] // p)


@pytest.mark.parametrize("name,scatter", [("CWT", False), ("SJLT", False), ("WZT", False),
                                          ("CWT", True)])
def test_columnwise_sharded_sparse_matches_jax(meshes, name, scatter):
    jm, tm = meshes
    Aj, At, _ = coo_pair((128, 24), 0.1, 5)
    Sj, St = sketches(name, 128, 16, 5)
    want = jax.jit(JC._columnwise_sparse_program(Sj, 24, 16, jm, scatter))(*jax_rows(Aj, jm))
    got = P.columnwise_sharded_sparse(St, At, tm, scatter=scatter)
    close(got, want, 1e-8, 1e-10)


def test_ragged_row_blocks_match_jax(meshes):
    # Every nonzero in the first row block: the other slots hold padding
    # alone, which must scatter nothing.
    jm, tm = meshes
    Aj, At, _ = coo_pair((64, 8), 1.0, 8, rows_only=8)
    Sj, St = sketches("CWT", 64, 8, 8)
    want = jax.jit(JC._columnwise_sparse_program(Sj, 8, 8, jm, False))(*jax_rows(Aj, jm))
    close(P.columnwise_sharded_sparse(St, At, tm), want, 1e-8, 1e-10)


def test_rowwise_sharded_sparse_matches_jax(meshes):
    jm, tm = meshes
    Aj, At, _ = coo_pair((64, 96), 0.1, 7)
    Sj, St = sketches("CWT", 96, 12, 7)
    want = jax.jit(JC._rowwise_sparse_program(Sj, 8, jm))(*jax_rows(Aj, jm))
    got = P.rowwise_sharded_sparse(St, At, tm)
    assert got.sharding == P.row_sharding(tm)
    close(got, want, 1e-10)


def test_columnwise_sharded_sparse_2d_matches_jax():
    jm = JP.make_mesh((4, 2), ("r", "c"))
    tm = P.make_mesh((4, 2), ("r", "c"), devices="cpu")
    Aj, At, _ = coo_pair((32, 10), 0.35, 61)
    Sj, St = sketches("SJLT", 32, 16, 61)
    _, _, rb, cb, d, lr, lc = JC._validate_grid_2d(Sj, Aj, jm, "x")
    want = jax.jit(JC._columnwise_sparse_2d_program(Sj, rb, cb, jm))(d, lr, lc)
    got = P.columnwise_sharded_sparse_2d(St, At, tm)
    assert got.spec == (None, "c")
    close(got, want, 1e-8, 1e-10)


# -- sparse output ----------------------------------------------------------------


def jax_sparse_out(Sj, Aj, mesh, capacity=None):
    """``columnwise_sharded_sparse_out`` with its device program jitted."""
    p = mesh.size
    n, m = Aj.shape
    d, lr, cc = jax_rows(Aj, mesh)
    cap = Sj.nnz * d.shape[1] if capacity is None else capacity
    dv, rv, cv = jax.jit(JC._columnwise_sparse_out_program(Sj, n // p, Sj.s // p, cap, mesh))(
        d, lr, cc)
    return JC.ShardedBCOO(dv, rv, cv, (Sj.s, m), Sj.s // p, mesh)


def same_entries(got, want, data_rtol=0.0):
    """The port's per-slot entry arrays are the JAX package's, slot by slot."""
    for mine, theirs in ((got.rows, want.rows), (got.cols, want.cols)):
        np.testing.assert_array_equal(flat(mine), np.asarray(theirs))
    np.testing.assert_allclose(flat(got.data), np.asarray(want.data), rtol=data_rtol, atol=0)


@pytest.mark.parametrize("name,dtype", [("CWT", np.float64), ("SJLT", np.float64),
                                        ("WZT", np.float64), ("CWT", np.float32),
                                        ("SJLT", np.float32)])
def test_columnwise_sharded_sparse_out_matches_jax(meshes, name, dtype):
    jm, tm = meshes
    Aj, At, _ = coo_pair((64, 12), 0.3, 41, dtype)
    Sj, St = sketches(name, 64, 40, 41)
    want = jax_sparse_out(Sj, Aj, jm)
    got = P.columnwise_sharded_sparse_out(St, At, tm)
    assert got.data.shape == tuple(want.data.shape) and got.row_block == want.row_block
    f32 = dtype == np.float32
    same_entries(got, want, 1e-6 if f32 else 1e-15)
    bc = got.to_bcoo()
    assert bc.is_coalesced() and bc._nnz() <= Sj.nnz * Aj.nse
    close(got.todense(), want.todense(), 1e-5 if f32 else 1e-8, 0.0 if f32 else 1e-10)


@pytest.mark.parametrize("less", [1, "half"])
def test_too_small_capacity_drops_the_jax_entries(meshes, less):
    jm, tm = meshes
    Aj, At, M = coo_pair((64, 12), 0.5, 42)
    Sj, St = sketches("CWT", 64, 16, 42)
    flat_j = JMesh(np.array(jax.devices()), (JP.ROWS,))
    need = P.suggest_sparse_out_capacity(St, At, P.make_mesh((8,), (P.ROWS,), devices="cpu"))
    assert need == JP.suggest_sparse_out_capacity(Sj, Aj, flat_j)
    full = P.columnwise_sharded_sparse_out(St, At, tm, capacity=need)
    assert torch.equal(full.todense(), P.columnwise_sharded_sparse_out(St, At, tm).todense())
    cap = need - 1 if less == 1 else max(1, need // 2)
    got = P.columnwise_sharded_sparse_out(St, At, tm, capacity=cap)
    want = jax_sparse_out(Sj, Aj, jm, capacity=cap)
    same_entries(got, want)  # the same entries kept, in the same buffer slots
    kept = int((flat(got.data) != 0).sum())
    assert 0 < kept < np.count_nonzero(M)  # some real entries are gone, silently
    close(got.todense(), want.todense(), 1e-8, 1e-10)  # duplicates summed in another order


def test_columnwise_sharded_sparse_out_2d_matches_jax():
    jm = JP.make_mesh((4, 2), ("r", "c"))
    tm = P.make_mesh((4, 2), ("r", "c"), devices="cpu")
    Aj, At, _ = coo_pair((32, 10), 0.35, 62)
    Sj, St = sketches("SJLT", 32, 16, 62)
    _, _, rb, cb, d, lr, lc = JC._validate_grid_2d(Sj, Aj, jm, "x")
    cap = Sj.nnz * d.shape[2]
    dv, rv, cv = jax.jit(JC._columnwise_sparse_out_2d_program(Sj, rb, 4, cap, jm))(d, lr, lc)
    want = JC.ShardedBCOO(dv, rv, cv, (16, 10), 4, jm, col_block=cb)
    got = P.columnwise_sharded_sparse_out_2d(St, At, tm)
    assert got.col_block == want.col_block == 5 and got.data.shape == tuple(dv.shape)
    same_entries(got, want, 1e-15)
    close(got.todense(), want.todense(), 1e-8, 1e-10)


def test_rowwise_sharded_sparse_out_matches_jax(meshes):
    jm, tm = meshes
    Aj, At, _ = coo_pair((64, 96), 0.25, 44)
    Sj, St = sketches("SJLT", 96, 24, 44)
    dv, rv, cv = jax.jit(JC._rowwise_sparse_out_program(Sj, jm))(*jax_rows(Aj, jm))
    want = JC.ShardedBCOO(dv, rv, cv, (64, 24), 8, jm)
    got = P.rowwise_sharded_sparse_out(St, At, tm)
    same_entries(got, want, 1e-15)
    close(got.todense(), want.todense(), 1e-10)


@pytest.mark.parametrize("dense_output", [True, False])
def test_chain_matches_jax(meshes, dense_output):
    jm, tm = meshes
    Aj, At, _ = coo_pair((64, 10), 0.3, 71)
    S1j, S1t = sketches("CWT", 64, 40, 71)
    S2j, S2t = sketches("SJLT", 40, 16, 72)
    mid_j = jax_sparse_out(S1j, Aj, jm)
    mid_t = P.columnwise_sharded_sparse_out(S1t, At, tm)
    args = (mid_j.data, mid_j.rows, mid_j.cols)
    if dense_output:
        want = jax.jit(JC._columnwise_sparse_program(S2j, 10, 5, jm, False))(*args)
        close(mid_t.sketch_columnwise(S2t), want, 1e-8, 1e-10)
    else:
        cap = S2j.nnz * mid_j.data.shape[1]
        dv, rv, cv = jax.jit(JC._columnwise_sparse_out_program(S2j, 5, 2, cap, jm))(*args)
        want = JC.ShardedBCOO(dv, rv, cv, (16, 10), 2, jm)
        got = mid_t.sketch_columnwise(S2t, dense_output=False)
        same_entries(got, want, 1e-15)
        close(got.todense(), want.todense(), 1e-8, 1e-10)
    ref = S2t.apply(S1t.apply(At).to_dense())  # the local chain
    close(mid_t.sketch_columnwise(S2t), ref.numpy(), 1e-8, 1e-10)


def test_empty_matrix_is_the_zero_sketch(meshes):
    _, tm = meshes
    A = torch.sparse_coo_tensor(torch.zeros((2, 0), dtype=torch.long),
                                torch.zeros(0, dtype=torch.float32), (32, 4),
                                check_invariants=True)
    out = P.columnwise_sharded_sparse_out(T.sketch.CWT(32, 16, T.SketchContext(seed=48)), A, tm)
    assert torch.equal(out.todense(), torch.zeros(16, 4))
    assert out.to_bcoo()._nnz() == 0


# -- a mesh of one is the unsharded apply, bitwise --------------------------------


@pytest.mark.parametrize("name", ["JLT", "CWT", "FJLT"])
def test_mesh_of_one_rowwise_and_batch_are_the_apply(one, name):
    St = T.sketch.create_sketch(name, 64, 16, T.SketchContext(seed=9))
    A = torch.from_numpy(dense((40, 64), 9, np.float32))
    assert torch.equal(P.fully_replicated(P.rowwise_sharded(St, A, one)), St.apply(A, "rowwise"))
    B = A.T.contiguous()
    assert torch.equal(P.fully_replicated(P.columnwise_batch_sharded(St, B, one)), St.apply(B))


@pytest.mark.parametrize("panels", [False, True])
def test_mesh_of_one_columnwise_is_the_apply(one, monkeypatch, panels):
    if panels:  # the dense apply's panel loop: the window product follows it
        monkeypatch.setattr(tdense, "MAX_REALIZE_ELEMENTS", 16 * 10)
    St = T.sketch.JLT(128, 16, T.SketchContext(seed=10))
    A = torch.from_numpy(dense((128, 6), 10, np.float32))
    assert torch.equal(P.columnwise_sharded(St, A, one), St.apply(A))
    assert torch.equal(P.fully_replicated(P.columnwise_sharded(St, A, one, scatter=True)),
                       St.apply(A))


@pytest.mark.parametrize("name", ["CWT", "SJLT"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mesh_of_one_sparse_schedules_are_the_apply(one, name, dtype):
    _, At, _ = coo_pair((64, 12), 0.3, 11, dtype)
    _, St = sketches(name, 64, 16, 11)
    ref = St.apply(At, "columnwise", dense_output=True)
    assert torch.equal(P.columnwise_sharded_sparse(St, At, one), ref)
    assert torch.equal(P.columnwise_sharded_sparse_out(St, At, one).todense(),
                       St.apply(At, "columnwise").to_dense())
    grid = P.make_mesh((1, 1), ("r", "c"), devices="cpu")
    assert torch.equal(P.fully_replicated(P.columnwise_sharded_sparse_2d(St, At, grid)), ref)
    assert torch.equal(P.columnwise_sharded_sparse_out_2d(St, At, grid).todense(),
                       St.apply(At, "columnwise").to_dense())
    _, Ar, _ = coo_pair((12, 64), 0.3, 12, dtype)
    assert torch.equal(P.fully_replicated(P.rowwise_sharded_sparse(St, Ar, one)),
                       St.apply(Ar, "rowwise", dense_output=True))
    assert torch.equal(P.rowwise_sharded_sparse_out(St, Ar, one).todense(),
                       St.apply(Ar, "rowwise").to_dense())


def test_sharded_input_is_used_as_it_lies(meshes):
    _, tm = meshes
    St = T.sketch.JLT(48, 16, T.SketchContext(seed=13))
    A = torch.from_numpy(dense((64, 48), 13))
    rows = P.shard_rows(A, tm)
    out = P.rowwise_sharded(St, rows, tm)
    assert torch.equal(P.fully_replicated(out), P.fully_replicated(P.rowwise_sharded(St, A, tm)))
    cols = P.shard_cols(A, tm)  # another spec: resharded by rows first
    assert torch.equal(P.fully_replicated(P.rowwise_sharded(St, cols, tm)),
                       P.fully_replicated(out))


# -- validation: the JAX package's messages ----------------------------------------


def raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", [
    "sparse_wrong_n", "sparse_rows", "sparse_scatter", "dense_rows", "dense_scatter",
    "batch_cols", "out_s", "out_wrong_n", "rowwise_n", "rowwise_rows", "grid_axes",
    "grid_shape", "grid_out_s", "suggest_2d", "chain_n", "chain_s", "chain_2d", "n32",
])
def test_validation_raises_the_jax_message(meshes, case):
    jm, tm = meshes
    jg, tg = JP.make_mesh((4, 2), ("r", "c")), P.make_mesh((4, 2), ("r", "c"), devices="cpu")
    Aj, At, _ = coo_pair((60, 8), 0.3, 20)
    A2j, A2t, _ = coo_pair((64, 8), 0.3, 21)
    Gj, Gt = coo_pair((32, 9), 0.3, 22)[:2]
    pair = {
        "sparse_wrong_n": (lambda S: (JP.columnwise_sharded_sparse, S[0], Aj, jm),
                           lambda S: (P.columnwise_sharded_sparse, S[1], At, tm), ("CWT", 64, 8)),
        "sparse_rows": (lambda S: (JP.columnwise_sharded_sparse, S[0], Aj, jm),
                        lambda S: (P.columnwise_sharded_sparse, S[1], At, tm), ("CWT", 60, 8)),
        "sparse_scatter": (lambda S: (JP.columnwise_sharded_sparse, S[0], A2j, jm, True),
                           lambda S: (P.columnwise_sharded_sparse, S[1], A2t, tm, True),
                           ("CWT", 64, 12)),
        "out_s": (lambda S: (JP.columnwise_sharded_sparse_out, S[0], A2j, jm),
                  lambda S: (P.columnwise_sharded_sparse_out, S[1], A2t, tm), ("CWT", 64, 12)),
        "out_wrong_n": (lambda S: (JP.columnwise_sharded_sparse_out, S[0], A2j, jm),
                        lambda S: (P.columnwise_sharded_sparse_out, S[1], A2t, tm),
                        ("CWT", 32, 8)),
        "rowwise_n": (lambda S: (JP.rowwise_sharded_sparse, S[0], A2j, jm),
                      lambda S: (P.rowwise_sharded_sparse, S[1], A2t, tm), ("CWT", 9, 4)),
        "rowwise_rows": (lambda S: (JP.rowwise_sharded_sparse_out, S[0], Aj, jm),
                         lambda S: (P.rowwise_sharded_sparse_out, S[1], At, tm), ("CWT", 8, 4)),
        "grid_axes": (lambda S: (JP.columnwise_sharded_sparse_2d, S[0], A2j,
                                 JMesh(np.array(jax.devices()), ("r",))),
                      lambda S: (P.columnwise_sharded_sparse_2d, S[1], A2t,
                                 P.make_mesh((8,), ("r",), devices="cpu")), ("CWT", 64, 8)),
        "grid_shape": (lambda S: (JP.columnwise_sharded_sparse_out_2d, S[0], Gj, jg),
                       lambda S: (P.columnwise_sharded_sparse_out_2d, S[1], Gt, tg),
                       ("CWT", 32, 8)),
        "grid_out_s": (lambda S: (JP.columnwise_sharded_sparse_out_2d, S[0], A2j, jg),
                       lambda S: (P.columnwise_sharded_sparse_out_2d, S[1], A2t, tg),
                       ("CWT", 64, 6)),
        "suggest_2d": (lambda S: (JP.suggest_sparse_out_capacity, S[0], A2j, jm),
                       lambda S: (P.suggest_sparse_out_capacity, S[1], A2t, tm),
                       ("CWT", 64, 8)),
        "n32": (lambda S: (JP.columnwise_sharded_sparse_out, S[0], big_j, jm),
                lambda S: (P.columnwise_sharded_sparse_out, S[1], big_t, tm),
                ("CWT", 1 << 32, 8)),
    }
    if case in ("dense_rows", "dense_scatter", "batch_cols"):
        Sj, St = sketches("JLT", 60 if case == "dense_rows" else 64, 12, 23)
        X = dense((60 if case == "dense_rows" else 64, 12), 23)
        if case == "batch_cols":
            X = X[:, :10]
            msgs = [raised(lambda: f(S, x, m)) for f, S, x, m in (
                (JP.columnwise_batch_sharded, Sj, jnp.asarray(X), jm),
                (P.columnwise_batch_sharded, St, torch.from_numpy(X), tm))]
        else:
            sc = case == "dense_scatter"
            msgs = [raised(lambda: f(S, x, m, scatter=sc)) for f, S, x, m in (
                (JP.columnwise_sharded, Sj, jnp.asarray(X), jm),
                (P.columnwise_sharded, St, torch.from_numpy(X), tm))]
    elif case.startswith("chain"):
        S1j, S1t = sketches("CWT", 64, 16, 24)
        if case == "chain_2d":
            mids = (JC.ShardedBCOO(None, None, None, (16, 8), 4, jg, col_block=4),
                    P.collectives.ShardedBCOO(None, None, None, (16, 8), 4, tg, col_block=4))
        else:
            mids = (jax_sparse_out(S1j, A2j, jm), P.columnwise_sharded_sparse_out(S1t, A2t, tm))
        S2 = sketches("CWT", 12 if case == "chain_n" else 16, 12, 25)
        msgs = [raised(lambda: mid.sketch_columnwise(s2, dense_output=False))
                for mid, s2 in zip(mids, S2)]
    else:
        if case == "n32":
            n = 1 << 32
            big_j = jsparse.BCOO((jnp.zeros(1), jnp.zeros((1, 2), jnp.int32)), shape=(n, 8))
            big_t = torch.sparse_coo_tensor(torch.zeros((2, 1), dtype=torch.long),
                                            torch.zeros(1), (n, 8))
        make_j, make_t, (name, n, s) = pair[case]
        S = sketches(name, n, s, 26)
        msgs = [raised(lambda: c[0](*c[1:])) for c in (make_j(S), make_t(S))]
    assert msgs[0] == msgs[1]


def test_sparse_schedules_take_a_coo(meshes):
    _, tm = meshes
    with pytest.raises(TypeError, match="sparse COO"):
        P.columnwise_sharded_sparse(T.sketch.CWT(64, 8, T.SketchContext(seed=1)),
                                    torch.zeros(64, 4), tm)
