"""Port vs JAX package: the sketches' slice protocol (``sketch/base.py``,
``hash.py``, ``dense.py``, ``rft.py``), the streaming engine's bitwise
pins, the pipeline (``streaming/``) and the error paths.  The drivers
are held in ``test_torch_streaming_drivers.py`` and the streaming
solvers in ``test_torch_streaming_solvers.py``, with this file's
helpers and fixtures.

Same seeded numpy inputs to both packages.  The JAX side runs with
``SKYLARK_NO_PLANS=1 SKYLARK_POLICY=0`` (the port has no plans or
policy; plans are bitwise eager by contract); where the installed jax
keeps ``trace_state_clean`` only in ``jax._src.core``, the fixture puts
it back in ``jax.core``, where the JAX package looks for it.  Tolerances, relative to
the largest magnitude: f64 1e-12 (the slices; 1e-10 for the solves), f32
1e-5; hash buckets bitwise.  The port's own pins are bitwise: fused ≡
unfused, overlap on ≡ off, prefetch 0 ≡ 2, killed-and-resumed ≡
uninterrupted, a guard replay ≡ the clean pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import streaming as jst
from libskylark_tpu_torch import streaming as tst
from libskylark_tpu_torch.resilient import FaultPlan, SimulatedPreemption
from libskylark_tpu_torch.streaming import StreamParams, pinned_placer
from libskylark_tpu_torch.utils.exceptions import UnsupportedError

N, M, S_OUT = 40, 5, 12
BATCH = 7  # does not divide N: the last block is ragged
KINDS = ["CWT", "MMT", "WZT", "SJLT", "JLT", "CT", "GaussianRFT"]
HASH = ["CWT", "MMT", "WZT", "SJLT"]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def jax_plain(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    monkeypatch.setenv("SKYLARK_NO_PLANS", "1")
    for knob in ("SKYLARK_GUARD", "SKYLARK_GUARD_MAX_RETRIES", "SKYLARK_GUARD_COND_MAX",
                 "SKYLARK_NO_OVERLAP", "SKYLARK_NO_FUSED_CHUNKS"):
        monkeypatch.delenv(knob, raising=False)
    if not hasattr(jax.core, "trace_state_clean"):  # newer jax keeps it in jax._src.core
        from jax._src import core as jax_core

        monkeypatch.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                            raising=False)


@pytest.fixture
def f64_default():
    """torch's default float at f64 for the entry points that take no
    dtype, as the JAX side's x64 mode makes its default f64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def cpu(**kw):
    """StreamParams that keep the pass on the CPU."""
    return StreamParams(placer=pinned_placer("cpu"), **kw)


def _pair(kind, n=N, s=S_OUT, seed=5):
    kw = {"nnz": 4} if kind == "SJLT" else {"sigma": 1.3} if kind == "GaussianRFT" else {}
    Sj = J.sketch.create_sketch(kind, n, s, J.SketchContext(seed=seed), **kw)
    return Sj, T.sketch.from_json(Sj.to_json())


def _rel(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


def blocks_of(*arrays, batch=BATCH):
    out = []
    for lo in range(0, arrays[0].shape[0], batch):
        sl = tuple(a[lo:lo + batch] for a in arrays)
        out.append(sl[0] if len(arrays) == 1 else sl)
    return out


def factory_of(*arrays, batch=BATCH):
    blocks = blocks_of(*arrays, batch=batch)
    return lambda start: iter(blocks[start:])


def _coo(dense):
    idx = np.argwhere(dense != 0)
    vals = dense[dense != 0]
    return (jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=dense.shape),
            T.utils.coo_from_bcoo_arrays(vals, idx, dense.shape, device="cpu"))


# ---------------------------------------------------------------------------
# The slice protocol


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", KINDS)
def test_slices_match_jax_dense(rng, kind, dtype):
    Sj, St = _pair(kind)
    A = rng.standard_normal((N, M)).astype(dtype)
    start, k = 9, 17
    blk = A[start:start + k]
    want = np.asarray(Sj.apply_slice(jnp.asarray(blk), start))
    got = St.apply_slice(torch.from_numpy(blk), start)
    assert _rel(got, want) <= TOL[dtype]
    want_k = np.asarray(Sj.apply_slice_kernel(jnp.asarray(blk), start))
    assert _rel(St.apply_slice_kernel(torch.from_numpy(blk), start), want_k) <= TOL[dtype]
    acc = rng.standard_normal((S_OUT, M)).astype(dtype)
    want_a = np.asarray(Sj.apply_slice_kernel_acc(jnp.asarray(acc), jnp.asarray(blk), start))
    got_a = St.apply_slice_kernel_acc(torch.from_numpy(acc), torch.from_numpy(blk), start)
    assert _rel(got_a, want_a) <= TOL[dtype]
    # 1-D blocks are columns.
    vec = A[start:start + k, 0]
    assert _rel(St.apply_slice(torch.from_numpy(vec), start),
                np.asarray(Sj.apply_slice(jnp.asarray(vec), start))) <= TOL[dtype]
    # Rowwise slices are whole applies of the block.
    rows = rng.standard_normal((3, N)).astype(dtype)
    assert _rel(St.apply_slice(torch.from_numpy(rows), 0, "rowwise"),
                np.asarray(Sj.apply_slice(jnp.asarray(rows), 0, "rowwise"))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", KINDS)
def test_slices_match_jax_coo(rng, kind, dtype):
    Sj, St = _pair(kind)
    blk = rng.standard_normal((17, M)).astype(dtype)
    blk[rng.random(blk.shape) < 0.6] = 0.0
    jb, tb = _coo(blk)
    want = np.asarray(Sj.apply_slice(jb, 9))
    got = St.apply_slice(tb, 9)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(got, St.apply_slice(torch.from_numpy(blk), 9)) <= TOL[dtype]


@pytest.mark.parametrize("kind", HASH)
def test_slice_buckets_bitwise(kind):
    Sj, St = _pair(kind)
    for h in range(Sj.nnz):
        start = h * N + 9
        assert np.array_equal(St.buckets(start, 17, device="cpu").numpy(),
                              np.asarray(Sj.buckets(start, 17)))
        assert np.array_equal(St.buckets(torch.tensor(start), 17).numpy(),
                              np.asarray(Sj.buckets(start, 17)))


@pytest.mark.parametrize("kind", KINDS)
def test_slice_window_past_domain_is_zeroed(rng, kind):
    """A block running past N, zero-padded, contributes exactly its
    in-domain rows (the JAX package's padded-bucket contract), for a host
    start and a 0-d tensor start alike."""
    Sj, St = _pair(kind)
    start, k, pad = 30, 10, 6
    blk = np.zeros((k + pad, M), np.float32)
    blk[:k] = rng.standard_normal((k, M))
    want = St.apply_slice(torch.from_numpy(blk[:k]), start)
    for st in (start, torch.tensor(start)):
        got = St.apply_slice_kernel(torch.from_numpy(blk), st)
        assert torch.isfinite(got).all()
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    jgot = np.asarray(Sj.apply_slice_kernel(jnp.asarray(blk), start))
    assert _rel(want, jgot) <= 1e-5
    with pytest.raises(ValueError, match="outside the sketch domain"):
        St.apply_slice(torch.from_numpy(blk), start)


def test_unsupported_slice_says_so():
    St = T.sketch.FJLT(N, S_OUT, T.SketchContext(seed=1))
    with pytest.raises(UnsupportedError, match="no columnwise partial-sketch rule"):
        St.apply_slice(torch.zeros(4, 2), 0)
    with pytest.raises(UnsupportedError):
        St.apply_slice_kernel(torch.zeros(4, 2), 0)
    assert not St.supports_slice_kernel and T.sketch.CWT.supports_slice_kernel


@pytest.mark.parametrize("kind", HASH)
def test_memoized_hash_windows_are_the_drawn_ones(rng, kind, monkeypatch):
    _, St = _pair(kind)
    blk = torch.from_numpy(rng.standard_normal((BATCH, M)).astype(np.float32))
    memo = [St.apply_slice_kernel(blk, st) for st in (0, 14, 33)]
    assert St._slice_memo
    monkeypatch.setattr(type(St), "_SLICE_MEMO_LIMIT", 0)
    _, fresh = _pair(kind)
    drawn = [fresh.apply_slice_kernel(blk, st) for st in (0, 14, 33)]
    assert not fresh.__dict__.get("_slice_memo")
    if kind == "WZT":
        # WZT's values go through pow and log, whose CPU kernels round an
        # element by where it falls in the array (vector body or tail):
        # a window and the whole array may differ by an ulp.
        assert all(_rel(a, b) <= 1e-6 for a, b in zip(memo, drawn))
    else:
        assert all(torch.equal(a, b) for a, b in zip(memo, drawn))


@pytest.mark.parametrize("kind", HASH)
def test_finalize_slices_drops_the_hash_memo(rng, kind):
    _, St = _pair(kind)
    blk = torch.from_numpy(rng.standard_normal((BATCH, M)).astype(np.float32))
    acc = St.apply_slice_kernel(blk, 7)
    assert St._slice_memo
    assert St.finalize_slices(acc) is acc and not St.__dict__.get("_slice_memo")
    # A streamed pass ends in finalize_slices: no memo outlives it.
    A = rng.standard_normal((N, M)).astype(np.float32)
    tst.sketch([A[i:i + BATCH] for i in range(0, N, BATCH)], St, ncols=M, params=cpu())
    assert not St.__dict__.get("_slice_memo")


@pytest.mark.parametrize("kind", KINDS)
def test_fused_chunk_step_is_bitwise_the_composite(rng, kind):
    _, St = _pair(kind)
    for dtype in (torch.float32, torch.float64):
        blk = torch.from_numpy(rng.standard_normal((BATCH, M))).to(dtype)
        acc = torch.from_numpy(rng.standard_normal((S_OUT, M))).to(dtype)
        fused = St.apply_slice_kernel_acc(acc, blk, 14)
        assert torch.equal(fused, acc + St.apply_slice_kernel(blk, 14).to(dtype))


@pytest.mark.parametrize("kind", KINDS)
def test_hoisted_operands_bitwise_apply(rng, kind):
    _, St = _pair(kind, s=24)
    X = torch.from_numpy(rng.standard_normal((20, N)).astype(np.float32))
    ops = St.hoistable_operands(torch.float32, "cpu")
    assert ops is None or ops is St.hoistable_operands(torch.float32, "cpu")
    assert torch.equal(St.apply_with_operands(ops, X, "rowwise"), St.apply(X, "rowwise"))


# ---------------------------------------------------------------------------
# The port's bitwise pins


def _run(kind, A, **kw):
    _, St = _pair(kind)
    return tst.sketch(factory_of(torch.from_numpy(A)), St, "columnwise", ncols=M,
                      dtype=torch.float32, params=cpu(**kw))


@pytest.mark.parametrize("kind", KINDS)
def test_fused_equals_unfused_and_overlap_equals_serial(rng, kind, monkeypatch):
    A = rng.standard_normal((N, M)).astype(np.float32)
    ref = _run(kind, A)
    assert torch.equal(ref, _run(kind, A, fused_chunks=False))
    assert torch.equal(ref, _run(kind, A, overlap=False))
    assert torch.equal(ref, _run(kind, A, prefetch=0))
    assert torch.equal(ref, _run(kind, A, prefetch=2, checkpoint_every=3))
    monkeypatch.setenv("SKYLARK_NO_FUSED_CHUNKS", "1")
    monkeypatch.setenv("SKYLARK_NO_OVERLAP", "1")
    assert torch.equal(ref, _run(kind, A))


def test_knobs_resolve_as_in_jax(monkeypatch):
    from libskylark_tpu_torch.streaming import engine, overlap

    assert engine.fused_enabled() and overlap.enabled() and not overlap.enabled(False)
    monkeypatch.setenv("SKYLARK_NO_OVERLAP", "1")
    assert not overlap.enabled(True)
    monkeypatch.setenv("SKYLARK_NO_FUSED_CHUNKS", "1")
    assert not engine.fused_enabled()


@pytest.mark.parametrize("kind", ["JLT", "CWT", "GaussianRFT"])
def test_killed_and_resumed_pass_is_bitwise(rng, tmp_path, kind):
    _, St = _pair(kind)
    A = torch.from_numpy(rng.standard_normal((N, M)))
    want = tst.sketch(factory_of(A), St, "columnwise", ncols=M, dtype=torch.float64,
                      params=cpu())
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedPreemption):
        tst.sketch(factory_of(A), St, "columnwise", ncols=M, dtype=torch.float64,
                   params=cpu(checkpoint_dir=ck, checkpoint_every=2),
                   fault_plan=FaultPlan(preempt_after_chunk=1))
    got = tst.sketch(factory_of(A), St, "columnwise", ncols=M, dtype=torch.float64,
                     params=cpu(checkpoint_dir=ck, checkpoint_every=2, resume=True))
    assert torch.equal(got, want)


def test_least_squares_killed_and_resumed_is_bitwise(rng, tmp_path):
    n, d = 60, 4
    A = torch.from_numpy(rng.standard_normal((n, d)))
    b = torch.from_numpy(rng.standard_normal(n))
    p = T.linalg.LeastSquaresParams(sketch_type="CWT", sketch_size=16)
    ctx = lambda: T.SketchContext(seed=11)  # noqa: E731 — contexts are stateful
    x_ref, _ = T.linalg.streaming_least_squares(factory_of(A, b), n, d, ctx(), p,
                                                stream_params=cpu())
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedPreemption):
        T.linalg.streaming_least_squares(factory_of(A, b), n, d, ctx(), p,
                                         stream_params=cpu(checkpoint_dir=ck,
                                                           checkpoint_every=2),
                                         fault_plan=FaultPlan(preempt_after_chunk=2))
    x, info = T.linalg.streaming_least_squares(
        factory_of(A, b), n, d, ctx(), p,
        stream_params=cpu(checkpoint_dir=ck, checkpoint_every=2, resume=True))
    assert torch.equal(x, x_ref) and info["rows"] == n


@pytest.mark.parametrize("fault", ["nan_at", "bad_sketch_at"])
def test_guard_replays_a_poisoned_batch_bitwise(rng, fault):
    n, d = 60, 4
    A = torch.from_numpy(rng.standard_normal((n, d)))
    b = torch.from_numpy(rng.standard_normal(n))
    p = T.linalg.LeastSquaresParams(sketch_type="CWT", sketch_size=16)
    x_ref, _ = T.linalg.streaming_least_squares(factory_of(A, b), n, d,
                                                T.SketchContext(seed=3), p, stream_params=cpu())
    x, info = T.linalg.streaming_least_squares(
        factory_of(A, b), n, d, T.SketchContext(seed=3), p, stream_params=cpu(),
        fault_plan=FaultPlan(**{fault: 4}))
    assert torch.equal(x, x_ref)
    assert info["recovery"]["recovered"] and info["recovery"]["attempts"][0]["action"] == "replay"


# ---------------------------------------------------------------------------
# The pipeline and the error paths


def test_prefetcher_order_stats_and_exhaustion():
    with tst.Prefetcher(iter(range(6)), depth=2, placer=None) as pf:
        assert list(pf) == list(range(6))
        assert pf.stats.produced == pf.stats.consumed == 6
        assert pf.stats.hits + pf.stats.waits == 7  # six batches and the end
        assert pf.stats.hidden() is not None


def test_producer_exception_propagates():
    def source():
        yield 1
        raise RuntimeError("disk on fire")

    pf = tst.Prefetcher(source(), depth=2, placer=None)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(pf)
    pf.close()


def test_producer_exception_fails_the_stream(rng):
    _, St = _pair("CWT")
    A = torch.from_numpy(rng.standard_normal((N, M)))

    def factory(start):
        yield A[:BATCH]
        raise OSError("read error")

    with pytest.raises(OSError, match="read error"):
        tst.sketch(factory, St, "columnwise", ncols=M, params=cpu())


def test_placers(rng):
    X = rng.standard_normal((5, 3)).astype(np.float32)
    placed = tst.pipeline.ready(pinned_placer("cpu")({"x": X, "n": 3}))
    assert isinstance(placed["x"], torch.Tensor) and placed["n"] == 3
    bp = tst.pipeline.bucketed_placer((), device="cpu")
    out = tst.pipeline.ready(bp(X))
    assert isinstance(out, tst.pipeline.BucketedBatch) and out.true_rows == 5
    assert out.block.shape == (5, 3)  # never padded
    _, St = _pair("CWT", n=10)
    got = tst.sketch([X[:5], X], St, "columnwise", ncols=3, dtype=torch.float32,
                     params=StreamParams(placer=bp))
    want = St.apply(torch.from_numpy(np.concatenate([X[:5], X])), "columnwise")
    assert _rel(got, want) <= 1e-5


def test_default_placer_targets_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tst.device_placer(np.zeros(3))
    with pytest.raises(RuntimeError, match="is_available"):
        tst.engine.stream_device(StreamParams())


def test_error_paths(rng):
    _, St = _pair("JLT")
    with pytest.raises(ValueError, match="empty stream"):
        tst.sketch([], St, "rowwise", params=cpu())
    with pytest.raises(ValueError, match="rowwise"):
        tst.sketch([], St, "rowwise", params=cpu(checkpoint_dir="ck"))
    with pytest.raises(ValueError, match="ncols"):
        tst.sketch([], St, "columnwise", params=cpu())
    A = torch.from_numpy(rng.standard_normal((N - BATCH, M)))
    with pytest.raises(ValueError, match="sketch domain"):
        tst.sketch(blocks_of(A), St, "columnwise", ncols=M, params=cpu())
    factory = tst.as_block_factory(iter([1, 2, 3]))
    assert list(factory(0)) == [1, 2, 3]
    with pytest.raises(ValueError, match="one-shot"):
        factory(0)
    with pytest.raises(ValueError, match="one-shot"):
        tst.as_block_factory([1, 2])(1)
    assert list(tst.skip_batches(iter(range(5)), 2)) == [2, 3, 4]


def test_one_shot_iterable_cannot_resume(rng, tmp_path):
    _, St = _pair("CWT")
    A = torch.from_numpy(rng.standard_normal((N, M)))
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedPreemption):
        tst.sketch(blocks_of(A), St, "columnwise", ncols=M,
                   params=cpu(checkpoint_dir=ck, checkpoint_every=2),
                   fault_plan=FaultPlan(preempt_after_chunk=0))
    with pytest.raises(ValueError, match="one-shot"):
        tst.sketch(blocks_of(A), St, "columnwise", ncols=M,
                   params=cpu(checkpoint_dir=ck, checkpoint_every=2, resume=True))


@pytest.mark.parametrize("call", ["sketch", "sketch_least_squares", "streaming_least_squares"])
def test_partition_names_item_9(call):
    _, St = _pair("CWT")
    with pytest.raises(UnsupportedError, match="item 9"):
        if call == "sketch":
            tst.sketch([], St, ncols=M, partition=object())
        elif call == "sketch_least_squares":
            tst.sketch_least_squares([], St, ncols=M, partition=object())
        else:
            T.linalg.streaming_least_squares([], N, M, T.SketchContext(), partition=object())


@pytest.mark.parametrize("name", ["ElasticParams", "RowPartition", "distributed_sketch",
                                  "elastic_run_stream", "replan_resume"])
def test_elastic_names_item_9(name):
    with pytest.raises(UnsupportedError, match="item 9"):
        getattr(tst, name)()


def test_exports_match_jax():
    assert set(jst.__all__) == set(tst.__all__)
    from libskylark_tpu.streaming import pipeline as jpipe

    assert set(jpipe.__all__) <= set(tst.pipeline.__all__)
