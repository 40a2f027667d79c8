"""Port vs JAX package: the checkpoint format and store
(``utils/checkpoint.py``), the fault plan (``resilient/faults.py``) and
the resilient runner (``resilient/runner.py``), mirroring
``tests/test_resilient.py``.

The two packages' checkpoint files cross-load leaf for leaf (bf16
included).  The port's own pins: a run killed at a chunk boundary and
resumed from its checkpoint is bitwise the uninterrupted run (LSQR, the
randomized SVD, BlockADMM), a corrupt newest slot falls back to the one
before, transient IO errors are retried, divergence halts with the last
finite iterate.  The runner over the port's ``lsqr_chunked`` is held
against the JAX runner over the JAX one at 1e-10 (f64).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu_torch as T
from libskylark_tpu import resilient as jres
from libskylark_tpu import utils as jutils
from libskylark_tpu_torch import resilient as tres
from libskylark_tpu_torch.utils import checkpoint as tck
from libskylark_tpu_torch.utils.exceptions import (
    CheckpointError,
    ConvergenceError,
    IOError_,
    StaleEpochError,
    UnsupportedError,
)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _lsqr_problem(rng, m=60, n=12):
    A = rng.standard_normal((m, n))
    B = rng.standard_normal((m, 2))
    return torch.from_numpy(A), torch.from_numpy(B)


def _awkward_state():
    return {
        "bf16": torch.tensor([1.5, -2.25, 0.125], dtype=torch.bfloat16),
        "scalar0d": torch.tensor(3.5, dtype=torch.float64),
        "count": torch.tensor(7, dtype=torch.int32),
        "nested": (
            {"a": torch.ones((2, 3), dtype=torch.float64),
             "b": [torch.zeros((1,), dtype=torch.float32)]},
            torch.tensor([True, False]),
        ),
    }


# ---------------------------------------------------------------------------
# Checkpoint format


def test_roundtrip_awkward_tree(tmp_path):
    state = _awkward_state()
    tck.save_solver_state(tmp_path / "ck", state, {"iter": 7})
    restored, meta = tck.load_solver_state(tmp_path / "ck", like=state)
    assert meta["iter"] == 7
    assert restored["bf16"].dtype == torch.bfloat16
    assert torch.equal(restored["bf16"], state["bf16"])
    assert restored["scalar0d"].shape == () and restored["count"].dtype == torch.int32
    assert torch.equal(restored["nested"][0]["a"], state["nested"][0]["a"])
    assert isinstance(restored["nested"], tuple) and isinstance(restored["nested"][0]["b"], list)
    assert torch.equal(restored["nested"][1], torch.tensor([True, False]))


def test_flatten_order_is_the_jax_pytree_order():
    import jax

    state = {"b": [1, (2, 3)], "a": {"y": 4, "x": 5}, "c": None, "d": 6}
    leaves, treedef = tck.tree_flatten(state)
    assert leaves == jax.tree.leaves(state)
    assert tck.tree_unflatten(treedef, leaves) == state


def test_flat_load_without_like(tmp_path):
    tck.save_solver_state(tmp_path / "ck", [torch.arange(4.0), torch.tensor(2)])
    leaves, _ = tck.load_solver_state(tmp_path / "ck")
    assert len(leaves) == 2 and torch.equal(leaves[0], torch.arange(4.0))


def test_python_number_and_numpy_leaves_come_back_as_such(tmp_path):
    state = {"it": 3, "row": np.asarray(5, np.int64), "x": torch.ones(2)}
    tck.save_solver_state(tmp_path / "ck", state)
    restored, _ = tck.load_solver_state(tmp_path / "ck", like=state)
    assert restored["it"] == 3 and isinstance(restored["it"], int)
    assert isinstance(restored["row"], np.ndarray) and int(restored["row"]) == 5


def test_wrong_object_type_rejected(tmp_path):
    meta = {"skylark_object_type": "model", "num_leaves": 0, "metadata": {}}
    np.savez(tmp_path / "ck.npz", __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    with pytest.raises(IOError_, match="skylark_object_type"):
        tck.load_solver_state(tmp_path / "ck")


def test_num_leaves_mismatch_rejected(tmp_path):
    tck.save_solver_state(tmp_path / "ck", [torch.ones(2), torch.ones(3)])
    with np.load(tmp_path / "ck.npz") as data:
        kept = {k: data[k] for k in data.files if k != "leaf_1"}
    np.savez(tmp_path / "ck.npz", **kept)
    with pytest.raises(CheckpointError, match="num_leaves"):
        tck.load_solver_state(tmp_path / "ck")


def test_crc_mismatch_rejected(tmp_path):
    tck.save_solver_state(tmp_path / "ck", [torch.arange(8.0)])
    with np.load(tmp_path / "ck.npz") as data:
        arrs = {k: data[k] for k in data.files}
    arrs["leaf_0"] = arrs["leaf_0"] + 1.0
    np.savez(tmp_path / "ck.npz", **arrs)
    with pytest.raises(CheckpointError, match="CRC32"):
        tck.load_solver_state(tmp_path / "ck")


def test_like_leaf_count_mismatch_rejected(tmp_path):
    tck.save_solver_state(tmp_path / "ck", [torch.ones(2)])
    with pytest.raises(CheckpointError, match="prototype"):
        tck.load_solver_state(tmp_path / "ck", like=[torch.ones(2), torch.ones(2)])


def test_handle_released_after_load(tmp_path):
    tck.save_solver_state(tmp_path / "ck", [torch.ones(2)])
    for _ in range(64):
        tck.load_solver_state(tmp_path / "ck")
    os.remove(tmp_path / "ck.npz")


# ---------------------------------------------------------------------------
# Cross-loading between the packages


def test_port_checkpoint_loads_in_jax_leaf_for_leaf(tmp_path):
    state = _awkward_state()
    tck.save_solver_state(tmp_path / "ck", state, {"iter": 3})
    leaves, meta = jutils.load_solver_state(tmp_path / "ck")
    want, _ = tck.tree_flatten(state)
    assert meta["iter"] == 3 and len(leaves) == len(want)
    for got, ref in zip(leaves, want):
        assert str(np.asarray(got).dtype) == str(ref.dtype).replace("torch.", "")
        assert _bits(got) == _bits(ref)


def test_jax_checkpoint_loads_in_port_leaf_for_leaf(tmp_path):
    state = {
        "bf16": jnp.asarray([1.5, -2.25, 0.125], jnp.bfloat16),
        "count": jnp.asarray(7, jnp.int32),
        "nested": ({"a": jnp.ones((2, 3)), "b": [jnp.arange(3.0, dtype=jnp.float32)]},
                   jnp.asarray([True, False])),
    }
    jutils.save_solver_state(tmp_path / "ck", state, {"iter": 9})
    leaves, meta = tck.load_solver_state(tmp_path / "ck")
    import jax

    want = jax.tree.leaves(state)
    assert meta["iter"] == 9 and len(leaves) == len(want)
    for got, ref in zip(leaves, want):
        assert str(got.dtype).replace("torch.", "") == str(np.asarray(ref).dtype)
        assert _bits(got) == _bits(ref)


def test_store_slots_cross_load(tmp_path):
    jstore = jutils.CheckpointStore(tmp_path / "j", keep_last=2)
    jstore.save({"x": jnp.arange(4.0), "batch": np.asarray(3, np.int64)}, step=3)
    state, meta, step = tck.CheckpointStore(tmp_path / "j").load_latest(
        like={"x": torch.zeros(4, dtype=torch.float64), "batch": np.asarray(0, np.int64)})
    assert step == 3 and meta["step"] == 3 and torch.equal(state["x"], torch.arange(4.0).double())
    tstore = tck.CheckpointStore(tmp_path / "t", keep_last=2)
    tstore.save({"x": torch.arange(4.0), "batch": np.asarray(5, np.int64)}, step=5)
    jstate, jmeta, jstep = jutils.CheckpointStore(tmp_path / "t").load_latest(
        like={"x": jnp.zeros(4, jnp.float32), "batch": np.asarray(0, np.int64)})
    assert jstep == 5 and np.array_equal(np.asarray(jstate["x"]), np.arange(4.0, dtype=np.float32))


# ---------------------------------------------------------------------------
# The store


def test_rotation_keeps_last_n(tmp_path):
    store = tck.CheckpointStore(tmp_path, keep_last=3)
    for step in [2, 4, 6, 8, 10]:
        store.save({"x": torch.full((2,), float(step))}, step=step)
    assert store.steps() == [6, 8, 10]


def test_empty_dir_returns_none(tmp_path):
    assert tck.CheckpointStore(tmp_path).load_latest() is None


def test_corrupt_newest_falls_back_to_previous_slot(tmp_path):
    store = tck.CheckpointStore(tmp_path, keep_last=3)
    store.save({"x": torch.full((64,), 1.0)}, step=1)
    path = store.save({"x": torch.full((64,), 2.0)}, step=2)
    tres.corrupt_checkpoint(path)
    state, _, step = store.load_latest(like={"x": torch.zeros(64)})
    assert step == 1 and torch.equal(state["x"], torch.full((64,), 1.0))


def test_all_slots_corrupt_raises(tmp_path):
    store = tck.CheckpointStore(tmp_path, keep_last=2)
    for step in (1, 2):
        tres.corrupt_checkpoint(store.save({"x": torch.ones(64)}, step=step))
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        store.load_latest()


def test_stale_epoch_slot_raises(tmp_path):
    store = tck.CheckpointStore(tmp_path)
    store.save({"x": torch.ones(2)}, step=1, metadata={"elastic": {"epoch": 2}})
    with pytest.raises(StaleEpochError) as err:
        store.load_latest(expect_epoch=3)
    assert err.value.code == 111 and (err.value.expected, err.value.got) == (3, 2)
    assert store.load_latest(expect_epoch=2)[2] == 1


def test_error_codes_match_jax():
    from libskylark_tpu.utils import exceptions as jexc
    from libskylark_tpu_torch.utils import exceptions as texc

    for name in ("IOError_", "ConvergenceError", "CheckpointError", "StaleEpochError"):
        assert getattr(texc, name).code == getattr(jexc, name).code
    assert issubclass(CheckpointError, IOError_)


# ---------------------------------------------------------------------------
# Retries and fault plans


def test_with_retries_succeeds_after_transient_failures():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert tres.with_retries(flaky, retries=3, backoff=0.5, sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]


def test_with_retries_exhausted_reraises():
    def broken():
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        tres.with_retries(broken, retries=2, sleep=lambda s: None)


def test_fault_plan_block_faults_are_one_shot():
    plan = tres.FaultPlan(nan_at=1, bad_sketch_at=2)
    blk = {"x": torch.ones(3), "i": torch.arange(3)}
    assert torch.isnan(plan.corrupt_block(1, blk)["x"]).all()
    assert torch.equal(plan.corrupt_block(1, blk)["x"], torch.ones(3))
    bad = plan.corrupt_block(2, (torch.ones(2), torch.arange(2)))
    assert torch.isinf(bad[0]).all() and torch.equal(bad[1], torch.arange(2))
    SA = torch.ones(4, 3)
    plan = tres.FaultPlan(nan_at=0, bad_sketch_at=1)
    assert torch.isnan(plan.corrupt_sketch(0, SA)).all()
    collapsed = plan.corrupt_sketch(1, SA)
    assert torch.equal(collapsed[0], SA[0]) and not collapsed[1:].any()
    assert torch.equal(plan.corrupt_sketch(1, SA), SA)


@pytest.mark.parametrize("name", ["HostFaultPlan", "FleetFaultPlan", "corrupt_manifest",
                                  "tear_ledger_tail"])
def test_host_faults_name_their_item(name):
    with pytest.raises(UnsupportedError, match="item 9"):
        getattr(tres, name)()


# ---------------------------------------------------------------------------
# The runner


def _run_lsqr(A, B, kp, ckdir=None, plan=None, resume=False, every=5, **kw):
    return tres.ResilientRunner(
        T.solvers.lsqr_chunked(A, B, params=kp),
        tres.ResilientParams(checkpoint_dir=None if ckdir is None else str(ckdir),
                             checkpoint_every=every, resume=resume),
        fault_plan=plan, **kw).run()


def test_runner_lsqr_matches_jax_runner(rng):
    A, B = _lsqr_problem(rng)
    kp_t = T.solvers.KrylovParams(iter_lim=30, tolerance=1e-12)
    kp_j = J.solvers.KrylovParams(iter_lim=30, tolerance=1e-12)
    Xt, it = _run_lsqr(A, B, kp_t, every=7)
    Xj, ij = jres.ResilientRunner(
        J.solvers.lsqr_chunked(jnp.asarray(A.numpy()), jnp.asarray(B.numpy()), params=kp_j),
        jres.ResilientParams(checkpoint_every=7)).run()
    Xj = np.asarray(Xj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-10 * np.abs(Xj).max()
    assert int(it["iterations"]) == int(ij["iterations"])


def test_runner_lsqr_bitwise_one_shot(rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=30, tolerance=1e-12)
    X1, i1 = T.solvers.lsqr(A, B, params=kp)
    X2, i2 = _run_lsqr(A, B, kp, every=7)
    assert torch.equal(X1, X2) and int(i1["iterations"]) == int(i2["iterations"])


@pytest.mark.parametrize("kill_at", [0, 1, 2])
def test_lsqr_killed_then_resumed_bitwise(tmp_path, rng, kill_at):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=40, tolerance=1e-13)
    X_ref, info_ref = _run_lsqr(A, B, kp, tmp_path / "ref")
    with pytest.raises(tres.SimulatedPreemption):
        _run_lsqr(A, B, kp, tmp_path / "ck", plan=tres.FaultPlan(preempt_after_chunk=kill_at))
    assert tck.CheckpointStore(tmp_path / "ck").steps()
    X_res, info_res = _run_lsqr(A, B, kp, tmp_path / "ck", resume=True)
    assert torch.equal(X_ref, X_res)
    assert int(info_ref["iterations"]) == int(info_res["iterations"])


def test_lsqr_corrupt_newest_recovers_from_previous_slot(tmp_path, rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=40, tolerance=1e-13)
    X_ref, _ = _run_lsqr(A, B, kp, tmp_path / "ref")
    with pytest.raises(tres.SimulatedPreemption):
        _run_lsqr(A, B, kp, tmp_path / "ck", plan=tres.FaultPlan(preempt_after_chunk=1))
    store = tck.CheckpointStore(tmp_path / "ck")
    assert len(store.steps()) == 2
    tres.corrupt_checkpoint(os.path.join(store.directory, f"ckpt-{store.steps()[-1]:012d}.npz"))
    X_res, _ = _run_lsqr(A, B, kp, tmp_path / "ck", resume=True)
    assert torch.equal(X_ref, X_res)


def test_svd_killed_then_resumed_bitwise(tmp_path, rng):
    A = torch.from_numpy(rng.standard_normal((48, 16)))
    params = T.linalg.SVDParams(num_iterations=4)

    def run(d, plan=None, resume=False):
        return tres.ResilientRunner(
            T.linalg.approximate_svd_chunked(A, 4, T.SketchContext(seed=5), params),
            tres.ResilientParams(checkpoint_dir=str(d), checkpoint_every=1, resume=resume),
            fault_plan=plan).run()

    ref = run(tmp_path / "ref")
    with pytest.raises(tres.SimulatedPreemption):
        run(tmp_path / "ck", tres.FaultPlan(preempt_after_chunk=1))
    res = run(tmp_path / "ck", resume=True)
    assert all(torch.equal(a, b) for a, b in zip(ref, res))


def test_admm_killed_then_resumed_bitwise(tmp_path, rng):
    X = torch.from_numpy(rng.standard_normal((64, 5)))
    y = torch.from_numpy(np.sign(rng.standard_normal(64)))
    maps = [T.ml.GaussianKernel(5, 2.0).create_rft(16, "regular", T.SketchContext(seed=3))]
    p = T.ml.ADMMParams(data_partitions=2, maxiter=12)

    def run(d, plan=None, resume=False):
        solver = T.ml.BlockADMMSolver("squared", "l2", maps, p)
        return tres.ResilientRunner(
            solver.chunked(X, y, regression=True),
            tres.ResilientParams(checkpoint_dir=str(d), checkpoint_every=3, resume=resume),
            fault_plan=plan).run()

    ref = run(tmp_path / "ref")
    with pytest.raises(tres.SimulatedPreemption):
        run(tmp_path / "ck", tres.FaultPlan(preempt_after_chunk=1))
    res = run(tmp_path / "ck", resume=True)
    assert torch.equal(ref.W, res.W)


def test_resume_refuses_foreign_solver_kind(tmp_path, rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=10, tolerance=1e-13)
    _run_lsqr(A, B, kp, tmp_path)
    svd = T.linalg.approximate_svd_chunked(A, 2, T.SketchContext(seed=1),
                                           T.linalg.SVDParams(num_iterations=2))
    with pytest.raises(CheckpointError, match="solver kind"):
        tres.ResilientRunner(svd, tres.ResilientParams(checkpoint_dir=str(tmp_path),
                                                       resume=True)).run()


def test_transient_io_errors_are_retried(tmp_path, rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=20, tolerance=1e-13)
    sleeps = []
    X1, _ = _run_lsqr(A, B, kp)
    X2, _ = _run_lsqr(A, B, kp, tmp_path, plan=tres.FaultPlan(io_errors_on_save={0: 2}),
                      sleep=sleeps.append)
    assert torch.equal(X1, X2) and len(sleeps) == 2


def test_io_errors_beyond_retry_budget_raise(tmp_path, rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=20, tolerance=1e-13)
    with pytest.raises(OSError, match="injected"):
        _run_lsqr(A, B, kp, tmp_path, plan=tres.FaultPlan(io_errors_on_save={0: 9}),
                  sleep=lambda s: None)


def test_divergence_halts_with_best_iterate(rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=40, tolerance=1e-13)
    with pytest.raises(ConvergenceError) as err:
        _run_lsqr(A, B, kp, plan=tres.FaultPlan(nan_after_chunk=1))
    X, _ = err.value.result
    assert bool(torch.isfinite(X).all()) and err.value.iteration == 5  # chunk 0 done


def test_divergence_unchecked_when_disabled(rng):
    A, B = _lsqr_problem(rng)
    kp = T.solvers.KrylovParams(iter_lim=40, tolerance=1e-13)
    runner = tres.ResilientRunner(
        T.solvers.lsqr_chunked(A, B, params=kp),
        tres.ResilientParams(checkpoint_every=5, check_divergence=False, max_chunks=3),
        fault_plan=tres.FaultPlan(nan_after_chunk=0))
    X, _ = runner.run()
    assert bool(torch.isnan(X).any())


def test_runner_rejects_zero_chunk():
    with pytest.raises(ValueError, match="checkpoint_every"):
        tres.ResilientRunner(None, tres.ResilientParams(checkpoint_every=0))


def test_exports_match_jax():
    assert set(jres.__all__) == set(tres.__all__)
    assert set(jutils.checkpoint.__all__) <= set(tck.__all__)
