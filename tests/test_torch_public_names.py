"""Port vs JAX package: the public names the python-skylark surface
keeps, ``sketch.deserialize_sketch``, ``sketch.SUPPORTED_SKETCH_TRANSFORMS``
and the error codes of ``utils`` (``AllocationError`` 101 and
``SketchError`` 103 among them).

A dict serialized by the JAX package goes through the port's
``deserialize_sketch`` and must give the transform ``from_dict`` gives:
the same JSON, the same output bitwise, hash buckets bitwise the JAX
package's, and values within the JAX package's 1e-5 relative of its own
apply (sums in another order; ``SKYLARK_NO_SRHT_GEMM=1`` puts the JAX
FJLT on the port's route, as ``test_torch_sketch.py`` does).  The
quasi-Monte-Carlo maps and the DCT FJLT are among the cases; the cosine
features of GaussianQRFT evaluate ndtri in f32, whose torch and XLA
versions differ in the last ulps, so it is held at 1e-4 (as
``test_torch_quasi.py`` holds it).  Every sketch type the JAX package
registers is registered in the port.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libskylark_tpu as J
import libskylark_tpu.utils.exceptions as JE
import libskylark_tpu_torch as T

TOL = 1e-5


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("stype,params,shape,dim", [
    ("CWT", {}, (300, 5), "columnwise"),
    ("SJLT", {"nnz": 2}, (4, 300), "rowwise"),
    ("MMT", {}, (300, 3), "columnwise"),
    ("FJLT", {}, (300, 4), "columnwise"),
    ("JLT", {}, (6, 300), "rowwise"),
    ("QJLT", {}, (300, 4), "columnwise"),
    ("GaussianQRFT", {"sigma": 3.0}, (5, 300), "rowwise"),
    ("FJLT", {"fut": "dct"}, (300, 4), "columnwise"),
])
def test_deserialize_sketch_applies_as_from_dict(rng, monkeypatch, stype, params, shape, dim):
    monkeypatch.setenv("SKYLARK_NO_SRHT_GEMM", "1")
    Sj = J.sketch.create_sketch(stype, 300, 40, J.SketchContext(seed=77), **params)
    d = Sj.serialize()
    St = T.sketch.deserialize_sketch(d)
    Sf = T.sketch.from_dict(d)
    assert type(St) is type(Sf) and St.to_json() == Sf.to_json() == Sj.to_json()
    A = rng.standard_normal(shape).astype(np.float32)
    out = St.apply(torch.from_numpy(A), dim)
    assert torch.equal(out, Sf.apply(torch.from_numpy(A), dim))
    assert _rel(out, Sj.apply(jnp.asarray(A), dim)) <= (1e-4 if stype == "GaussianQRFT" else TOL)
    if stype in ("CWT", "SJLT", "MMT"):
        np.testing.assert_array_equal(St.buckets(device="cpu").numpy(),
                                      np.asarray(Sj.buckets()))


def test_supported_sketch_transforms_is_the_jax_list_less_the_unported():
    ported = T.sketch.SUPPORTED_SKETCH_TRANSFORMS
    reference = J.sketch.SUPPORTED_SKETCH_TRANSFORMS
    assert ported == reference  # nothing is left unported
    assert set(T.sketch.sketch_registry()) == set(J.sketch.sketch_registry())
    assert all(t == (t[0], "Matrix", "Matrix") for t in ported)
    assert "SUPPORTED_SKETCH_TRANSFORMS" in T.sketch.__all__
    assert "deserialize_sketch" in T.sketch.__all__


@pytest.mark.parametrize("name", [
    "SkylarkError", "AllocationError", "InvalidParameters", "SketchError",
    "UnsupportedError", "IOError_", "ConvergenceError", "CheckpointError",
    "NumericalHealthError", "StaleEpochError", "RefinementError", "WorldMismatchError",
    "AdmissionError", "DeadlineExceededError", "ReplicaLostError", "RegistryEpochError",
    "QuotaExceededError", "JournalError", "CollectiveTimeoutError",
])
def test_error_codes_match_jax(name):
    ported, reference = getattr(T.utils, name), getattr(JE, name)
    assert name in T.utils.__all__
    assert ported.code == reference.code
    assert issubclass(ported, T.utils.SkylarkError)
    assert [c.__name__ for c in ported.__mro__] == [c.__name__ for c in reference.__mro__]


def test_parallel_exports_the_jax_names():
    import libskylark_tpu.parallel as jparallel

    assert T.parallel.__all__ == jparallel.__all__ and "parallel" in T.__all__
    for name in ("cross_host_psum", "CollectiveWatchdog"):
        assert getattr(T.parallel, name).__module__.endswith("parallel.collectives")
    assert T.parallel.HEARTBEAT_DIR == jparallel.HEARTBEAT_DIR
    assert (T.parallel.ROWS, T.parallel.COLS) == (jparallel.ROWS, jparallel.COLS)
    # The mesh and the explicit schedules are ported: the real functions
    # (tests/test_torch_mesh.py, tests/test_torch_sharded.py).
    for name in T.parallel.__all__:
        obj = getattr(T.parallel, name)
        if callable(obj):
            assert obj.__module__.endswith(("parallel.mesh", "parallel.collectives")), name
            assert "Not ported yet" not in (obj.__doc__ or ""), name


@pytest.mark.parametrize("what", ["serve", "fleet", "shard"])
def test_what_is_left_of_the_sharded_layer_names_item_9c(what, monkeypatch, capsys):
    """The serve layer's sharded programs, ``FleetFaultPlan`` and the CLI's
    ``--shard`` (what the JAX package leaves to GSPMD, item 9c) are
    ported: each works and none raises naming the item."""
    if what == "serve":
        from libskylark_tpu_torch.serve import dispatch

        # Two devices past the gates: the probe runs both routes and,
        # the bits matching, serves the reference's (the executor's blocks
        # of 8 columns; the whole 16 columns would take CWT's one-hot
        # route, other bits, and a tombstone).
        monkeypatch.setattr(dispatch, "_local_devices", lambda dev: [dev, dev])
        monkeypatch.setenv("SKYLARK_SERVE_SHARD", "1")
        dispatch.clear_cache()
        S = T.sketch.CWT(32, 8, T.SketchContext(seed=1))
        B = torch.from_numpy(np.random.default_rng(3).standard_normal((32, 16))).float()
        ref = torch.cat([T.plans.apply(S, b.contiguous(), "columnwise")
                         for b in B.split(8, dim=1)], dim=1)
        got = dispatch.maybe_sketch_sharded(S, B, 16, reference=lambda: ref)
        assert got is ref and list(dispatch._PROGRAMS.values())[0][1] is True
        dispatch.clear_cache()
    elif what == "fleet":
        fired = []
        plan = T.resilient.FleetFaultPlan(die_under_load_at=2)
        plan.bind_fleet(kill=lambda: fired.append("kill"))
        for tick in (1, 2, 3):
            plan.before_tick(tick)
        assert fired == ["kill"]
    else:
        from libskylark_tpu_torch.cli import common

        args = type("Args", (), {"shard": True})()
        one_slot = T.parallel.default_mesh  # one slot on the CPU: nothing pads
        monkeypatch.setattr(T.parallel, "default_mesh", lambda n_devices=None, device=None:
                            one_slot(2, device=device))
        A, n_orig = common.shard_input(args, torch.ones(5, 3), torch.device("cpu"))
        assert n_orig == 5 and A.shape == (6, 3) and A.mesh.size == 2
        monkeypatch.setattr(T.parallel, "default_mesh", one_slot)
        A, n_orig = common.shard_input(args, torch.ones(5, 3), torch.device("cpu"))
        assert n_orig == 5 and A.shape == (5, 3) and A.mesh.size == 1
        coo = torch.ones(5, 3).to_sparse_coo()
        assert common.shard_input(args, coo, torch.device("cpu")) == (coo, None)
        assert "ignores sparse inputs" in capsys.readouterr().out


@pytest.mark.parametrize("module", ["streaming", "ml"])
def test_elastic_layer_exports_the_jax_names(module):
    import importlib

    ported = importlib.import_module(f"libskylark_tpu_torch.{module}")
    reference = importlib.import_module(f"libskylark_tpu.{module}")
    assert set(ported.__all__) == set(reference.__all__)
    assert all("not ported" not in (getattr(ported, n).__doc__ or "") for n in ported.__all__
               if callable(getattr(ported, n)))


def test_plans_exports_the_jax_names():
    import libskylark_tpu.plans as jplans

    assert T.plans.__all__ == jplans.__all__
    assert all(hasattr(T.plans, name) for name in T.plans.__all__)
    assert "plans" in T.__all__ and T.plans is __import__("libskylark_tpu_torch.plans").plans
    assert callable(T.sketch.SketchTransform.apply_planned)


@pytest.mark.parametrize("name", ["note_plan", "warm_start"])
def test_policy_exports_the_plan_hooks(name):
    import libskylark_tpu.policy as jpolicy

    assert name in T.policy.__all__ and name in jpolicy.__all__
    assert callable(getattr(T.policy, name))


@pytest.mark.parametrize("module", ["io", "native"])
def test_io_and_native_export_the_jax_names(module):
    import importlib

    ported = importlib.import_module(f"libskylark_tpu_torch.{module}")
    reference = importlib.import_module(f"libskylark_tpu.{module}")
    assert ported.__all__ == reference.__all__
    assert all(callable(getattr(ported, name)) for name in ported.__all__)


def test_cli_common_keeps_the_jax_names():
    import libskylark_tpu.cli.common as jcommon
    import libskylark_tpu_torch.cli.common as tcommon

    assert set(jcommon.__all__) <= set(tcommon.__all__)
    assert all(hasattr(tcommon, name) for name in tcommon.__all__)


def test_graph_exports_read_arc_list_as_jax():
    assert T.graph.__all__ == J.graph.__all__
    assert T.graph.read_arc_list is T.graph.graph.read_arc_list
    assert "io" in T.__all__ and T.io.read_libsvm is T.io.libsvm.read_libsvm


def test_telemetry_exports_the_jax_names():
    import importlib

    import libskylark_tpu.telemetry as jtel

    assert T.telemetry.__all__ == jtel.__all__
    assert all(hasattr(T.telemetry, name) for name in T.telemetry.__all__)
    assert "telemetry" in T.__all__ and "telemetry" in J.__all__
    assert T.telemetry is importlib.import_module("libskylark_tpu_torch.telemetry")
    assert "profiling" in T.utils.__all__
    assert callable(T.utils.profiling.trace) and callable(T.utils.profiling.annotate)


@pytest.mark.parametrize("name", ["asy_fcg", "randomized_block_gauss_seidel"])
def test_solvers_export_the_gauss_seidel_solvers(name):
    assert name in T.solvers.__all__ and name in J.solvers.__all__
    fn = getattr(T.solvers, name)
    assert fn.__module__ in ("libskylark_tpu_torch.solvers.asynch",
                             "libskylark_tpu_torch.solvers.gauss_seidel")


@pytest.mark.parametrize("module", ["serve", "serve.journal", "serve.dispatch", "serve.protocol",
                                    "serve.cache", "serve.qos"])
def test_serve_exports_the_jax_names(module):
    import importlib

    ported = importlib.import_module(f"libskylark_tpu_torch.{module}")
    reference = importlib.import_module(f"libskylark_tpu.{module}")
    assert ported.__all__ == reference.__all__
    assert all(hasattr(ported, name) for name in ported.__all__)
    if module == "serve":
        assert "serve" in T.__all__ and T.serve is ported


@pytest.mark.parametrize("name", ["serve", "top"])
def test_cli_serve_and_top_exist(name):
    import importlib

    mod = importlib.import_module(f"libskylark_tpu_torch.cli.{name}")
    assert callable(mod.main)
    text = (Path(T.__file__).resolve().parent.parent / "pyproject.toml").read_text()
    assert f'skylark-torch-{name} = "libskylark_tpu_torch.cli.{name}:main"' in text


@pytest.mark.parametrize("stype,params", [("FJLT", {}), ("CWT", {}), ("PPT", {"q": 2}),
                                          ("FastGaussianRFT", {"sigma": 2.0})])
def test_serialize_is_the_jax_dict(stype, params):
    """``SketchTransform.serialize()``, python-skylark's name for
    ``to_dict()``: the dict the JAX package's ``serialize()`` gives, which
    ``deserialize_sketch`` takes back."""
    Sj = J.sketch.create_sketch(stype, 64, 16, J.SketchContext(seed=5), **params)
    St = T.sketch.create_sketch(stype, 64, 16, T.SketchContext(seed=5), **params)
    assert St.serialize() == St.to_dict() == Sj.serialize()
    assert T.sketch.deserialize_sketch(St.serialize()).to_json() == St.to_json()
