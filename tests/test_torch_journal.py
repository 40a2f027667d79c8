"""Port vs JAX package: the serve registry's write-ahead journal
(``serve/journal.py``, ``Registry.recover``), on the CPU.

- Both ways: a state directory written by the JAX registry (x64, f64
  arrays) recovers in the port, and one written by the port recovers in
  the JAX package, with every array that the snapshot or a registration
  record carries bitwise and the epoch log and idempotency window equal;
  a mutation in the journal's tail is replayed by the recovering
  package's own code (its ``S·A`` within 1e-12 of the writer's).
- The port against itself: recover is bitwise (every mint kind), a torn
  final line is truncated and counted, damage with valid records after
  it and an epoch gap raise code 118, the idempotency window dedups an
  update and survives recovery, and a child process SIGKILLed inside
  the commit window (``JournalFaultPlan``) recovers to the bits of a
  registry that ran the same stream without dying (die-after-append:
  the record is replayed; torn: the update is lost).
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu.plans.plan as jplan
from libskylark_tpu import plans as jplans
from libskylark_tpu.core.context import SketchContext as JCtx
from libskylark_tpu.graph.graph import SimpleGraph as JGraph
from libskylark_tpu.ml.kernels import GaussianKernel as JGaussian
from libskylark_tpu.ml.model import KernelModel as JKernelModel
from libskylark_tpu.serve.journal import Journal as JJournal
from libskylark_tpu.serve.registry import Registry as JRegistry
from libskylark_tpu_torch import serve
from libskylark_tpu_torch.core.context import SketchContext
from libskylark_tpu_torch.graph.graph import SimpleGraph
from libskylark_tpu_torch.ml.kernels import GaussianKernel
from libskylark_tpu_torch.ml.model import KernelModel
from libskylark_tpu_torch.serve.journal import Journal, read_journal
from libskylark_tpu_torch.serve.registry import Registry
from libskylark_tpu_torch.utils import exceptions as ex

pytestmark = pytest.mark.durability

ROOT = Path(__file__).resolve().parent.parent
N_V = 16
RING = [(v, (v + 1) % N_V) for v in range(N_V)]


@pytest.fixture(autouse=True)
def parity_env(monkeypatch):
    monkeypatch.setenv("SKYLARK_POLICY", "0")
    # The JAX package's plans off (its plan path needs an API the
    # installed jax removed).
    monkeypatch.setattr(jplans, "enabled", lambda: False)
    monkeypatch.setattr(jplan, "enabled", lambda: False)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # the JAX side runs under x64
    yield
    torch.set_default_dtype(old)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def arrays(registry) -> dict:
    """Every array a registry holds, by (entity, field), as numpy."""
    out = {}
    for name, s in registry.systems.items():
        for f in ("A", "SA", "Qt", "R"):
            out[(name, f)] = _np(getattr(s, f))
        out[(name, "retired")] = np.asarray(sorted(s.retired))
    for name, g in registry.graphs.items():
        for f in ("X", "lam", "_sa"):
            out[(name, f)] = _np(getattr(g, f))
        out[(name, "indptr")], out[(name, "indices")] = g.G.indptr, g.G.indices
    for name, m in registry.models.items():
        for f in ("X_train", "A", "W"):
            if getattr(m, f, None) is not None:
                out[(name, f)] = _np(getattr(m, f))
    return out


def digest(registry) -> dict:
    crc = 0
    for key, a in sorted(arrays(registry).items(), key=lambda kv: str(kv[0])):
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return {"epoch": registry.epoch, "epoch_log": registry.epoch_log, "crc": crc,
            "idem": sorted([t, k, rec["epoch"]] for (t, k), rec in registry._idem.items())}


def _populate(reg, ctx, graph, kernel_model, kernel, rng):
    reg.register_system("sys", rng.standard_normal((24, 5)), context=ctx(seed=9),
                        sketch_type="CWT", sketch_size=32, capacity=96)
    reg.register_graph("g", graph(RING), k=2, context=ctx(seed=5))
    reg.register_model("krr", kernel_model(kernel(12, sigma=1.1), rng.standard_normal((10, 12)),
                                           rng.standard_normal((10, 3))))


def _mutate(reg, rng):
    reg.append_system_rows("sys", rng.standard_normal((3, 5)), idem=("t0", "a"))
    reg.fold_graph_edges("g", [(0, 5), (3, 9)], idem=("t0", "b"))
    reg.downdate_system_rows("sys", [1, 4], idem=("t0", "c"))


def _port_registry(directory, **jkw):
    reg = Registry(journal=Journal(str(directory), **jkw), device="cpu")
    rng = np.random.default_rng(3)
    _populate(reg, SketchContext, SimpleGraph,
              lambda k, X, A: KernelModel(k, X, A, device="cpu"), GaussianKernel, rng)
    return reg, rng


def _jax_registry(directory, **jkw):
    reg = JRegistry(journal=JJournal(str(directory), **jkw))
    rng = np.random.default_rng(3)
    _populate(reg, JCtx, JGraph, JKernelModel, JGaussian, rng)
    return reg, rng


def _assert_same_arrays(a, b, keys=None):
    xa, xb = arrays(a), arrays(b)
    assert set(xa) == set(xb)
    for key in keys or xa:
        assert xa[key].dtype == xb[key].dtype and np.array_equal(xa[key], xb[key]), key


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_recovers_across_packages(tmp_path, writer):
    """Six records compact into a snapshot; a registration and a row
    append form the journal's tail."""
    make = _jax_registry if writer == "jax" else _port_registry
    reg, rng = make(tmp_path, compact_every=6)
    _mutate(reg, rng)
    assert reg.epoch == 6 and (tmp_path / "registry-journal.jsonl").stat().st_size == 0
    reg.register_system("sys2", rng.standard_normal((40, 4)), context=(
        JCtx if writer == "jax" else SketchContext)(seed=2), sketch_type="SJLT", sketch_size=16)
    snap_arrays = arrays(reg)
    reg.append_system_rows("sys", rng.standard_normal((2, 5)), idem=("t1", "d"))
    reg.journal.close()

    rec = (Registry.recover(str(tmp_path), device="cpu") if writer == "jax"
           else JRegistry.recover(str(tmp_path)))
    assert rec.epoch == reg.epoch == 8
    assert rec.epoch_log == reg.epoch_log
    assert {k: v["epoch"] for k, v in rec._idem.items()} == \
        {k: v["epoch"] for k, v in reg._idem.items()}
    got = arrays(rec)
    for key, a in snap_arrays.items():
        if key[0] != "sys":  # the snapshot's and the registration record's bits
            assert got[key].dtype == a.dtype and np.array_equal(got[key], a), key
    # sys's last append was replayed by the recovering package's own code.
    want = arrays(reg)
    for f in ("A", "retired"):
        assert np.array_equal(got[("sys", f)], want[("sys", f)])
    sa, sa_w = got[("sys", "SA")], want[("sys", "SA")]
    assert np.abs(sa - sa_w).max() <= 1e-12 * np.abs(sa_w).max()


def test_port_recover_bitwise_and_live(tmp_path):
    reg, rng = _port_registry(tmp_path)
    _mutate(reg, rng)
    reg.update_model("krr", append=(rng.standard_normal((2, 12)), rng.standard_normal((2, 3))))
    reg.update_model("krr", drop=[10])
    reg.update_model("krr", model=KernelModel(GaussianKernel(12, sigma=1.2),
                                              rng.standard_normal((4, 12)),
                                              rng.standard_normal((4, 3)), device="cpu"))
    assert reg.epoch == 9
    rec = Registry.recover(str(tmp_path), device="cpu")
    assert digest(rec) == digest(reg)
    _assert_same_arrays(rec, reg)
    rows = rng.standard_normal((2, 5))
    reg.append_system_rows("sys", rows)
    rec.append_system_rows("sys", rows)
    assert digest(rec) == digest(reg)


def test_torn_tail_truncated_and_midfile_damage_raises_118(tmp_path):
    reg, rng = _port_registry(tmp_path, compact_every=0)
    _mutate(reg, rng)
    reg.journal.close()
    path = tmp_path / "registry-journal.jsonl"
    raw = path.read_bytes()
    path.write_bytes(raw + raw.splitlines(keepends=True)[-1][:40])  # a torn frame
    rec = Registry.recover(str(tmp_path), device="cpu")
    assert rec.journal.torn_truncated == 1 and rec.epoch == 6
    assert path.read_bytes() == raw  # truncated back to the clean prefix
    rec.journal.close()

    lines = raw.splitlines(keepends=True)
    bad = lines[1].replace(b'"epoch":', b'"epoch" :', 1)[:-20] + b'garbage"}\n'
    path.write_bytes(lines[0] + bad + b"".join(lines[2:]))
    with pytest.raises(ex.JournalError) as info:
        read_journal(str(path))
    assert info.value.code == 118 and info.value.reason == "crc" and info.value.record == 2

    path.write_bytes(lines[0] + b"".join(lines[2:]))  # record 2 gone: an epoch gap
    with pytest.raises(ex.JournalError) as info:
        Registry.recover(str(tmp_path), device="cpu")
    assert info.value.reason == "epoch-gap"


def test_idempotency_window_dedups_and_survives_recovery(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYLARK_IDEM_WINDOW", "2")
    srv = serve.Server(serve.ServeParams(warm_start=False, prime=False, state_dir=str(tmp_path)),
                       seed=1, device="cpu")
    srv.register_system("sys", np.random.default_rng(0).standard_normal((24, 5)),
                        sketch_type="CWT", capacity=64)
    srv.start()
    try:
        rows = [[float(i)] * 5 for i in range(3)]
        first = srv.call(op="update", system="sys", append=rows[:1], idem_key="k1")
        again = srv.call(op="update", system="sys", append=rows[:1], idem_key="k1")
        other_tenant = srv.call(op="update", system="sys", append=rows[:1], idem_key="k1",
                                tenant="b")
        srv.call(op="update", system="sys", append=rows[1:2], idem_key="k2")
        srv.call(op="update", system="sys", append=rows[2:3], idem_key="k3")
    finally:
        srv.stop()
    assert first["ok"] and again["ok"] and again["result"] == first["result"]
    assert any(e["kind"] == "idem_replay" for e in again["trace"]["events"])
    assert other_tenant["result"]["epoch"] == first["result"]["epoch"] + 1
    reg = srv.registry
    assert reg.get_system("sys").m == 24 + 4
    assert list(reg._idem) == [("default", "k2"), ("default", "k3")]  # k1 evicted
    srv.registry.journal.close()
    rec = Registry.recover(str(tmp_path), device="cpu")
    assert rec._idem == reg._idem and rec.idem_receipt("default", "k3") == \
        reg.idem_receipt("default", "k3")
    rec.journal.close()


# The crash child: the port's registry journaling into argv[1], a
# JournalFaultPlan from argv[2] (die-after or torn, at append argv[3]),
# driving the update stream of ``_STREAM`` through a server until the
# plan SIGKILLs it.
_CHILD = r"""
import json, sys
import numpy as np
import torch
torch.set_default_dtype(torch.float64)
from libskylark_tpu_torch import serve
from libskylark_tpu_torch.graph.graph import SimpleGraph
from libskylark_tpu_torch.resilient.faults import JournalFaultPlan
from libskylark_tpu_torch.serve.journal import Journal
from libskylark_tpu_torch.serve.registry import Registry
state, mode, at = sys.argv[1], sys.argv[2], int(sys.argv[3])
plan = (JournalFaultPlan(die_after_journal_before_publish=at) if mode == "die-after"
        else JournalFaultPlan(torn_journal_at=at))
srv = serve.Server(serve.ServeParams(warm_start=False, prime=False), seed=11, device="cpu")
srv.registry = Registry(cache=srv.cache, journal=Journal(state, compact_every=0, faults=plan),
                        device="cpu")
srv.register_system("sys", np.random.default_rng(3).standard_normal((24, 5)),
                    sketch_type="CWT", capacity=96)
srv.register_graph("g", SimpleGraph([(v, (v + 1) % 16) for v in range(16)]), k=2)
srv.start()
for req in json.loads(sys.argv[4]):
    srv.call(req)
print("JOURNAL-SURVIVED", flush=True)
"""


def _stream(n):
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            reqs.append({"op": "update", "system": "sys", "idem_key": f"u{i}",
                         "append": rng.normal(size=(2, 5)).tolist()})
        elif i % 3 == 1:
            reqs.append({"op": "update", "graph": "g", "idem_key": f"u{i}",
                         "edges": [[i % N_V, (i + 5 + i % 7) % N_V]]})
        else:
            reqs.append({"op": "update", "system": "sys", "idem_key": f"u{i}", "drop": [i]})
    return reqs


def _control(n):
    """The same server and stream, never crashed, journal-less."""
    srv = serve.Server(serve.ServeParams(warm_start=False, prime=False), seed=11, device="cpu")
    srv.register_system("sys", np.random.default_rng(3).standard_normal((24, 5)),
                        sketch_type="CWT", capacity=96)
    srv.register_graph("g", SimpleGraph(RING), k=2)
    srv.start()
    for req in _stream(n):
        assert srv.call(req)["ok"]
    srv.stop()
    return srv.registry


@pytest.mark.parametrize("mode,survives", [("die-after", 5), ("torn", 4)])
def test_sigkill_child_recovers_to_the_control(tmp_path, mode, survives):
    """Append index 2 + 4 is update 4 (two registrations first): killed
    after its durable append it is replayed (5 updates survive), torn
    mid-frame it is lost (4 survive)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), mode, "6",
                           json.dumps(_stream(7))], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "JOURNAL-SURVIVED" not in proc.stdout
    rec = Registry.recover(str(tmp_path), device="cpu")
    assert rec.journal.torn_truncated == (mode == "torn")
    assert digest(rec) == digest(_control(survives))
    rec.journal.close()


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16", "int64", "int32"])
def test_array_codec_is_the_jax_format(dtype):
    """A journal record's array, encoded by either package, decodes in the
    other bitwise with its dtype (bfloat16 by its bits: numpy has no such
    dtype, the JAX package's ``ml_dtypes`` arrays and torch store the same
    two bytes)."""
    import ml_dtypes

    from libskylark_tpu.serve import journal as jjournal
    from libskylark_tpu_torch.serve import journal as tjournal

    rng = np.random.default_rng(5)
    host = rng.standard_normal((3, 7)) * 100
    if dtype == "bfloat16":
        j_arr = host.astype(ml_dtypes.bfloat16)
        t_arr = torch.from_numpy(host).to(torch.bfloat16)
    else:
        j_arr = host.astype(dtype)
        t_arr = torch.from_numpy(j_arr.copy())
    j_rec, t_rec = jjournal._enc_array(j_arr), tjournal._enc_array(t_arr)
    assert json.dumps(j_rec, sort_keys=True) == json.dumps(t_rec, sort_keys=True)
    back_t = tjournal._dec_array(j_rec)
    back_j = jjournal._dec_array(t_rec)
    assert str(back_t.dtype) == f"torch.{dtype}" and str(back_j.dtype) == dtype
    assert np.asarray(back_j).tobytes() == j_arr.tobytes()
    view = back_t.view(torch.int16) if dtype == "bfloat16" else back_t
    assert view.numpy().tobytes() == j_arr.tobytes()
