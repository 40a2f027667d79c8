"""Import hygiene of the PyTorch/CUDA port: no module of
``libskylark_tpu_torch`` and not ``chip_smoke.py`` imports ``jax``,
``ml_dtypes`` (the chip machine has no such package) or anything of the
JAX package ``libskylark_tpu`` (checked on the AST, so imports inside
functions count too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "libskylark_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "libskylark_tpu", "ml_dtypes")


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_found():
    names = {p.name for p in FILES}
    assert {"__init__.py", "random.py", "fjlt.py", "hash.py", "kernels_scatter.py",
            "stream.py", "chip_smoke.py", "dense.py", "rft.py", "rlt.py", "frft.py",
            "ppt.py", "kernels.py", "distances.py", "coding.py", "metrics.py",
            "model.py", "flagship.py", "matrices.py", "chunked.py", "precond.py",
            "krylov.py", "cond_est.py", "config.py", "sentinels.py", "certify.py",
            "ladder.py", "svd.py", "accelerated.py", "regression.py", "timer.py",
            "prox.py", "sampling.py", "krr.py", "rlsc.py", "admm.py", "nonlinear.py",
            "checkpoint.py", "faults.py", "runner.py", "pipeline.py", "overlap.py",
            "engine.py", "drivers.py", "quasirand.py", "quasi.py", "spectral.py", "deps.py",
            "community.py", "ase.py", "refine.py", "decide.py", "profile.py",
            "record.py", "source.py", "libsvm.py", "hdf5.py", "arclist.py", "common.py",
            "linear.py", "graph_se.py", "convert2hdf5.py", "profiling.py", "registry.py",
            "ledger.py", "spans.py", "trace.py", "slo.py", "timeline.py", "exposition.py",
            "fleet.py", "phases.py", "report.py", "gauss_seidel.py", "asynch.py",
            "protocol.py", "qos.py", "admission.py", "cache.py", "journal.py", "dispatch.py",
            "batcher.py", "server.py", "transport.py", "client.py", "router.py",
            "autoscale.py", "serve.py", "top.py"} <= names
    telemetry = {p.name for p in FILES if p.parent.name == "telemetry"}
    assert len(telemetry) == 12, sorted(telemetry)
    serve = {p.name for p in FILES if p.parent.name == "serve"}
    assert len(serve) == 14, sorted(serve)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [name for name in _imported(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
