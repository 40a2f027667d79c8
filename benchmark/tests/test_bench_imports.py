"""Nothing the benchmark runs loads JAX or the JAX package, the
reference takes nothing of the program, and a run keeps its files
inside the checkout and the directories it is given."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import env, registry

BENCH = registry.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "libskylark_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (whole names:
    the part before the first dot)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources(sub: str = "") -> list[Path]:
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts)


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_names_are_compared_whole():
    # The port's name begins with the JAX package's and passes.
    assert "libskylark_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    saved = dict(sys.modules)
    try:
        for name in ("libskylark_tpu_torch_fake", "jaxfake.x", "libskylark_tpu.core"):
            sys.modules[name] = object()
        found = env.forbidden_loaded()
        assert "libskylark_tpu.core" in found
        assert "libskylark_tpu_torch_fake" not in found and "jaxfake.x" not in found
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_the_reference_takes_nothing_of_the_program():
    for path in _sources("reference"):
        names = _imports(path)
        assert "libskylark_tpu_torch" not in names and not (names & FORBIDDEN), path
        text = path.read_text()
        assert "libskylark_tpu" not in text.replace("libskylark_tpu_torch", ""), path


def test_a_cpu_run_of_the_port_loads_no_jax():
    """A tiny rehearsal in a fresh process, then a look at sys.modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.tiny import run_tiny\n"
            "run_tiny('ls_sketch_fjlt', seconds=0.2)\n"
            "from benchmark.harness import env\n"
            "print('FOUND', env.forbidden_loaded())\n") % str(registry.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_no_fixed_temporary_paths_in_the_sources():
    for path in _sources():
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path


def test_caches_live_inside_the_checkout(monkeypatch):
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SKYLARK_POLICY_DIR", "/somewhere")
    env.prepare()
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        assert Path(os.environ[var]).is_relative_to(registry.REPO)
    assert "SKYLARK_POLICY_DIR" not in os.environ
    assert os.environ["SKYLARK_TELEMETRY"] == "0"


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "ls_sketch_fjlt",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
