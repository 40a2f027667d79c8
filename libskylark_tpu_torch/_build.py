"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/``
(next to the package, listed in ``.gitignore``), then loaded with
ctypes.  The library's file name carries a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so a rebuild happens only
when one of them changes.  Nothing here
runs at import: a library is built at its first use, or by
:func:`build_all`, which starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "nvcc_command", "library_path",
           "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("rfut", "window", "scatter")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process, tmp_path, final_path)`` or None."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(name, Path(tmp)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, Path(tmp), final


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, final = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            + out.decode(errors="replace")
        )
    # Atomic publish: concurrent builds of the same source agree.
    os.replace(tmp, final)


def build_all() -> float:
    """Build every kernel library (one nvcc per source, all started
    together); returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        _finish(name, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use.
    Callers set ``argtypes``/``restype`` on the functions they call."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
