"""The process around a run: cache directories inside the checkout, the
program's knobs, the look for a card, and the check that nothing of JAX
was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

from .registry import REPO

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "libskylark_tpu")

CACHE_DIR = REPO / "build" / "bench"


def prepare() -> None:
    """Fix every cache at a path inside the checkout and pin the program's
    knobs; called before torch or the program is imported.  The kernel
    libraries already live in ``build/kernels`` (the program's own rule).
    Telemetry stays off and no policy store is configured, so no learned
    state carries from one run to the next."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["SKYLARK_TELEMETRY"] = "0"
    os.environ.pop("SKYLARK_TELEMETRY_DIR", None)
    os.environ.pop("SKYLARK_POLICY_DIR", None)
    # One host thread: on an 8-core H100 host the least-squares solves ran
    # slower and spread wider from run to run with four.
    os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``libskylark_tpu_torch`` is not ``libskylark_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def card_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
