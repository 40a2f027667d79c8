"""``consult``: the one call every routed entry point makes (port of
``libskylark_tpu/policy/record.py``'s ``consult``, without its telemetry
counters, which wait for ROADMAP Queue A item 10)."""

from __future__ import annotations

import torch

from .decide import Decision, ProblemSignature, choose_route

__all__ = ["consult"]


def _dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype (``"float32"``,
    ``"bfloat16"``), as the JAX package's keys spell it."""
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else str(dtype)


def _backend_name(device) -> str:
    """``"gpu"`` for a CUDA device (what ``jax.default_backend()`` names
    an NVIDIA card), ``"cpu"`` otherwise."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def consult(kind: str, *, m: int, n: int, targets: int = 1, dtype, sparse: bool = False,
            device="cpu", route: str | None = None, sketch_type: str | None = None,
            sketch_size: int | None = None) -> Decision:
    """Build the problem's signature on ``device`` and decide."""
    sig = ProblemSignature(kind=kind, m=int(m), n=int(n), targets=int(targets),
                           dtype=_dtype_name(dtype), sparse=bool(sparse),
                           backend=_backend_name(device))
    return choose_route(sig, route=route, sketch_type=sketch_type, sketch_size=sketch_size)
