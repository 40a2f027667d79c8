"""Runtime knobs of the numerical-health guard layer (port of
``libskylark_tpu/guard/config.py``), read per call from the environment
under the JAX package's names:

- ``SKYLARK_GUARD`` — ``0``/``false`` turns the guard off: no
  sentinels, no certification, no ladder.
- ``SKYLARK_GUARD_MAX_RETRIES`` — ladder rungs after the initial
  attempt (default 2: one fresh-seed resketch and one grown resketch)
  before the dense fallback.
- ``SKYLARK_GUARD_COND_MAX`` — certification ceiling on the estimated
  condition number of a sketch output; default the Blendenpik retry
  threshold ``0.1/sqrt(eps)`` of the certified dtype.
"""

from __future__ import annotations

import os

import torch

__all__ = ["enabled", "max_retries", "cond_max", "GROWTH_FACTOR"]

# Geometric sketch-dimension growth per ladder rung (Blendenpik doubles
# gamma on a retry; the ladder keeps the same factor).
GROWTH_FACTOR = 2.0


def enabled() -> bool:
    """Guarding is on unless ``SKYLARK_GUARD=0`` (checked per call)."""
    return os.environ.get("SKYLARK_GUARD", "").lower() not in ("0", "false")


def max_retries(default: int = 2) -> int:
    """Ladder retries after the initial attempt (≥ 0)."""
    raw = os.environ.get("SKYLARK_GUARD_MAX_RETRIES")
    if raw is None:
        return default
    return max(0, int(raw))


def cond_max(dtype=None) -> float:
    """Certification ceiling for cond(sketch output)."""
    raw = os.environ.get("SKYLARK_GUARD_COND_MAX")
    if raw is not None:
        return float(raw)
    eps = torch.finfo(dtype or torch.float64).eps
    return 0.1 / eps**0.5
