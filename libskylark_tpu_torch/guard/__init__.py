"""Numerical-health guard layer (port of ``libskylark_tpu/guard``):
sentinels, sketch certification and the recovery ladder, under the JAX
package's environment knobs (``SKYLARK_GUARD``,
``SKYLARK_GUARD_MAX_RETRIES``, ``SKYLARK_GUARD_COND_MAX``).

- :mod:`.sentinels` — finiteness probes, one host read per check;
- :mod:`.certify` — ``cond_est``/posterior-residual certificates,
  verdicts ``OK | RESKETCH | FALLBACK``;
- :mod:`.ladder` — fresh-seed resketch → grown sketch → exact dense
  solve, every attempt in a :class:`RecoveryReport`.
"""

from ..utils.exceptions import NumericalHealthError
from .certify import (
    FALLBACK,
    OK,
    RESKETCH,
    Certificate,
    certify_sketch,
    certify_svd,
    pinv_psd_solve,
)
from .config import GROWTH_FACTOR, cond_max, enabled, max_retries
from .ladder import RecoveryAttempt, RecoveryReport, derived_context, run_ladder
from .sentinels import check_finite, finite_probe, tree_all_finite

__all__ = [
    "NumericalHealthError",
    "OK",
    "RESKETCH",
    "FALLBACK",
    "Certificate",
    "certify_sketch",
    "certify_svd",
    "pinv_psd_solve",
    "enabled",
    "max_retries",
    "cond_max",
    "GROWTH_FACTOR",
    "RecoveryAttempt",
    "RecoveryReport",
    "derived_context",
    "run_ladder",
    "finite_probe",
    "tree_all_finite",
    "check_finite",
]
