"""The routing decision of the port (port of the default-decision part
of ``libskylark_tpu/policy``).

Routed entry points (``linalg.approximate_least_squares``,
``linalg.streaming_least_squares``, ``ml.approximate_kernel_ridge``)
call :func:`consult` once per solve and write the decision into
``info["policy"]``.  Caller-pinned fields win; every other field is the
JAX package's default decision, which is also what it returns with an
empty profile store or under ``SKYLARK_POLICY=0``.

The profile store, ``observe``/``flush``, the bf16/fp8-first rungs and
warm start wait for ROADMAP Queue A item 3b: until then no decision
reads or writes a store, and ``source`` is always ``"default"``.
"""

from .decide import LS_ROUTES, Decision, ProblemSignature, choose_route
from .profile import profile_key, shape_class
from .record import consult

__all__ = [
    "LS_ROUTES",
    "Decision",
    "ProblemSignature",
    "choose_route",
    "profile_key",
    "shape_class",
    "consult",
]
