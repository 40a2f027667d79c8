"""Device-idle ms a solve put down to the counter stream: the idle time
in which the innermost program span open on the host is a ``random.*``
span (a draw, eager or while a plan is captured), over the solves of the
cell's span stretch (``harness/spans.py``)."""

from benchmark.harness import spans


def read(run):
    got = spans.read(run)
    return None if got is None else got.per_solve("idle_ms", ("random.",))
