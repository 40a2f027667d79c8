"""Device-idle ms a solve put down to LSQR: the idle time in which the
innermost program span open on the host is an ``lsqr.*`` span (its
set-up, its step's capture, each chunk with its convergence read), over
the solves of the cell's span stretch (``harness/spans.py``)."""

from benchmark.harness import spans


def read(run):
    got = spans.read(run)
    return None if got is None else got.per_solve("idle_ms", ("lsqr.",))
