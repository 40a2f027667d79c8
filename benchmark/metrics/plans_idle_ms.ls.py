"""Device-idle ms a solve put down to the plans layer: the idle time in
which the innermost program span open on the host is a ``plans.*`` span
(a sketch plan's capture, or a call's copy-in, replay and copy-out),
over the solves of the cell's span stretch (``harness/spans.py``)."""

from benchmark.harness import spans


def read(run):
    got = spans.read(run)
    return None if got is None else got.per_solve("idle_ms", ("plans.",))
