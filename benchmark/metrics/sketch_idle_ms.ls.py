"""Device-idle ms a solve put down to the sketch layer itself: the idle
time in which the innermost program span open on the host is a
``sketch.*`` span (the apply outside its plans' captures and replays and
its counter-stream draws), over the solves of the cell's span stretch
(``harness/spans.py``)."""

from benchmark.harness import spans


def read(run):
    got = spans.read(run)
    return None if got is None else got.per_solve("idle_ms", ("sketch.",))
