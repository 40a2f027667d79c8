"""CUDA graphs captured a solve: the ``plans.capture``, ``cond_est.capture``
and ``lsqr.capture`` spans (a sketch plan, the guard's certificate sweep,
LSQR's step) over the solves of the cell's span stretch
(``harness/spans.py``)."""

from benchmark.harness import spans

CAPTURES = ("plans.capture", "cond_est.capture", "lsqr.capture")


def read(run):
    got = spans.read(run)
    if got is None:
        return None
    return sum(got.spans.get(name, {"calls": 0})["calls"] for name in CAPTURES) / got.requests
