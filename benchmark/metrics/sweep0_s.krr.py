"""Seconds of each fit's first sweep (the Gram pass, its Cholesky factor
and the first update) from the solver's own PhaseTimer."""


def read(run):
    timer = getattr(run.driver, "timer", None)
    if timer is None or not timer.counts.get("sweep0"):
        return None
    return timer.totals["sweep0"] / timer.counts["sweep0"]
