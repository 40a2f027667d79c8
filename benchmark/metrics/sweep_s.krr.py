"""Seconds per refinement sweep (sweeps after the first) of the
window's fits, from the solver's own PhaseTimer (one synchronize per
sweep)."""


def read(run):
    timer = getattr(run.driver, "timer", None)
    if timer is None or not timer.counts.get("sweep"):
        return None
    return timer.totals["sweep"] / timer.counts["sweep"]
