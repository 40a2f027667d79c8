"""Share of the traced stretch of a least-squares window in which no
kernel, copy or set ran on the card."""


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    return run.trace.idle_pct
