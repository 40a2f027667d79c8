"""Milliseconds per solve: the window's length over the solves it
completed (closed loop, one caller)."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / w.count if w.count else None
