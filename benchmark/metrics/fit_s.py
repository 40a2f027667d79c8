"""Seconds per fit: the window's length over the fits it completed
(closed loop, one caller)."""


def read(run):
    w = run.window
    return w.seconds / w.count if w.count else None
