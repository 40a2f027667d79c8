"""LSQR iterations per solve over every solve of the window that ran
LSQR (Blendenpik and LSRN)."""


def read(run):
    its = [int(r["info"]["iterations"]) for r in run.window.records
           if "info" in r and "iterations" in r["info"]]
    return sum(its) / len(its) if its else None
