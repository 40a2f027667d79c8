"""Sketches tried per solve by the guard's ladder or Blendenpik's retry
loop, the dense fallback counted as one more (1.0: no wasted retry),
over every solve of the window."""


def read(run):
    tries = [len(r["info"]["recovery"]["attempts"]) for r in run.window.records
             if "info" in r and r["info"]["recovery"].get("guarded")]
    return sum(tries) / len(tries) if tries else None
