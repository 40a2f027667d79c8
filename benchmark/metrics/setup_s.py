"""Set-up seconds: from the start of the process to the window, through
imports, kernel builds or loads, inputs made on the card and warm-up."""


def read(run):
    return run.setup_s
