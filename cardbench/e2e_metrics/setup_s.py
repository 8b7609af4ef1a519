"""Set-up seconds: from the process's start to the window's (import, the
kernels' build or load, the engines, the inputs made on the card, the
warm-up)."""


def value(run):
    return run.record.get("setup_s")
