"""Elements per second: every element of every tile dispatched in the
window (all complete at its closing synchronise) over the window's seconds."""


def value(run):
    r = run.record
    return r["elements"] / r["window_s"] if "elements" in r else None
