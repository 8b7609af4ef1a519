"""The share of the traced window in which no kernel or copy ran on the
card, in an ingest cell."""


def value(run):
    return run.timeline.idle_pct() if run.timeline else None
