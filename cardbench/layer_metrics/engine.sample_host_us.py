"""The host's microseconds inside ``ReservoirEngine.sample`` a call: the
benchmark's ``sample`` spans over the traced window, summed, over their
number."""


def value(run):
    spans = run.timeline.spans_named("sample") if run.timeline else []
    return sum(s.dur for s in spans) / len(spans) if spans else None
