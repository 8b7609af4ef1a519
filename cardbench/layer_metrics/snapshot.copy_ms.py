"""Device milliseconds of the device-to-host copies launched inside the
benchmark's ``snapshot`` spans, a snapshot."""


def value(run):
    tl = run.timeline
    snaps = tl.spans_named("snapshot") if tl else []
    copies = [op.dur for op in tl.ops if op.kind == "memcpy" and op.span == "snapshot" and "DtoH" in op.name] if tl else []
    return sum(copies) / len(snaps) / 1e3 if snaps and copies else None
