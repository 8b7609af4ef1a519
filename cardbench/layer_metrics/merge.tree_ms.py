"""Device milliseconds a merge of every kernel launched inside the
benchmark's ``merge`` spans but the all-gather: the merge tree's sorts,
gathers and compaction."""


def value(run):
    tl = run.timeline
    merges = tl.spans_named("merge") if tl else []
    tree = [op.dur for op in tl.ops
            if op.kind == "kernel" and op.span == "merge" and "ring::gather_kernel" not in op.name] if tl else []
    return sum(tree) / len(merges) / 1e3 if merges and tree else None
