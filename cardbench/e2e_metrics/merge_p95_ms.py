"""The 95th percentile over every merge of the window: the time from the
stream merger's call to the merged leaves on the host."""

from cardbench.stats import percentile


def value(run):
    return percentile(run.record.get("merge_ms", []), 95)
