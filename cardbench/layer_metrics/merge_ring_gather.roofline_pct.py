"""The all-gather's share of its bound: ``(d + d^2) n 4`` bytes
(:func:`cardbench.bounds.gather_bound_ms`, n a shard's words of the merger's
leaves) over its mean device time a merge (one launch a merge)."""

from cardbench.bounds import gather_bound_ms


def value(run):
    ks = run.timeline.kernels("ring::gather_kernel") if run.timeline else []
    w = run.work
    if not ks or "gather_words" not in w:
        return None
    bound, _ = gather_bound_ms(w["ranks"], w["gather_words"])
    return 100.0 * bound / (sum(op.dur for op in ks) / len(ks) / 1e3)
