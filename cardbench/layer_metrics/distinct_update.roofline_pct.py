"""The distinct kernel's share of its bound: the bound of its mean launch's
work (:func:`cardbench.bounds.distinct_bound_ms`, the inserts counted from
the states before and after the traced tiles) over its mean device time a
launch."""

from cardbench.bounds import distinct_bound_ms


def value(run):
    ks = run.timeline.kernels("dst::update_kernel") if run.timeline else []
    w = run.work
    if not ks or "inserts" not in w:
        return None
    n = w["launches"]
    bound, _ = distinct_bound_ms(w["lanes"], w["inserts"] / n, w["rows_inserting"] / n, w["rows"], w["k"])
    return 100.0 * bound / (sum(op.dur for op in ks) / len(ks) / 1e3)
