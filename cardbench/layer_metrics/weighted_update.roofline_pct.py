"""The weighted kernel's share of its bound: the bound of its mean launch's
work (:func:`cardbench.bounds.weighted_bound_ms`, the accepts and fills
counted from the states before and after the traced tiles) over its mean
device time a launch."""

from cardbench.bounds import weighted_bound_ms


def value(run):
    ks = run.timeline.kernels("wtd::update_kernel") if run.timeline else []
    w = run.work
    if not ks or "accepts" not in w:
        return None
    n = w["launches"]
    bound, _ = weighted_bound_ms(w["accepts"] / n, w["fills"] / n, w["lanes"], w["rows"], w["k"])
    return 100.0 * bound / (sum(op.dur for op in ks) / len(ks) / 1e3)
