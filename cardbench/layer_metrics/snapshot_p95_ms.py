"""The 95th percentile over every snapshot of the traced window: the time
from the ``peek_arrays()`` call, made while tiles are in flight, to its host
arrays.  A snapshot drains the tiles in flight, so its time is the
window's: it moves ``elems_per_s``."""

from cardbench.stats import percentile


def value(run):
    return percentile(run.record.get("snapshot_ms", []), 95)
