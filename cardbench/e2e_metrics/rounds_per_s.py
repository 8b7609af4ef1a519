"""Rounds per second: completed rounds (a tile into every shard, then one
merge to the host) over the window's seconds."""


def value(run):
    r = run.record
    return r["rounds"] / r["window_s"] if "rounds" in r else None
