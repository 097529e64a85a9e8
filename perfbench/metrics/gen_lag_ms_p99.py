"""How late the load generator sent each request due in the window,
against its due time: the 99th percentile (open loops only)."""

from perfbench.lib.stats import percentile


def read(ctx):
    if ctx.mix["loop"] != "open":
        return None
    t0, t1 = ctx.window
    return percentile([(r["sent"] - r["due"]) * 1000.0 for r in ctx.records
                       if t0 <= r["due"] < t1], 99)
