"""The share of the traced stretch in which no operation ran on the
device: one less the union of the profiler's device intervals over the
stretch's length; in percent."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
