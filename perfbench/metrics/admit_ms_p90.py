"""Admission into the pool (conditioning, the request's prefill, the
join) as the worker lives it, from the ``pool_admit`` events logged in the
window; the 90th percentile."""

from perfbench.lib.stats import percentile


def read(ctx):
    ev = ctx.obs.events_named("pool_admit", *ctx.window)
    return percentile([e["admit_ms"] for e in ev], 90)
