"""The server's queue: enqueue to admission into the pool, from its
``pool_admit`` events logged in the window; the 90th percentile."""

from perfbench.lib.stats import percentile


def read(ctx):
    ev = ctx.obs.events_named("pool_admit", *ctx.window)
    return percentile([e["queue_wait_ms"] for e in ev], 90)
