"""Admission into the pool as a share of the window: the ``admit_ms`` of
the ``pool_admit`` events logged in the window (the request's
conditioning, prefill and join, during which no pool segment runs), over
the window's length; in percent. None without such an event."""


def read(ctx):
    ev = ctx.obs.events_named("pool_admit", *ctx.window)
    if not ev:
        return None
    t0, t1 = ctx.window
    return 100.0 * sum(e["admit_ms"] for e in ev) / 1e3 / (t1 - t0)
