"""One pool segment (its steps, then the emit program and its host read:
``steps_ms + read_ms`` of the ``pool_segment`` events, which together end
on a device read), the mean over the segments logged in the window."""


def read(ctx):
    ev = ctx.obs.events_named("pool_segment", *ctx.window)
    if not ev:
        return None
    return sum(e["steps_ms"] + e["read_ms"] for e in ev) / len(ev)
