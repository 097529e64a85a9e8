"""Time from a request's due time to its first PCM byte, the 90th
percentile over every request due in the window; a request that failed or
brought no audio before the grace ran out counts at the grace's end."""

from perfbench.lib.stats import percentile


def read(ctx):
    t0, t1 = ctx.window
    lat = []
    for r in ctx.records:
        if not t0 <= r["due"] < t1:
            continue
        first = r["chunks"][0][0] if r["chunks"] and r["status"] == 200 else ctx.give_up_at
        lat.append((first - r["due"]) * 1000.0)
    return percentile(lat, 90)
