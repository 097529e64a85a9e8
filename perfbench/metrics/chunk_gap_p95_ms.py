"""Every gap between consecutive PCM chunks of a stream, both inside the
window, over every stream: the 95th percentile. A gap longer than the
0.5 s of audio a chunk carries is an audible stall."""

from perfbench.lib.stats import percentile


def read(ctx):
    t0, t1 = ctx.window
    gaps = []
    for r in ctx.records:
        ts = [t for t, _ in r["chunks"] if t0 <= t < t1]
        gaps.extend((b - a) * 1000.0 for a, b in zip(ts, ts[1:]))
    return percentile(gaps, 95)
