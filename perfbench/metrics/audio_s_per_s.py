"""Seconds of PCM (16-bit samples / 44100) that clients received inside
the window, over the window's seconds: every chunk whose last byte arrived
in the window counts, whatever request it belongs to."""


def read(ctx):
    t0, t1 = ctx.window
    got = sum(n for r in ctx.records for t, n in r["chunks"] if t0 <= t < t1)
    return got / 2 / 44100 / (t1 - t0)
