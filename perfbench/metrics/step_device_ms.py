"""One decode step on the device: per ``steps`` span (a pool segment's or a
stream segment's steps) the device time of the device spans under it (the
``replay`` of each run of steps and the ring or stage ``flush``, from CUDA
events at their ends; the stop test's reads between them are host time),
over the steps it ran, in the traced stretch; None without device time."""

from perfbench.lib import spans as S


def read(ctx):
    rec = S.recorded(ctx)
    if rec is None:
        return None
    dev, n = 0.0, 0
    for st in S.inside(rec, "steps"):
        if not st["attrs"].get("n"):
            continue
        ms = S.device_ms(S.topmost(rec, st, lambda s: s["device"]))
        if ms is None:
            return None
        dev, n = dev + ms, n + st["attrs"]["n"]
    return dev / n if n else None
