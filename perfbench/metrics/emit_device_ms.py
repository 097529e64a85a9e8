"""A segment's vocoder on the device: per pool segment the device time of
its ``emit`` program, per stream segment of its ``vocode`` DAC calls; the
mean over the traced stretch's segments that ran one. None without device
time."""

from perfbench.lib import spans as S


def read(ctx):
    rec = S.recorded(ctx)
    if rec is None:
        return None
    per = []
    for seg in S.inside(rec, *S.SEGMENTS):
        ran = S.topmost(rec, seg, lambda s, name=S.SEGMENTS[seg["name"]]: s["name"] == name)
        ms = S.device_ms(ran) if ran else None
        if ms is not None:
            per.append(ms)
    return sum(per) / len(per) if per else None
