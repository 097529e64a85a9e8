"""The time a segment's device waited on the host: per ``pool_segment`` or
``stream_segment`` span, its wall time less the device time of the device
spans under it (the ``replay`` and ``flush`` of its steps, the emit or the
vocoder, a stream's prefill at its first segment, a finished row's tail
vocoded), the mean over the traced stretch's segments. What lies between
those spans is the host's: the stop test's reads, the host reads of the
emit or the audio, the hand-off of chunks. A host stall inside a device
span (the launch gaps of an eager program such as the emit) counts as
that span's device time. None without device time."""

from perfbench.lib import spans as S


def read(ctx):
    rec = S.recorded(ctx)
    if rec is None:
        return None
    per = []
    for seg in S.inside(rec, *S.SEGMENTS):
        dev = S.device_ms(S.topmost(rec, seg, lambda s: s["device"]))
        if dev is None:
            return None
        per.append((seg["t1"] - seg["t0"]) / 1e6 - dev)
    return sum(per) / len(per) if per else None
