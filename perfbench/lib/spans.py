"""The program's spans (``zonos_vibes_tpu_torch/utils/tracing``) over a
run, for the readers of the ``program_span`` metrics.

The recorder keeps spans while it is switched on, or while a
``torch.profiler`` session runs in the process: in a traced run, over the
traced stretch. A reader takes the spans of the part of the window in
which they were kept (all of it when the recorder was switched on, else
the stretch), and finds nothing, so returns None, where the program keeps
none (a version without the recorder, or an untraced run)."""

from __future__ import annotations

from types import SimpleNamespace

SEGMENTS = {"pool_segment": "emit", "stream_segment": "vocode"}  # segment -> its vocoder span


def recorded(ctx):
    """``SimpleNamespace(spans, lo, hi, kids)``: the spans that overlap
    ``[lo, hi)`` (monotonic ns), the part of the window in which they were
    kept, and the spans by parent id; None without any."""
    try:
        from zonos_vibes_tpu_torch.utils import tracing
    except ImportError:
        return None
    read = getattr(tracing, "spans", None)
    if read is None:
        return None
    lo, hi = ctx.window
    if not tracing.enabled():
        kept = getattr(ctx, "stretch_span", None)
        if kept is None:
            return None
        lo, hi = max(lo, kept[0]), min(hi, kept[1])
    lo, hi = int(lo * 1e9), int(hi * 1e9)
    got = read(lo, hi) if hi > lo else []
    if not got:
        return None
    kids: dict = {}
    for s in got:
        kids.setdefault(s["parent"], []).append(s)
    return SimpleNamespace(spans=got, lo=lo, hi=hi, kids=kids)


def inside(rec, *names: str) -> list[dict]:
    """The spans of these names that lie wholly in the kept part."""
    return [s for s in rec.spans
            if s["name"] in names and s["t0"] >= rec.lo and s["t1"] <= rec.hi]


def topmost(rec, span: dict, pick) -> list[dict]:
    """The spans under ``span`` that ``pick`` accepts, none of them under
    another (a device span's own descendants are inside its time)."""
    out = []
    for k in rec.kids.get(span["id"], ()):
        out += [k] if pick(k) else topmost(rec, k, pick)
    return out


def device_ms(spans: list[dict]) -> float | None:
    """Their device milliseconds together; None if one has none (the CPU)."""
    if any(s["device_ms"] is None for s in spans):
        return None
    return sum(s["device_ms"] for s in spans)
