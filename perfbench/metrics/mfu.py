"""The decode steps' share of the chip's bf16 peak over the traced
stretch: matrix-multiply FLOPs of every decode step run in it (counted from
the configuration, over the CFG rows of the requests each step served),
over the stretch's wall time times 989 TFLOP/s; in percent."""

from perfbench.lib import work


def read(ctx):
    span = ctx.stretch_span
    if span is None:
        return None
    a, b = span
    flops = sum(work.step_flops(ctx.cfg["model"], 2 * len(s["active"])) * s["n"]
                for s in ctx.obs.steps if a <= s["t0"] and s["t1"] <= b and s["active"])
    return 100.0 * flops / ((b - a) * work.BF16_FLOPS) if flops else None
