"""``csrc/qmm_int8.cu``: the least time of the int8 projections the traced
stretch needed (every decode step at its computed rows, every prefill at
its rows; ``perfbench/lib/work.py``), over the device time of the kernels
named ``qmm_int8*``; in percent."""

from perfbench.lib import trace, work


def read(ctx):
    span = ctx.stretch_span
    if span is None or ctx.cfg["serving"]["weights"] != "int8":
        return None
    dev = trace.kernel_seconds(ctx.trace, lambda k: "qmm_int8" in k)
    if not dev:
        return None
    a, b = span
    need = sum(work.qmm_int8_least_s(ctx.cfg["model"], s["rows"]) * s["n"]
               for s in ctx.obs.steps if a <= s["t0"] and s["t1"] <= b and s["rows"])
    need += sum(work.qmm_int8_least_s(ctx.cfg["model"], rows * seq)
                for t, rows, seq in ctx.obs.prefills if a <= t <= b)
    return 100.0 * need / dev
