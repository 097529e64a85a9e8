"""``csrc/decode_attention.cu``, pooled with an int8 prefix (kernel table
row 8): the least time of the pool's decode attention over the traced
stretch (each served request's int8 prefix and bf16 ring, at where its
cache stood at each step), over the device time of the pooled int8-prefix
instances of ``decode_kernel``; in percent."""

from perfbench.lib import trace, work


def _pooled_q(name):
    return "decode_kernel<" in name and "char, true, true>" in name


def read(ctx):
    span = ctx.stretch_span
    dev = trace.kernel_seconds(ctx.trace, _pooled_q)
    if span is None or not dev:
        return None
    a, b = span
    need = 0.0
    for s in ctx.obs.steps:
        if s["kind"] == "pool" and a <= s["t0"] and s["t1"] <= b:
            mid = (s["n"] - 1) / 2
            rows = [(p + mid, r + mid) for p, r in s["active"]]
            need += work.attention_decode_least_s(ctx.cfg["model"], rows, True) * s["n"]
    return 100.0 * need / dev if need else None
