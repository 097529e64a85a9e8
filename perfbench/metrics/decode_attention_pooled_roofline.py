"""``csrc/decode_attention.cu``, pooled with a bf16 prefix (kernel table
row 6): the least time of the pool's decode attention over the traced
stretch (each served request's bf16 prefix and ring, at where its cache
stood at each step), over the device time of the pooled bf16 instances of
``decode_kernel``; in percent."""

from perfbench.lib import trace, work


def _pooled(name):
    return "decode_kernel<" in name and "bfloat16, true, true>" in name


def read(ctx):
    span = ctx.stretch_span
    dev = trace.kernel_seconds(ctx.trace, _pooled)
    if span is None or not dev:
        return None
    a, b = span
    need = 0.0
    for s in ctx.obs.steps:
        if s["kind"] == "pool" and a <= s["t0"] and s["t1"] <= b:
            mid = (s["n"] - 1) / 2
            rows = [(p + mid, r + mid) for p, r in s["active"]]
            need += work.attention_decode_least_s(ctx.cfg["model"], rows, False) * s["n"]
    return 100.0 * need / dev if need else None
