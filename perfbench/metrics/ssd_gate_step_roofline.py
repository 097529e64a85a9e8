"""``csrc/mamba_step.cu`` (kernel table rows 9 and 10): the least time of
the fused Mamba-2 steps over the traced stretch, the pool's and the job
path's (each served request's state read and written, with its inputs and
output), over the device time of ``ssd_step_kernel``; in percent."""

from perfbench.lib import trace, work


def read(ctx):
    span = ctx.stretch_span
    dev = trace.kernel_seconds(ctx.trace, lambda k: "ssd_step_kernel" in k)
    if span is None or not dev:
        return None
    a, b = span
    state = 2 if ctx.cfg["serving"].get("pool_state_bf16") else 4
    # A solo stream's state is fp32 whatever the pool stores.
    need = sum(work.ssd_step_least_s(ctx.cfg["model"], len(s["active"]),
                                     state if s["kind"] == "pool" else 4) * s["n"]
               for s in ctx.obs.steps if a <= s["t0"] and s["t1"] <= b and s["active"])
    return 100.0 * need / dev if need else None
