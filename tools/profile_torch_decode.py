#!/usr/bin/env python3
"""Where the PyTorch port's decode time goes on one NVIDIA GPU.

    python3 tools/profile_torch_decode.py [steps]

Runs the flagship transformer (random bf16 weights, CFG batch 2) through
``ZonosPipeline.generate`` for ``steps`` decode steps (default 64) under
``torch.profiler`` and reports, for the generate call: host wall time per
decode step, the device's busy and idle share (the union of kernel
intervals over the wall time), kernel launches per step, and the kernels
that take the most device time. Writes the full table to
``build/profile_torch_decode.json`` and prints a summary; the last
line is one JSON object. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from zonos_vibes_tpu_torch.config import ZONOS_V01_TRANSFORMER
    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

    steps_wanted = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    pipe = ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(421))
    cond = pipe.make_cond_dict(text="It would be nice to have time for testing, indeed.")
    pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(1), max_new_tokens=8,
                  disable_eos=True)
    max_new = steps_wanted - 9 + 1  # decode steps = max_new_tokens + 9 - 1

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(421),
                            max_new_tokens=max_new, disable_eos=True)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy = 0.0
    cur_start, cur_end = None, None
    for s, e in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    table = sorted(({"kernel": k, "launches": n, "device_us": us} for k, (n, us) in by_name.items()),
                   key=lambda r: -r["device_us"])
    steps = res.steps
    summary = {
        "card": card, "decode_steps": steps,
        "generate_wall_ms": wall_us / 1e3,
        "decode_ms_per_step_host": res.decode_seconds * 1e3 / steps,
        "prefill_ms": res.prefill_seconds * 1e3,
        "device_busy_ms": busy / 1e3 if kernels else None,
        "device_idle_share": 1 - busy / wall_us if kernels else None,
        "kernel_launches_per_step": len(kernels) / steps if kernels else None,
        "top_kernels": table[:12],
    }
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_decode.json").write_text(json.dumps({**summary, "all": table}, indent=1))
    if not kernels:
        print("device time: not measured (the profiler recorded no CUDA kernels)")
    else:
        print(f"{card}: {steps} decode steps, host {summary['decode_ms_per_step_host']:.3f} "
              f"ms/step, device busy {busy / 1e3:.1f} of {wall_us / 1e3:.1f} ms "
              f"(idle share {summary['device_idle_share']:.3f}), "
              f"{summary['kernel_launches_per_step']:.0f} kernel launches per step")
        for r in table[:12]:
            print(f"  {r['device_us'] / 1e3:9.3f} ms  {r['launches']:7d}x  {r['kernel'][:110]}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
