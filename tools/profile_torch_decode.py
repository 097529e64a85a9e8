#!/usr/bin/env python3
"""Where the PyTorch port's decode time goes on one NVIDIA GPU.

    python3 tools/profile_torch_decode.py [steps] [--paths bf16,int8,hybrid]

For each path (default: all three), the flagship's solo decode (random
weights, CFG batch 2) through ``DecodeEngine.generate`` for ``steps``
decode steps (default 64), twice under ``torch.profiler``: eagerly
(``cuda_graphs=False``) and replaying one captured CUDA graph per step (the
default on the card). ``bf16`` and ``int8`` are the transformer (``int8``:
``quantize_zonos_params`` weights and ``kv_int8``), ``hybrid`` the Mamba-2
hybrid. For each run it reports, over the generate call: host wall time per
decode step, the device's busy time per step and its idle share (the union
of device activity intervals over the wall time), device activities
(kernels, copies, fills) per step, which for the graph run are the nodes a
replayed step runs, and the kernels that take the most device time. For
the graph run it also reports the same figures over the replayed steps
alone (the device events after the capture's idle gap). Writes the full
tables to ``build/profile_torch_decode.json``, prints a summary;
the last line is one JSON object. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TEXT = "It would be nice to have time for testing, indeed."


def merged(events) -> list[list[float]]:
    """The events' device intervals merged where they overlap, in order."""
    out = []
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def replay_window(events) -> tuple[float, float, int]:
    """``(busy us, window us, device activities)`` after the timeline's
    longest idle gap. In a graph run that gap is the capture (the host
    records the graph while the device waits), so what follows is the
    replayed steps and the finalize."""
    spans = merged(events)
    gaps = [spans[i + 1][0] - spans[i][1] for i in range(len(spans) - 1)]
    cut = spans[gaps.index(max(gaps)) + 1][0] if gaps else spans[0][0]
    after = [x for x in spans if x[0] >= cut]
    busy = sum(e - s for s, e in after)
    return busy, after[-1][1] - cut, sum(1 for e in events if e.time_range.start >= cut)


def profile_run(engine, params, prefix, steps_wanted: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(max_new_tokens=steps_wanted - 9 + 1, disable_eos=True)  # steps = mnt + 9 - 1
    engine.generate(params, prefix, generator=torch.Generator("cuda").manual_seed(1), **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.generate(params, prefix, generator=torch.Generator("cuda").manual_seed(421),
                              **kw)
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    table = sorted(({"kernel": k, "launches": n, "device_us": us} for k, (n, us) in by_name.items()),
                   key=lambda r: -r["device_us"])
    steps = res.steps
    busy = sum(e - s for s, e in merged(device))
    out = {
        "decode_steps": steps, "generate_wall_ms": wall_us / 1e3,
        "decode_ms_per_step_host": res.decode_seconds * 1e3 / steps,
        "capture_ms": res.capture_seconds * 1e3, "replays": res.replays,
        "host_reads": res.host_reads, "prefill_ms": res.prefill_seconds * 1e3,
        "device_busy_ms": busy / 1e3 if device else None,
        "device_busy_ms_per_step": busy / 1e3 / steps if device else None,
        "device_idle_share": 1 - busy / wall_us if device else None,
        "device_activities_per_step": len(device) / steps if device else None,
        "top_kernels": table[:12], "all": table,
    }
    if res.replays and device:
        r_busy, r_window, r_events = replay_window(device)
        out.update(replay_busy_ms_per_step=r_busy / 1e3 / res.replays,
                   replay_idle_share=1 - r_busy / r_window,
                   device_activities_per_replay=r_events / res.replays)
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("steps", nargs="?", type=int, default=64)
    parser.add_argument("--paths", default="bf16,int8,hybrid")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from zonos_vibes_tpu_torch.config import ZONOS_V01_HYBRID, ZONOS_V01_TRANSFORMER
    from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
    from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    paths = args.paths.split(",")
    runs, pipe = {}, None
    for path in paths:
        if path not in ("bf16", "int8", "hybrid"):
            raise SystemExit(f"unknown path {path!r}")
        config = ZONOS_V01_HYBRID if path == "hybrid" else ZONOS_V01_TRANSFORMER
        if pipe is None or pipe.model.config != config:
            pipe = None
            torch.cuda.empty_cache()
            pipe = ZonosPipeline.from_config(config, device="cuda",
                                             generator=torch.Generator("cuda").manual_seed(421))
        prefix = pipe.prepare_conditioning(pipe.make_cond_dict(text=TEXT))
        params = quantize_zonos_params(pipe.params) if path == "int8" else pipe.params
        for graphs in (False, True):
            engine = DecodeEngine(pipe.model, kv_int8=path == "int8", cuda_graphs=graphs)
            run = profile_run(engine, params, prefix, args.steps)
            name = f"{path}_{'graph' if graphs else 'eager'}"
            runs[name] = run
            if run["device_busy_ms"] is None:
                print(f"{name}: device time not measured (the profiler recorded no device "
                      f"activity)")
                continue
            print(f"{card}: {name}: {run['decode_steps']} decode steps, host "
                  f"{run['decode_ms_per_step_host']:.3f} ms/step (capture "
                  f"{run['capture_ms']:.1f} ms, {run['replays']} replays, {run['host_reads']} "
                  f"host reads), device busy {run['device_busy_ms']:.2f} of "
                  f"{run['generate_wall_ms']:.2f} ms ({run['device_busy_ms_per_step']:.4f} ms "
                  f"per step, idle share {run['device_idle_share']:.3f}), "
                  f"{run['device_activities_per_step']:.1f} device activities per step")
            if "replay_idle_share" in run:
                print(f"  replayed steps: device busy {run['replay_busy_ms_per_step']:.4f} ms "
                      f"per step, idle share {run['replay_idle_share']:.3f}, "
                      f"{run['device_activities_per_replay']:.1f} device activities per replay "
                      f"(the finalize's few included)")
            for r in run["top_kernels"][:8]:
                print(f"    {r['device_us'] / 1e3:9.3f} ms  {r['launches']:7d}x  {r['kernel'][:100]}")
        del params
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "profile_torch_decode.json").write_text(json.dumps({"card": card, "runs": runs},
                                                              indent=1))
    print(json.dumps({"card": card, "runs": {
        name: {k: v for k, v in run.items() if k not in ("top_kernels", "all")}
        for name, run in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
