#!/usr/bin/env python3
"""Does a process's first ``torch.profiler`` session see the device kernels
launched in it?

    python3 tools/profiler_first_session.py [--after-phase2]

Builds the port's kernels, optionally runs ``chip_smoke.py``'s phase-2
kernel checks first in its order (``--after-phase2``), then profiles one
call of ``qmm_int8`` (in_proj, M = 2, one launch) in three sessions in a
row, with no session before them. For each session it prints the device
kernels the profiler saw, the launches the wrapper counted, and whether
the output equals the first call's bit for bit (so the kernel ran). The
last line is one JSON object. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--after-phase2", action="store_true",
                    help="run chip_smoke.py's phase-2 checks before the sessions")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8

    if not torch.cuda.is_available():
        print("profiler_first_session: no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.load()
    if args.after_phase2:
        cs.check_kernels()
        cs.check_int8_kernels()
        cs.check_pool_kernels()
        cs.check_server_kernels()
        cs.check_decode_one_launch()
        cs.check_stage_write()
    gen = torch.Generator(device="cuda").manual_seed(19)
    K, N = cs.PROJECTIONS["in_proj"]
    w = torch.randint(-127, 128, (1, K, N), dtype=torch.int8, device="cuda", generator=gen)
    scale = torch.rand((1, 1, N), device="cuda", generator=gen) * 1e-3 + 1e-4
    x = cs.randn(gen, 2, K)
    first = qmm_int8(x, w, scale, torch.bfloat16)
    torch.cuda.synchronize()
    sessions = []
    for _ in range(3):
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = qmm_int8(x, w, scale, torch.bfloat16)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        sessions.append(dict(device_kernels=len(kernels), names=kernels,
                             launches=build.LAUNCHES.get("qmm_int8", 0),
                             output_equal=bool(torch.equal(out, first))))
        print(f"session {len(sessions)}: {sessions[-1]}")
    print(cs.card_line())
    print(json.dumps({"after_phase2": args.after_phase2, "sessions": sessions}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
