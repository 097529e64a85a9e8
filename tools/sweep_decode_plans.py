#!/usr/bin/env python3
"""Sweeps the launch plans of the decode-step kernels on one NVIDIA GPU:
``qmm_int8`` at M = 2 (the int8 solo step's projections and heads), the
fused Mamba-2 step (rows 9/10) and ``qmm_int4`` at M = 2 to 176 (the
int4-MLP solo step, server batches, the pooled step and the prefill), at
the main path's shapes.

    python3 tools/sweep_decode_plans.py [--only qmm|mamba|qmm4]

For ``qmm_int8`` it times every (tile width, cluster size) of 32/64 x
1/2/4/8 that gives 32-1100 blocks, at in_proj, out_proj, fc1, fc2 and the
heads, each plan in place of ``ops/cuda/qmm.py::decode_plan``'s; then the
planned launch back to back and behind a PyTorch elementwise kernel that
writes its x (the pair's time less the elementwise kernel's alone), which
shows the programmatic dependent launch's overlap behind any predecessor.
For the Mamba step it times each column tile of ``ops/cuda/mamba_step.py::
TILES`` at B = 2 and 16 with an fp32 and a bf16 state. For ``qmm_int4``
at M = 2, 4, 8, 16 and 176, every (row tile, tile width, cluster size) of
the kernel (x as mma's n8 operand at M <= 8, its m16 operand from 4 rows
up; tiles 64/128/256; clusters 1/2/4/8), at fc1, fc2 and the attention
projections in 128-row groups, each in place of
``ops/cuda/qmm.py::int4_plan``'s, and the best beside the planned. Times are
``chip_smoke.py``'s ``device_ms`` over weights or planes cycled so that each
launch reads from device memory (the heads' one weight, 21 MB, stays in L2,
as in ``chip_smoke.py`` phase 4). Prints one line per plan, then one JSON
line.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_qmm(cs_mod, gen, card) -> dict:
    import torch

    from zonos_vibes_tpu_torch.ops.cuda import qmm

    planned = qmm.decode_plan
    result = {}
    shapes = [(name, 1, k, n, torch.bfloat16, cs_mod.L)
              for name, (k, n) in cs_mod.PROJECTIONS.items()]
    shapes.append(("heads", *cs_mod.HEADS_SHAPE, torch.float32, 1))
    try:
        for name, G, K, N, out_dtype, layers in shapes:
            w = torch.randint(-127, 128, (layers, G, K, N), dtype=torch.int8, device="cuda",
                              generator=gen)
            scale = torch.rand((layers, G, 1, N), device="cuda", generator=gen) * 1e-3 + 1e-4
            x = cs_mod.randn(gen, 2, K)
            idx = itertools.cycle(range(layers))

            def call():
                i = next(idx)
                return qmm.qmm_int8(x, w[i], scale[i], out_dtype)

            for tn, cl in itertools.product(qmm.TILES, (1, 2, 4, 8)):
                stage_rows = qmm.STAGE_BYTES // tn
                rows = -(-K // (cl * stage_rows)) * stage_rows  # whole stages
                blocks = cl * -(-N // tn) * G
                if not 32 <= blocks <= 1100 or (cl - 1) * rows >= K:
                    continue
                qmm.decode_plan = lambda *_, p=(tn, cl, rows): p
                ms = cs_mod.device_ms(call, 26 * 8)
                result[f"{name}_tn{tn}_cs{cl}_ms"] = ms
                print(f"qmm_int8 {name} M=2 tile {tn} cluster {cl} ({blocks} blocks, "
                      f"{tn * rows // 1024} KB a block; {card}): {ms:.5f} ms", flush=True)
            qmm.decode_plan = planned
            ms = cs_mod.device_ms(call, 26 * 8)
            y = x.clone()

            def behind():
                y.mul_(1.0)
                i = next(idx)
                return qmm.qmm_int8(y, w[i], scale[i], out_dtype)
            pair = cs_mod.device_ms(behind, 26 * 8)
            alone = cs_mod.device_ms(lambda: y.mul_(1.0), 26 * 8)
            result[f"{name}_planned_ms"] = ms
            result[f"{name}_behind_elementwise_ms"] = pair - alone
            print(f"qmm_int8 {name} M=2 planned {planned(2, K, N, G)} ({card}): back to back "
                  f"{ms:.5f} ms; behind an elementwise kernel {pair - alone:.5f} ms (pair "
                  f"{pair:.5f}, elementwise alone {alone:.5f})", flush=True)
            del w, scale
    finally:
        qmm.decode_plan = planned
    return result


def sweep_mamba(cs_mod, gen, card) -> dict:
    import torch

    from zonos_vibes_tpu_torch.ops.cuda import mamba_step

    planned = mamba_step.step_plan
    result = {}
    try:
        for Bs in (cs_mod.B, cs_mod.POOL_M):
            for sdt, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
                states, x = cs_mod.ssd_inputs(gen, Bs, cs_mod.H_M, sdt)
                states.normal_(generator=gen)
                idx = itertools.cycle(range(cs_mod.H_M))
                for tile in mamba_step.TILES:
                    mamba_step.step_plan = lambda *_, t=tile: t
                    ms = cs_mod.device_ms(
                        lambda: mamba_step.ssd_gate_step_layered(states, next(idx), **x),
                        cs_mod.H_M * 10)
                    result[f"b{Bs}_{label}_tile{tile}_ms"] = ms
                    print(f"ssd_gate_step B={Bs} state {label} tile {tile} "
                          f"({Bs * cs_mod.M_HP // tile} blocks; {card}): {ms:.5f} ms", flush=True)
                mamba_step.step_plan = planned
                del states
    finally:
        mamba_step.step_plan = planned
    return result


def _qmm4_plans(qmm, M: int, K: int, N: int):
    """Every plan of ``qmm_int4`` at (M, K, N) beside ``int4_plan``'s: x as
    the n8 operand (bm 8, M <= 8) or the m16 operand (bm 16 from 4 rows up to
    16, 64 beyond), over each tile width and cluster size."""
    bms = [8, 16] if M <= 8 else [16] if M <= 16 else [64]
    for bm, tn, cl in itertools.product(bms, qmm.INT4_TILES, (1, 2, 4, 8)):
        rows = -(-K // (cl * qmm.INT4_BK)) * qmm.INT4_BK
        blocks = cl * -(-N // tn) * -(-M // bm)
        if 16 <= blocks <= 4400 and (cl - 1) * rows < K:
            yield (bm, tn, cl, rows), blocks


def sweep_qmm4(cs_mod, gen, card) -> dict:
    import torch

    from zonos_vibes_tpu_torch.ops import quant
    from zonos_vibes_tpu_torch.ops.cuda import qmm

    planned = qmm.int4_plan
    result = {}
    try:
        for name, (K, N, groups) in cs_mod.INT4_SHAPES.items():
            layers = cs_mod.L if name in ("fc1", "fc2") else 4
            leaf = quant.quantize_weight(cs_mod.randn(gen, layers, K, N) / K ** 0.5, bits=4,
                                         group_size=K // groups)
            w, scale = leaf["weight_int4"], leaf["scale"]
            idx = itertools.cycle(range(layers))
            for M in (2, 4, 8, cs_mod.POOL_M, 176):
                x = cs_mod.randn(gen, M, K)

                def call():
                    i = next(idx)
                    return qmm.qmm_int4(x, w[i], scale[i])

                best = None
                for plan, blocks in _qmm4_plans(qmm, M, K, N):
                    qmm.int4_plan = lambda *_, p=plan: p
                    ms = cs_mod.device_ms(call, 26 * 8)
                    bm, tn, cl, rows = plan
                    result[f"{name}_m{M}_bm{bm}_tn{tn}_cs{cl}_ms"] = ms
                    best = min(best or (ms, plan), (ms, plan))
                    print(f"qmm_int4 {name} M={M} bm {bm} tile {tn} cluster {cl} ({blocks} "
                          f"blocks, {rows} rows a block; {card}): {ms:.5f} ms", flush=True)
                qmm.int4_plan = planned
                ms = cs_mod.device_ms(call, 26 * 8)
                result[f"{name}_m{M}_planned_ms"] = ms
                result[f"{name}_m{M}_best"] = [best[0], list(best[1])]
                print(f"qmm_int4 {name} M={M} planned {planned(M, K, N)} ({card}): {ms:.5f} ms; "
                      f"best {best[1]} {best[0]:.5f} ms", flush=True)
            del leaf, w, scale
            torch.cuda.empty_cache()
    finally:
        qmm.int4_plan = planned
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("qmm", "mamba", "qmm4"), default=None,
                    help="sweep one kernel")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("sweep_decode_plans: no CUDA device", file=sys.stderr)
        return 1
    cs_mod = _chip_smoke()
    card = cs_mod.card_line()
    gen = torch.Generator(device="cuda").manual_seed(7)
    result = {"card": card}
    if args.only in (None, "qmm"):
        result["qmm"] = sweep_qmm(cs_mod, gen, card)
    if args.only in (None, "mamba"):
        result["mamba"] = sweep_mamba(cs_mod, gen, card)
    if args.only in (None, "qmm4"):
        result["qmm4"] = sweep_qmm4(cs_mod, gen, card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
