#!/usr/bin/env python3
"""Times the port's prefill-attention, int8-matmul and decode-attention
kernels at the main path's shapes, for one checkout of the port, on one
NVIDIA GPU.

    python3 tools/time_torch_kernels.py [--tree DIR] [--label NAME]
        [--only decode|qmm2|mamba|prefill] [--chunks 256,128,64,32]

``--tree`` names the checkout whose ``zonos_vibes_tpu_torch`` is imported
(default: the one holding this script), so that two versions of the kernels
can be compared on one card in one run: unpack the other version into a
git-ignored directory and run parent, change, change, parent. The timing is
this checkout's ``chip_smoke.py`` phase 4, called on the imported port:
``time_qmm_steps`` (one forward's 105 ``qmm_int8`` launches at M = 2, the
solo decode step, and M = 16, the 8-slot pool's step, beside the matmul on
a bf16 copy of each weight), ``time_qmm`` for fc1 at a prefill's M = 176,
``time_prefill`` for row 3 at the transformer's S = 88 (head dim 64,
32/8 heads) and the hybrid's S = 92 (head dim 128, 16/4 heads), B = 2, and
at the long chunks (S = 2048 at offset 0, S = 512 at offset 64), beside
SDPA; and the seven decode-attention rows beside SDPA: rows 1 and 5
(``time_decode``) at the smoke's last step (T = 528, flushed_end 472,
stage_len 54) and at 30 s (T = 3072, 2944 + 127), rows 6 and 8
(``time_pooled``) at 16 rows over 3584 positions with bases 112-434 (the
main path once every row has joined), near 1800 and near 3000, row 6 at
head dim 128 (``time_pooled_hd128``) at bases 112-434, row 11
(``time_unstaged``) at T = 536, seq_end 531, row 12
(``time_pooled_unstaged``) at prefix ends 111-433; for the staged rows (1,
5, 6, 6b, 8) ``*_stage_written`` says whether the timed calls stored their
columns as the plain splice does (a checkout from before the stage write
moved into decode attention does not). ``--only decode`` times the decode
rows alone; ``--only qmm2`` the solo step's 105 ``qmm_int8``
launches at M = 2, shape by shape (in_proj, out_proj, fc1, fc2, heads);
``--only mamba`` the fused Mamba step (rows 9/10, ``time_ssd``) at B = 2
and 16 with an fp32 and a bf16 state; ``--only prefill`` row 3 alone, at
the shapes above and at the continuation's S = 519 (T = 960) with the
flagship's 32/8 heads and a tensor-parallel rank's 16/4. ``--chunks`` sets the split lengths
the decode-attention plan picks from (a checkout whose wrapper has the
plan). Prints chip_smoke's timing lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose port is timed")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--only", choices=("decode", "qmm2", "mamba", "prefill"), default=None,
                    help="time one family only")
    ap.add_argument("--chunks", default=None, help="decode-attention split lengths, longest first")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    import zonos_vibes_tpu_torch

    if not Path(zonos_vibes_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {zonos_vibes_tpu_torch.__file__}, not from {tree}")
    cs = _chip_smoke()
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(5)
    result = {"tree": args.label or str(tree), "card": card}

    if args.only is None:
        step, _ = cs.time_qmm_steps(gen, card)
        for M, t in step.items():
            result[f"qmm_m{M}_step_ms"] = t["ms"]
            result[f"matmul_m{M}_step_ms"] = t["lib"]
        fc1 = cs.time_qmm(gen, 1, *cs.PROJECTIONS["fc1"], torch.bfloat16, cs.L, (176,))[176]
        result["qmm_m176_fc1_ms"], result["matmul_m176_fc1_ms"] = fc1[0], fc1[2]
        for Hq, Hkv, Dh, S, T in ((cs.HQ, cs.HKV, cs.D, 88, 528),
                                  (cs.H_HQ, cs.H_HKV, cs.H_D, 92, 536)):
            for (S_, offset), (ms, _, lib, _, _) in cs.time_prefill(gen, Hq, Hkv, Dh, S, T,
                                                                    card).items():
                result[f"prefill_d{Dh}_s{S_}_o{offset}_ms"] = ms
                result[f"sdpa_d{Dh}_s{S_}_o{offset}_ms"] = lib

    if args.only == "qmm2":
        step, per_shape = cs.time_qmm_steps(gen, card, Ms=(2,))
        for (name, _), (ms, _, lib, b, _) in per_shape.items():
            result[f"qmm_m2_{name}_ms"], result[f"matmul_m2_{name}_ms"] = ms, lib
            result[f"qmm_m2_{name}_bound_ms"] = b
        result["qmm_m2_step_ms"], result["matmul_m2_step_ms"] = step[2]["ms"], step[2]["lib"]
    if args.only == "mamba":
        for (Bs, label), (ms, _, b, _) in cs.time_ssd(gen, card).items():
            result[f"ssd_b{Bs}_{label}_ms"], result[f"ssd_b{Bs}_{label}_bound_ms"] = ms, b
    if args.only == "prefill":
        for Hq, Hkv, Dh, S, T in ((cs.HQ, cs.HKV, cs.D, 88, 528),
                                  (cs.H_HQ, cs.H_HKV, cs.H_D, 92, 536),
                                  (cs.HQ, cs.HKV, cs.D, 519, 960),
                                  (cs.HQ // 2, cs.HKV // 2, cs.D, 519, 960)):
            long = cs.PREFILL_LONG if S < 512 else ()
            for (S_, offset), (ms, _, lib, _, _) in cs.time_prefill(gen, Hq, Hkv, Dh, S, T, card,
                                                                    long=long).items():
                result[f"prefill_h{Hq}_d{Dh}_s{S_}_o{offset}_ms"] = ms
                result[f"sdpa_h{Hq}_d{Dh}_s{S_}_o{offset}_ms"] = lib
    if args.only in ("qmm2", "mamba", "prefill"):
        print(json.dumps(result))
        return 0
    if args.chunks:
        from zonos_vibes_tpu_torch.ops.cuda import decode_attention

        decode_attention.CHUNKS = tuple(int(c) for c in args.chunks.split(","))
        result["chunks"] = args.chunks
    decode = {}
    for quant, name in ((False, "row1"), (True, "row5")):
        for T, fe, sl, depth in ((528, 472, 54, "t528"), (3072, 2944, 127, "t3072")):
            decode[f"{name}_{depth}"] = cs.time_decode(gen, T, fe, sl, depth, card, quant=quant)
    mid = [112 + 46 * s for s in range(cs.POOL_SLOTS)] * 2
    lens = [(23 * b) % cs.STAGE for b in range(cs.POOL_M)]
    for quant, name in ((False, "row6"), (True, "row8")):
        for label, bases, lns in (
                ("mid", mid, [cs.POOL_SEGMENT - 1] * cs.POOL_M),
                ("near1800", [1800 + 37 * (b - 8) for b in range(cs.POOL_M)], lens),
                ("near3000", [3000 + 37 * (b - 8) for b in range(cs.POOL_M)], lens)):
            decode[f"{name}_{label}"] = cs.time_pooled(gen, quant, label, bases, lns, card)
    decode["row6b_mid"] = cs.time_pooled_hd128(gen, mid, [cs.POOL_SEGMENT - 1] * cs.POOL_M, card)
    decode["row11_t536"] = cs.time_unstaged(gen, 536, 531, card)
    decode["row12_mid"] = cs.time_pooled_unstaged(gen, [m - 1 for m in mid], card)
    for key, (ms, _, lib, b, _, *held) in decode.items():
        result[f"{key}_ms"], result[f"{key}_sdpa_ms"], result[f"{key}_bound_ms"] = ms, lib, b
        if held:
            result[f"{key}_stage_written"] = held[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
