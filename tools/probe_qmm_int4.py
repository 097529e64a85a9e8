#!/usr/bin/env python3
"""Shows what a ``qmm_int4`` launch (``csrc/qmm_int4.cu``) waits on, on one
NVIDIA GPU: the kernel beside two variants of its own source, built side by
side into scratch libraries under ``build/``, at the int4 shapes' planned
launches (``ops/cuda/qmm.py::int4_plan``) at M = 2, 16 and 176:

- ``no_compute``: each stage's copies, wait and barrier, no fragment loads,
  widening or mma (memory and synchronisation alone);
- ``no_refill``: the ring's first stages reused for every stage, the compute
  alone (no copy after the prologue).

    python3 tools/probe_qmm_int4.py

The variants' outputs are wrong by design; only their times are read
(``chip_smoke.py``'s ``device_ms``, each launch reading its weight from
device memory). Prints one line per (shape, M, variant), then one JSON line.
"""

from __future__ import annotations

import ctypes
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFILL = "    if (it + NSTAGE - 1 < nk) load(it + NSTAGE - 1);\n    cp_async_commit();\n"
LOAD = "  auto load = [&](int it) {\n"
VARIANTS = {
    "kernel": lambda s: s,
    "no_compute": lambda s: s.replace(REFILL, REFILL + "    if (it >= 0) continue;\n"),
    "no_refill": lambda s: s.replace(LOAD, LOAD + "    if (it >= NSTAGE - 1) return;\n"),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(out_dir: Path) -> dict:
    """Each variant of the source compiled into its own library (one nvcc
    each, all started together); {name: the bound entry point}."""
    from zonos_vibes_tpu_torch.ops.cuda import build

    src = (build.CSRC / "qmm_int4.cu").read_text()
    if REFILL not in src or LOAD not in src:
        raise RuntimeError("probe_qmm_int4: the kernel's main loop changed; update the anchors")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edit in VARIANTS.items():
        cu, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(edit(src))
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe_qmm_int4: nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).zvt_qmm_int4
        fn.argtypes = list(build._SIGNATURES["zvt_qmm_int4"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_qmm_int4: no CUDA device", file=sys.stderr)
        return 1
    from zonos_vibes_tpu_torch.ops import quant
    from zonos_vibes_tpu_torch.ops.cuda import qmm

    cs_mod = _chip_smoke()
    card = cs_mod.card_line()
    fns = build_variants(ROOT / "build" / "probe_qmm_int4")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(11)
    result = {"card": card}
    for name, (K, N, groups) in cs_mod.INT4_SHAPES.items():
        layers = cs_mod.L if name in ("fc1", "fc2") else 4
        leaf = quant.quantize_weight(cs_mod.randn(gen, layers, K, N) / K ** 0.5, bits=4,
                                     group_size=K // groups)
        w, scale = leaf["weight_int4"], leaf["scale"]
        idx = itertools.cycle(range(layers))
        for M in (2, cs_mod.POOL_M, 176):
            x = cs_mod.randn(gen, M, K)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            plan = qmm.int4_plan(M, K, N, sms)
            for variant, fn in fns.items():
                def call(fn=fn):
                    i = next(idx)
                    rc = fn(x.data_ptr(), w[i].data_ptr(), scale[i].data_ptr(), out.data_ptr(),
                            M, K, N, groups, 0, *plan, stream)
                    if rc:
                        raise RuntimeError(f"probe_qmm_int4: CUDA error {rc} at launch")
                ms = cs_mod.device_ms(call, 26 * 8)
                result[f"{name}_m{M}_{variant}_ms"] = ms
                print(f"qmm_int4 {name} M={M} plan {plan} {variant} ({card}): {ms:.5f} ms",
                      flush=True)
        del leaf, w, scale
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
