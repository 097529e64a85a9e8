#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``zonos_vibes_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. Card and build: the card's name and power limit (``nvidia-smi``), then
   the kernels built from ``zonos_vibes_tpu_torch/csrc/`` with ``nvcc``.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the flagship's shapes (26 layers, CFG batch 2, 32 query
   heads, 8 KV heads, head dim 64, projections 2048 -> 3072, 2048 -> 2048,
   2048 -> 16384, 8192 -> 2048 and the 9 heads 2048 -> 1152), bf16, over
   the edge cases of its interface; then the backbone on the card against
   the CPU path on a small input, with bf16 weights and cache and with int8
   weights and an int8 cache.
3. End to end: ``ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER)`` with
   random bf16 weights from a seeded generator, text -> about 5 s of codes
   -> DAC -> WAV (written to ``build/chip_smoke.wav``). The launch
   counters are zeroed just before and read just after: every kernel must
   have run on the main path, decode attention 26 times per decode step.
   Then the int8 serving path on the same weights: the first frame's
   next-token distributions before and after ``pipe.quantize_int8()``
   (mean total-variation distance at most 0.05), and
   ``DecodeEngine(model, kv_int8=True)`` for the same 5 s -> DAC -> WAV
   (``build/chip_smoke_int8.wav``) with its own exact launch counts.
4. Timing: each kernel, its plain version and the one PyTorch call that
   computes the same function, at the shapes the main path gave it, beside
   the least time the card could take for the same work.

The second-to-last line is ``{"kernels": [...]}``, the line before it the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense): HBM rate and bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
L, B, HQ, HKV, D, STAGE = 26, 2, 32, 8, 64, 128
W = HKV * D
TOL = 2e-2  # bf16 output rounding and the kernel's fp32 probabilities
# int8 kernels against their plain versions, which run the same fp32
# arithmetic: one rounding of the output, which may fall on either side of a
# bf16 step when the fp32 sums differ in their last bits.
QMM_TOL = {"bf16": (8e-3, 1e-2), "fp32": (1e-5, 1e-4)}  # (rtol, atol)
Q_TOL = 1e-2  # int8-KV attention, bf16 output of magnitude < 1
TVD_LIMIT = 0.05
PROJECTIONS = {"in_proj": (2048, 3072), "out_proj": (2048, 2048), "fc1": (2048, 16384),
               "fc2": (8192, 2048)}
HEADS_SHAPE = (9, 2048, 1152)
AUDIO_FRAMES = 431  # ~5 s at 86.13 frames/s
TEXT = "It would be nice to have time for testing, indeed. The port runs on the card now."


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int) -> float:
    """Device time per call: the launches queue up behind a device-side
    sleep, so the events time the device, not the host's launch loop."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(host_ms, 1.0) * 4e6))  # ~2x the enqueue time at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(gen, *shape):
    import torch

    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def decode_inputs(gen, T):
    return dict(q=randn(gen, B, 1, HQ, D), k_cache=randn(gen, L, B, T, W),
                v_cache=randn(gen, L, B, T, W), k_stage=randn(gen, L, B, STAGE, W),
                v_stage=randn(gen, L, B, STAGE, W), k_cur=randn(gen, B, W),
                v_cur=randn(gen, B, W))


def check_kernels() -> dict:
    """Phase 2: every kernel against its plain version; max |error| each."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain)
    from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import (
        prefill_attention, prefill_attention_plain)
    from zonos_vibes_tpu_torch.ops.cuda.stage_write import stage_splice, stage_splice_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {}
    x = decode_inputs(gen, 3072)
    worst = 0.0
    for fe in (0, 1, 500, 2944):
        for sl in (0, 5, 127):
            for layer in (0, 25):
                sc = torch.tensor([fe, sl, layer], dtype=torch.int32, device="cuda")
                got = decode_attention_layered(**x, scalars=sc).float()
                want = decode_attention_layered_plain(**x, scalars=sc).float()
                e = (got - want).abs().max().item()
                if not torch.isfinite(got).all() or e > TOL:
                    raise AssertionError(f"decode_attention fe={fe} sl={sl} l={layer}: err {e}")
                worst = max(worst, e)
    err["decode_attention"] = worst
    log(f"kernel decode_attention: 24 cases (flushed_end 0/1/500/2944, stage_len 0/5/127, "
        f"layer 0/25, T=3072) max_abs_err {worst:.3e} <= {TOL}")

    for slot in (0, 1, 63, 127):
        stage = randn(gen, L, B, STAGE, W)
        cols = randn(gen, L, B, W)
        want = stage_splice_plain(stage.clone(), cols, torch.tensor([slot]))
        got = stage_splice(stage, cols, torch.tensor([slot], dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stage_splice slot={slot}: differs from the plain version")
    err["stage_splice"] = 0.0
    log("kernel stage_splice: slots 0/1/63/127 bit-exact, other slots untouched")

    worst = 0.0
    for S in (7, 97, 600):
        for offset in (0, 64):
            q = randn(gen, B, S, HQ, D)
            k, v = randn(gen, B, 768, W), randn(gen, B, 768, W)
            got = prefill_attention(q, k, v, offset).float()
            want = prefill_attention_plain(q, k, v, offset).float()
            e = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or e > TOL:
                raise AssertionError(f"prefill_attention S={S} offset={offset}: err {e}")
            worst = max(worst, e)
    err["prefill_attention"] = worst
    log(f"kernel prefill_attention: S 7/97/600 x offset 0/64 max_abs_err {worst:.3e} <= {TOL}")
    return err


def check_int8_kernels() -> dict:
    """Phase 2, the int8 path's kernels against their plain versions."""
    import torch

    from zonos_vibes_tpu_torch.ops import quant
    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered_q, decode_attention_layered_q_plain)
    from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8, qmm_int8_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    err = {}
    worst, cases = 0.0, 0
    shapes = [(name, 1, k, n, torch.bfloat16) for name, (k, n) in PROJECTIONS.items()]
    shapes.append(("heads", *HEADS_SHAPE, torch.float32))
    for name, G, K, N, out_dtype in shapes:
        wq = quant.quantize_weight(randn(gen, G, K, N) / K ** 0.5)
        rtol, atol = QMM_TOL["fp32" if out_dtype == torch.float32 else "bf16"]
        for M in (1, 2, 176):
            x = randn(gen, M, K)
            got = qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype)
            want = qmm_int8_plain(x, wq["weight_int8"], wq["scale"], out_dtype)
            diff = (got.float() - want.float()).abs()
            if (got.shape != want.shape or got.dtype != out_dtype or not torch.isfinite(got).all()
                    or (diff > atol + rtol * want.float().abs()).any()):
                raise AssertionError(f"qmm_int8 {name} M={M}: max |err| {diff.max().item()}")
            worst, cases = max(worst, diff.max().item()), cases + 1
    err["qmm_int8"] = worst
    log(f"kernel qmm_int8: {cases} cases (in_proj/out_proj/fc1/fc2 bf16 out, 9 heads fp32 out; "
        f"M 1/2/176) max_abs_err {worst:.3e} within |err| <= atol + rtol |y| {QMM_TOL}")

    x = decode_inputs(gen, 3072)
    kq, kscale = quant.quantize_rows(x.pop("k_cache"), HKV)
    vq, vscale = quant.quantize_rows(x.pop("v_cache"), HKV)
    worst = 0.0
    for fe in (0, 1, 500, 2944):
        # Scales at or past flushed_end are never read: poison them.
        ks, vs = kscale.clone(), vscale.clone()
        ks[:, :, fe:] = float("nan")
        vs[:, :, fe:] = float("nan")
        args = dict(x, k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)
        for sl in (0, 5, 127):
            for layer in (0, 25):
                sc = torch.tensor([fe, sl, layer], dtype=torch.int32, device="cuda")
                got = decode_attention_layered_q(**args, scalars=sc).float()
                want = decode_attention_layered_q_plain(**args, scalars=sc).float()
                e = (got - want).abs().max().item()
                if not torch.isfinite(got).all() or e > Q_TOL:
                    raise AssertionError(f"decode_attention_q fe={fe} sl={sl} l={layer}: err {e}")
                worst = max(worst, e)
    err["decode_attention_q"] = worst
    log(f"kernel decode_attention_q: 24 cases (flushed_end 0/1/500/2944, stage_len 0/5/127, "
        f"layer 0/25, T=3072, NaN scales past flushed_end) max_abs_err {worst:.3e} <= {Q_TOL}")
    return err


def check_backbone_against_cpu(int8: bool = False) -> float:
    """The backbone on the card (kernels) against the same backbone on the
    CPU (plain versions) on a small input: 2 layers at the flagship's head
    geometry (head dim 64, 4 query and 2 KV heads), bf16, a prefill of 5
    positions and 12 staged decode steps through one flush of an 8-row
    stage; with ``int8``, int8 projections and an int8 KV cache. Returns the
    largest |difference| of the hidden states."""
    import torch

    from zonos_vibes_tpu_torch.config import BackboneConfig, _freeze
    from zonos_vibes_tpu_torch.models import backbone
    from zonos_vibes_tpu_torch.ops.quant import quantize_backbone_params
    from zonos_vibes_tpu_torch.ops.rope import rope_table

    cfg = BackboneConfig(d_model=256, n_layer=2, attn_mlp_d_intermediate=512,
                         attn_cfg=_freeze({"num_heads": 4, "num_heads_kv": 2}))
    gen = torch.Generator().manual_seed(3)
    params = backbone.init_transformer_backbone(gen, cfg, torch.bfloat16, "cpu")
    if int8:
        params = quantize_backbone_params(params)
    Lt, Bt, Tt, St, Wt = cfg.n_layer, 2, 32, 8, 2 * 64

    def setup(dev):
        p = {"layers": {n: {k: t.to(dev) for k, t in leaf.items()}
                        for n, leaf in params["layers"].items()},
             "norm_f": {k: t.to(dev) for k, t in params["norm_f"].items()}}
        cache = backbone.allocate_kv_cache(cfg, Bt, Tt, torch.bfloat16, dev, kv_int8=int8)
        for name in ("k_stage", "v_stage"):
            cache[name] = torch.zeros(Lt, Bt, St, Wt, dtype=torch.bfloat16, device=dev)
        return p, cache, rope_table(64, device=dev)

    sides = {dev: setup(dev) for dev in ("cpu", "cuda")}
    inputs = [torch.randn(Bt, 5, 256, generator=gen).to(torch.bfloat16)]
    inputs += [torch.randn(Bt, 1, 256, generator=gen).to(torch.bfloat16) for _ in range(12)]
    worst, stage_base = 0.0, 5
    with torch.inference_mode():
        for i, x in enumerate(inputs):
            outs = {}
            for dev, (p, cache, table) in sides.items():
                if i == 0:
                    outs[dev] = backbone.transformer_forward(p, cfg, x.to(dev), cache, 0, table)
                else:
                    outs[dev] = backbone.transformer_forward(p, cfg, x.to(dev), cache, 4 + i,
                                                             table, stage_base=stage_base)
            if i > 0 and 4 + i + 1 - stage_base == St:
                for _, cache, _ in sides.values():
                    backbone.flush_kv_stage(cache, stage_base)
                stage_base += St
            diff = (outs["cuda"].float().cpu() - outs["cpu"].float()).abs().max().item()
            if diff > 0.1:
                raise AssertionError(f"backbone card vs CPU, call {i}: max |diff| {diff}")
            worst = max(worst, diff)
    if stage_base != 5 + St:
        raise AssertionError("the reference run did not cross its stage flush")
    kind = "int8 weights and KV cache" if int8 else "bf16"
    log(f"reference: backbone on the card vs the CPU plain path, {kind}, prefill + 12 staged "
        f"steps across a flush: max |hidden diff| {worst:.3e} <= 0.1 (bf16 rounding of "
        f"hidden states of magnitude up to ~4)")
    return worst


def run_main_path(card: str):
    """Phase 3: text -> codes -> WAV through the pipeline, counted. Returns
    the pipeline, the cond dict and the numbers."""
    import numpy as np
    import torch

    from zonos_vibes_tpu_torch.config import ZONOS_V01_TRANSFORMER
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
    from zonos_vibes_tpu_torch.serve.sample import wav_bytes

    t0 = time.perf_counter()
    pipe = ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(421))
    torch.cuda.synchronize()
    log(f"init: flagship random bf16 weights in {time.perf_counter() - t0:.1f} s; "
        f"memory_allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB with the DAC")
    cond = pipe.make_cond_dict(text=TEXT, language="en-us")
    # Warm-up (cuBLAS and cuDNN handles, allocator), then the counted run.
    warm = pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(1),
                         max_new_tokens=8, disable_eos=True)
    pipe.decode_audio(warm)

    build.reset_launches()
    t0 = time.perf_counter()
    result = pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(421),
                           max_new_tokens=AUDIO_FRAMES, disable_eos=True)
    launches = dict(build.LAUNCHES)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    wav = pipe.decode_audio(result)
    torch.cuda.synchronize()
    t_dac = time.perf_counter() - t0

    codes = result.codes
    steps = result.steps
    cond_len = pipe.prepare_conditioning(cond).shape[1]
    if codes.shape != (1, 9, AUDIO_FRAMES) or int(codes.min()) < 0 or int(codes.max()) >= 1024:
        raise AssertionError(f"codes out of range or misshapen: {tuple(codes.shape)}")
    if result.valid_length != AUDIO_FRAMES:
        raise AssertionError(f"valid length {result.valid_length} != {AUDIO_FRAMES}")
    if wav.size == 0 or not np.isfinite(wav).all():
        raise AssertionError("waveform empty or not finite")
    want = {"decode_attention": L * steps, "decode_attention_q": 0, "stage_splice": 2 * steps,
            "prefill_attention": L, "qmm_int8": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.wav").write_bytes(wav_bytes(wav[0], pipe.dac.sampling_rate))

    audio_s = wav.shape[-1] / pipe.dac.sampling_rate
    e2e = {
        "cond_len": cond_len, "steps": steps, "audio_s": audio_s,
        "prefill_ms": result.prefill_seconds * 1e3,
        "decode_ms_per_step": result.decode_seconds * 1e3 / steps,
        "generate_s": t_gen, "dac_ms": t_dac * 1e3, "rtf": audio_s / (t_gen + t_dac),
        "launches": launches,
    }
    log(f"e2e ({card}): text -> {audio_s:.2f} s of audio; cond_len {cond_len}, "
        f"{steps} decode steps; prefill {e2e['prefill_ms']:.2f} ms, decode "
        f"{e2e['decode_ms_per_step']:.3f} ms/step, DAC {e2e['dac_ms']:.1f} ms, "
        f"RTF {e2e['rtf']:.3f}; launches {launches}")
    return pipe, cond, e2e


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def first_frame_logits(pipe, prefix, kv_int8: bool):
    """``[1, 9, 1152]`` fp32 logits of the first frame after the prefill, as
    the engine's prefill computes them (input column: the MASK frame)."""
    import torch

    from zonos_vibes_tpu_torch.ops.delay_pattern import apply_delay_pattern
    from zonos_vibes_tpu_torch.ops.rope import rope_table

    model, cfg = pipe.model, pipe.model.config
    with torch.inference_mode():
        codes = torch.full((1, cfg.num_codebooks, 1), -1, dtype=torch.long, device="cuda")
        emb = model.embed_codes(pipe.params, apply_delay_pattern(codes, cfg.masked_token_id)[..., :1])
        hidden = torch.cat([prefix, torch.cat([emb, emb]).to(prefix.dtype)], dim=1)
        cache = model.allocate_cache(2, 512, prefix.dtype, "cuda", kv_int8)
        rope = rope_table(cfg.backbone.head_dim, device="cuda")
        return model.compute_logits(pipe.params, hidden, cache, 0, 2.0, rope)


def run_int8_path(pipe, cond, card: str) -> dict:
    """Phase 3, the int8 serving path on the bf16 run's weights: the first
    frame's distributions before and after ``quantize_int8``, then text ->
    codes -> WAV with ``DecodeEngine(kv_int8=True)``, counted."""
    import gc

    import numpy as np
    import torch

    from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.serve.sample import wav_bytes

    prefix = pipe.prepare_conditioning(cond)
    cond_len = prefix.shape[1]
    ref = first_frame_logits(pipe, prefix, kv_int8=False)
    bf16_bytes, bf16_alloc = param_bytes(pipe.params), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pipe.quantize_int8()
    gc.collect()
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    int8_bytes, int8_alloc = param_bytes(pipe.params), torch.cuda.memory_allocated()
    log(f"quantize_int8: {t_quant:.2f} s; Zonos parameters {bf16_bytes / 2**30:.3f} GiB bf16 -> "
        f"{int8_bytes / 2**30:.3f} GiB int8; memory_allocated {bf16_alloc / 2**30:.3f} -> "
        f"{int8_alloc / 2**30:.3f} GiB (with the DAC)")
    got = first_frame_logits(pipe, prefix, kv_int8=True)
    tvd = 0.5 * (torch.softmax(got, -1) - torch.softmax(ref, -1)).abs().sum(-1)  # [1, 9]
    mean_tvd = tvd.mean().item()
    log(f"int8 quality: first-frame next-token TVD bf16 vs int8, mean over 9 codebooks "
        f"{mean_tvd:.4f} (max {tvd.max().item():.4f}); JAX int8 mean TVD on random weights "
        f"0.0125 (quality_r4.jsonl:1); limit {TVD_LIMIT}")
    if not np.isfinite(mean_tvd) or mean_tvd > TVD_LIMIT:
        raise AssertionError(f"int8 first-frame TVD {mean_tvd} > {TVD_LIMIT}")

    engine = DecodeEngine(pipe.model, kv_int8=True)
    warm = engine.generate(pipe.params, prefix, generator=torch.Generator("cuda").manual_seed(1),
                           max_new_tokens=8, disable_eos=True)
    pipe.decode_audio(warm)

    build.reset_launches()
    t0 = time.perf_counter()
    result = engine.generate(pipe.params, prefix,
                             generator=torch.Generator("cuda").manual_seed(421),
                             max_new_tokens=AUDIO_FRAMES, disable_eos=True)
    launches = dict(build.LAUNCHES)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    wav = pipe.decode_audio(result)
    torch.cuda.synchronize()
    t_dac = time.perf_counter() - t0

    codes, steps = result.codes, result.steps
    if codes.shape != (1, 9, AUDIO_FRAMES) or int(codes.min()) < 0 or int(codes.max()) >= 1024:
        raise AssertionError(f"int8 codes out of range or misshapen: {tuple(codes.shape)}")
    if result.valid_length != AUDIO_FRAMES:
        raise AssertionError(f"int8 valid length {result.valid_length} != {AUDIO_FRAMES}")
    if wav.size == 0 or not np.isfinite(wav).all():
        raise AssertionError("int8 waveform empty or not finite")
    # 4 projections per layer and one launch for the 9 heads per forward.
    want = {"decode_attention": 0, "decode_attention_q": L * steps, "stage_splice": 2 * steps,
            "prefill_attention": L, "qmm_int8": (4 * L + 1) * (steps + 1)}
    if launches != want:
        raise AssertionError(f"int8 launch counts {launches}, expected {want}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_int8.wav").write_bytes(wav_bytes(wav[0], pipe.dac.sampling_rate))

    audio_s = wav.shape[-1] / pipe.dac.sampling_rate
    e2e = {
        "cond_len": cond_len, "steps": steps, "audio_s": audio_s,
        "prefill_ms": result.prefill_seconds * 1e3,
        "decode_ms_per_step": result.decode_seconds * 1e3 / steps,
        "generate_s": t_gen, "dac_ms": t_dac * 1e3, "rtf": audio_s / (t_gen + t_dac),
        "launches": launches, "tvd": mean_tvd,
    }
    log(f"e2e int8 ({card}): text -> {audio_s:.2f} s of audio; cond_len {cond_len}, "
        f"{steps} decode steps; prefill {e2e['prefill_ms']:.2f} ms, decode "
        f"{e2e['decode_ms_per_step']:.3f} ms/step, DAC {e2e['dac_ms']:.1f} ms, "
        f"RTF {e2e['rtf']:.3f}; launches {launches}")
    return e2e


def time_kernels(e2e: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4: kernel, plain and library times at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.engine.generate import _find_multiple
    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain)
    from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import (
        prefill_attention, prefill_attention_plain)
    from zonos_vibes_tpu_torch.ops.cuda.stage_write import stage_splice, stage_splice_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    cond_len, steps = e2e["cond_len"], e2e["steps"]
    T = cond_len + AUDIO_FRAMES + 9
    T = _find_multiple(T, 512 if T >= 1024 else 8)
    rows = []

    def decode_row(T, fe, sl, label):
        x = decode_inputs(gen, T)
        sc = torch.tensor([fe, sl, 5], dtype=torch.int32, device="cuda")
        n = fe + sl + 1
        kg = torch.cat([x["k_cache"][5, :, :fe], x["k_stage"][5, :, :sl], x["k_cur"][:, None]], 1)
        vg = torch.cat([x["v_cache"][5, :, :fe], x["v_stage"][5, :, :sl], x["v_cur"][:, None]], 1)
        kg = kg.view(B, n, HKV, D).transpose(1, 2).contiguous()
        vg = vg.view(B, n, HKV, D).transpose(1, 2).contiguous()
        qg = x["q"].transpose(1, 2).contiguous()
        ms = device_ms(lambda: decode_attention_layered(**x, scalars=sc), 200)
        plain = device_ms(lambda: decode_attention_layered_plain(**x, scalars=sc), 20)
        lib = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True), 200)
        nbytes = 2 * B * n * W * 2 + 2 * B * HQ * D * 2
        b, by = bound(nbytes, 4 * B * HQ * n * D)
        log(f"time decode_attention {label} T={T} flushed_end={fe} stage_len={sl} ({card}): "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
            f"bound_ms {b:.5f} ({by})")
        return ms, plain, lib, b, by

    # The main path's last decode step: stage_base = cond_len + 1 plus the
    # flushed stages; the step attends positions [0, cond_len + steps].
    last_pos = cond_len + steps  # absolute position of the last token
    fe = cond_len + 1 + ((last_pos - cond_len - 1) // STAGE) * STAGE
    ms, plain, lib, b, by = decode_row(T, fe, last_pos - fe, "main-path last step")
    decode_row(3072, 2944, 127, "30 s depth")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:253",
                     launches=e2e["launches"]["decode_attention"],
                     max_abs_err=errors["decode_attention"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))

    stage = randn(gen, L, B, STAGE, W)
    cols = randn(gen, L, B, W)
    slot = torch.tensor([17], dtype=torch.int32, device="cuda")
    ms = device_ms(lambda: stage_splice(stage, cols, slot), 500)
    plain = device_ms(lambda: stage_splice_plain(stage, cols, 17), 200)
    lib = device_ms(lambda: stage[:, :, 17].copy_(cols), 500)
    b, by = bound(2 * L * B * W * 2 + 4, 0)
    log(f"time stage_splice L={L} B={B} W={W} ({card}): kernel_ms {ms:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} bound_ms {b:.6f} ({by})")
    rows.append(dict(name="stage_splice", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/stage_write.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/stage_write.py:41",
                     launches=e2e["launches"]["stage_splice"],
                     max_abs_err=errors["stage_splice"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))

    S = cond_len + 1
    q = randn(gen, B, S, HQ, D)
    k, v = randn(gen, B, T, W), randn(gen, B, T, W)
    qh = q.transpose(1, 2).contiguous()
    kh = k[:, :S].view(B, S, HKV, D).transpose(1, 2).contiguous()
    vh = v[:, :S].view(B, S, HKV, D).transpose(1, 2).contiguous()
    ms = device_ms(lambda: prefill_attention(q, k, v, 0), 200)
    plain = device_ms(lambda: prefill_attention_plain(q, k, v, 0), 20)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                           enable_gqa=True), 200)
    b, by = bound(2 * B * S * HQ * D * 2 + 2 * B * S * W * 2,
                  4 * B * HQ * D * S * (S + 1) / 2)
    log(f"time prefill_attention S={S} T={T} offset=0 ({card}): kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms {b:.6f} ({by})")
    rows.append(dict(name="prefill_attention", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/prefill_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/prefill_attention.py:111",
                     launches=e2e["launches"]["prefill_attention"],
                     max_abs_err=errors["prefill_attention"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


def time_int8_kernels(e2e: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4, the int8 path's kernels at the shapes of its main path."""
    import itertools

    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.engine.generate import _find_multiple
    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered_q, decode_attention_layered_q_plain)
    from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8, qmm_int8_plain
    from zonos_vibes_tpu_torch.ops.quant import dequantize_rows, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(5)
    cond_len, steps = e2e["cond_len"], e2e["steps"]
    rows = []

    # The weights of all 26 layers, cycled through, so that each launch reads
    # its weight from device memory as a decode step does (one layer's fc1 is
    # 33.5 MB, within the 50 MB L2).
    def qmm_time(G, K, N, out_dtype, layers, M):
        w = torch.randint(-127, 128, (layers, G, K, N), dtype=torch.int8, device="cuda",
                          generator=gen)
        scale = torch.rand((layers, G, 1, N), device="cuda", generator=gen) * 1e-3 + 1e-4
        w_bf16 = torch.empty(w.shape, dtype=torch.bfloat16, device="cuda")
        for l in range(layers):
            w_bf16[l] = (w[l].float() * scale[l]).to(torch.bfloat16)
        lib_w = w_bf16[:, 0] if G == 1 else w_bf16
        x = randn(gen, M, K)
        idx = itertools.cycle(range(layers))

        def kernel():
            l = next(idx)
            return qmm_int8(x, w[l], scale[l], out_dtype)

        def plain_version():
            l = next(idx)
            return qmm_int8_plain(x, w[l], scale[l], out_dtype)

        ms = device_ms(kernel, 26 * 8)
        plain = device_ms(plain_version, 26)
        lib = device_ms(lambda: torch.matmul(x, lib_w[next(idx)]), 26 * 8)
        out_bytes = 4 if out_dtype == torch.float32 else 2
        b, by = bound(M * K * 2 + G * K * N + G * N * 4 + M * G * N * out_bytes, 2 * M * G * K * N)
        return ms, plain, lib, b, by

    step = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0)
    shapes = [(name, 1, k, n, torch.bfloat16, L) for name, (k, n) in PROJECTIONS.items()]
    shapes.append(("heads", *HEADS_SHAPE, torch.float32, 1))
    for name, G, K, N, out_dtype, count in shapes:
        ms, plain, lib, b, by = qmm_time(G, K, N, out_dtype, count, 2)
        for key, v in zip(("ms", "plain", "lib", "bound"), (ms, plain, lib, b)):
            step[key] += count * v
        log(f"time qmm_int8 {name} M=2 G={G} {K}x{N} ({card}): kernel_ms {ms:.5f} plain_ms "
            f"{plain:.4f} library_ms {lib:.5f} (matmul, bf16 weight) bound_ms {b:.5f} ({by})")
        if name == "fc1":
            fc1 = (ms, plain, lib, b, by)
    log(f"time qmm_int8 one decode step, 105 launches ({card}): kernel_ms {step['ms']:.4f} "
        f"plain_ms {step['plain']:.3f} library_ms {step['lib']:.4f} bound_ms {step['bound']:.4f}")
    M = 2 * (cond_len + 1)
    ms, plain, lib, b, by = qmm_time(1, *PROJECTIONS["fc1"], torch.bfloat16, L, M)
    log(f"time qmm_int8 fc1 prefill M={M} ({card}): kernel_ms {ms:.4f} plain_ms {plain:.4f} "
        f"library_ms {lib:.4f} bound_ms {b:.5f} ({by})")
    ms, plain, lib, b, by = fc1
    rows.append(dict(name="qmm_int8", route="cuda", source="zonos_vibes_tpu_torch/csrc/qmm_int8.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/qmm.py:46",
                     launches=e2e["launches"]["qmm_int8"], max_abs_err=errors["qmm_int8"],
                     ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))

    T = cond_len + AUDIO_FRAMES + 9
    T = _find_multiple(T, 512 if T >= 1024 else 8)

    def decode_row(T, fe, sl, label):
        x = decode_inputs(gen, T)
        kq, ks = quantize_rows(x.pop("k_cache"), HKV)
        vq, vs = quantize_rows(x.pop("v_cache"), HKV)
        args = dict(x, k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)
        sc = torch.tensor([fe, sl, 5], dtype=torch.int32, device="cuda")
        n = fe + sl + 1
        kg = torch.cat([dequantize_rows(kq[5, :, :fe], ks[5, :, :fe]).to(torch.bfloat16),
                        x["k_stage"][5, :, :sl], x["k_cur"][:, None]], 1)
        vg = torch.cat([dequantize_rows(vq[5, :, :fe], vs[5, :, :fe]).to(torch.bfloat16),
                        x["v_stage"][5, :, :sl], x["v_cur"][:, None]], 1)
        kg = kg.view(B, n, HKV, D).transpose(1, 2).contiguous()
        vg = vg.view(B, n, HKV, D).transpose(1, 2).contiguous()
        qg = x["q"].transpose(1, 2).contiguous()
        ms = device_ms(lambda: decode_attention_layered_q(**args, scalars=sc), 200)
        plain = device_ms(lambda: decode_attention_layered_q_plain(**args, scalars=sc), 20)
        lib = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True), 200)
        nbytes = 2 * B * fe * (W + HKV * 4) + 2 * B * (sl + 1) * W * 2 + 2 * B * HQ * D * 2
        b, by = bound(nbytes, 4 * B * HQ * n * D)
        log(f"time decode_attention_q {label} T={T} flushed_end={fe} stage_len={sl} ({card}): "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} (SDPA, dequantized "
            f"gathered K/V) bound_ms {b:.5f} ({by})")
        return ms, plain, lib, b, by

    last_pos = cond_len + steps
    fe = cond_len + 1 + ((last_pos - cond_len - 1) // STAGE) * STAGE
    ms, plain, lib, b, by = decode_row(T, fe, last_pos - fe, "main-path last step")
    decode_row(3072, 2944, 127, "30 s depth")
    rows.append(dict(name="decode_attention_q", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:479",
                     launches=e2e["launches"]["decode_attention_q"],
                     max_abs_err=errors["decode_attention_q"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from zonos_vibes_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"tf32 off for matmul and cuDNN")
    t0 = time.perf_counter()
    path, _ = build.build()
    build.load()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    errors = check_kernels()
    errors.update(check_int8_kernels())
    check_backbone_against_cpu()
    check_backbone_against_cpu(int8=True)
    pipe, cond, e2e = run_main_path(card)
    e2e_int8 = run_int8_path(pipe, cond, card)
    del pipe
    torch.cuda.empty_cache()
    rows = time_kernels(e2e, errors, card) + time_int8_kernels(e2e_int8, errors, card)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
