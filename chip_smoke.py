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
   the edge cases of its interface (the prefill attention at every query-
   and key-tile edge, at batches that give it both tile heights, with NaN in
   every cache row at or past offset + S); then the backbone on the card against
   the CPU path on a small input, with bf16 weights and cache and with int8
   weights and an int8 cache. The pool's kernels (pooled decode attention
   with a bf16 and an int8 prefix, the per-row ring splice) at the 8-slot
   pool's shapes (16 CFG rows, cache length 3584), rows at their own
   depths with NaN past each row's base; the decode-attention kernel's
   one-launch design (1000 calls alternating the solo step at T = 528 and
   3072 and the pool give each shape's first bits: every split ticket was
   reset) and bounds (rows 1 and 5 with out-of-range flushed_end and
   stage_len equal their plain versions on the clamped scalars, NaN planes
   around the buffers; a layer outside [0, L) gives NaN); the stage write
   of the five staged templates (rows 1, 5, 6, 6b, 8) at the main paths'
   shapes, V a strided row view, slots inside and outside
   the stage: each stage bit-equal to the plain splice's, NaN planes around
   it untouched; ``qmm_int8`` at
   M <= 2 and the fused Mamba step as one device kernel per call, whose
   calls at alternating shapes repeat each shape's first bits; the pooled backbone step on
   the card against the CPU path, bf16 and int8, with a ring and without
   one (the stage-less pooled decode, row 12 at head dim 64). The hybrid's
   kernels at its shapes: the fused Mamba-2 step (rows 9 and 10) at 2 and
   16 rows with an fp32 and a bf16 state, in place on one plane of a
   42-plane stack whose other planes are NaN and must stay so; rows 11 and
   12 and the head-dim-128 variants of rows 3 and 6, NaN past every bound;
   and the hybrid backbone on the card against the CPU path on a small
   input: solo decode, pooled ring (fp32 and bf16 state) and stage-less.
   The server's shapes: row 1 at CFG batch 8 and 16, row 3 at batch 8 over
   a bucket-padded conditioning, ``qmm_int8`` at M = 4 and 8, rows 6 and 8
   at the 4-slot pool's 8 rows.
3. End to end: ``ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER)`` with
   random bf16 weights from a seeded generator, text -> about 5 s of codes
   -> DAC -> WAV (written to ``build/chip_smoke.wav``). The launch
   counters are zeroed just before and read just after: every kernel must
   have run on the main path, decode attention 26 times per decode step,
   the standalone stage splices never (the decode-attention calls store
   the columns).
   Then clone + continuation on the same pipeline: the speaker embedding
   (``make_speaker_embedding``: the ResNet293 from seed 0, its DSP on the
   card) of the main path's own 5.00 s WAV at 44.1 kHz, ``encode_audio``
   of a 5.0 s 24 kHz chirp plus noise (431 frames), then
   ``make_cond_dict(speaker=...)`` and ``generate(cond,
   audio_prefix_codes=...)`` of 431 new frames -> DAC -> WAV
   (``build/chip_smoke_continue.wav``). Held against the port on the CPU:
   the resamples (1e-5) and the log filterbank (1e-4), the embedding
   (max |diff| / max |ref| <= 1e-3) and the encoder latents (<= 1e-4) with
   the same weights, and the codes (at least 99.9% equal; every code that
   differs from the CPU's argmax given the card's earlier stages scores
   within 1e-4 of the CPU's best). Before the run, rows 3 and 1 at its
   shapes against their plain versions (the prefill at B = 2, S = 519,
   offset 0, T = 960: row 3's two-pass path); then exact launch counts
   (26 prefill launches, 26 decode launches per step, no splice), graph
   codes equal to eager, and its speaker, encode, prefill, ms/step and RTF
   lines.
   Then the int8 serving path on the same weights: the first frame's
   next-token distributions before and after ``pipe.quantize_int8()``
   (mean total-variation distance at most 0.05), and
   ``DecodeEngine(model, kv_int8=True)`` for the same 5 s -> DAC -> WAV
   (``build/chip_smoke_int8.wav``) with its own exact launch counts.
   After the clone + continuation run, the HTTP server
   (``serve/server.py``) on the same pipeline, port 0, the main path's WAV
   as the speaker: ``warmup`` of (batch 1, cond bucket 128, 430 frames,
   speaker), then a request in those buckets that must capture nothing;
   the same greedy payload with an explicit seed twice, identical WAV
   bytes; 4 and 8 concurrent compatible requests batched into one decode
   each (ms/step at CFG batch 2, 8 and 16 beside); one stream (time to
   its first PCM chunk); one continuation from the 5.0 s chirp; the
   8-slot pool under 8 arrivals 0.5 s apart, 4 of them streams (their
   chunks from ``make_pool_emit`` on the card; time to first audio and
   aggregate audio-s/s); ``/healthz``, ``/metrics``, ``/``, a 400 and a
   404 and 2 requests on a 4-slot pool. After the int8 path, a pooled
   server on the int8 pipeline with an int8 KV pool serves 2 requests and
   2 job-path requests in one batch. Every server's ``errors_total``,
   ``replayed_requests`` and ``pool_admit_failures`` must stay 0.
   After each of the two, the continuous-batching pool on the same weights
   (``engine/pool.py``; bf16 KV after the bf16 path, int8 KV after the int8
   path): ``PoolConfig(slots=8)``, 8 requests of 431 frames joining one per
   43-step segment, run until every row finishes, each row decoded to
   ``build/chip_smoke_pool{,_int8}_row{s}.wav``; row 0's codes alone in a
   pool equal its codes in the full pool for 86 frames, and the launch
   counts are exact.
   Then the hybrid (``ZONOS_V01_HYBRID``: 42 Mamba-2 and 6 attention
   layers, random bf16 weights from seed 422): text -> 5 s WAV
   (``build/chip_smoke_hybrid.wav``) with exact counts (42 fused Mamba
   steps and 6 row-11 launches per decode step, 6 prefill launches, every
   transformer-only kernel 0); its pool, as above with fp32 SSM state
   (``build/chip_smoke_pool_hybrid_row{s}.wav``; 42 Mamba steps and 6 row-6
   launches per pooled step, no ring splice, 6 prefill launches per
   join); then 43 stage-less pooled steps (row 12, 6 per step) from a copy
   of the pool's state after its last join, each step's logits held
   against the ring mode's from the same state; with plain attention the
   two modes must agree exactly, and with each stage-less column written
   one position off they must differ by more than the limit.
   Every solo path and every pool runs twice on the same seed and inputs:
   through its entry point, which on the card captures one decode step as
   a CUDA graph and replays it (``engine/graphs.py``), and eagerly
   (``DecodeEngine(..., cuda_graphs=False)``, ``make_pool(...,
   cuda_graphs=False)``). The codes must be equal, both runs' launch counts
   must equal the same expected counts (a replayed step counts the
   launches its capture recorded), and the graph run must have replayed
   every step after its first; the run prints both runs' ms/step beside the
   step's bound, the capture time and the stop test's host reads. The bf16
   main path also streams: ``generate_stream`` in 43-step chunks, whose
   last cumulative codes equal the one-shot codes, and the pipeline's
   audio stream against one-shot audio, with the times to the first chunk.
4. Timing: each kernel, its plain version and the one PyTorch call that
   computes the same function, at the shapes the main path gave it, beside
   the least time the card could take for the same work; the staged
   decode rows with their stage write, as the main path calls them, the
   timed calls' stage held against the plain splice, the standalone
   splices beside them; ``qmm_int8`` at
   the solo step's 2 rows, the pooled step's 16 and the prefill's fc1 at
   2 * (cond_len + 1) rows; the prefill attention (row 3, both head dims)
   at the main path's chunk and at long chunks (S = 2048 at offset 0,
   S = 512 at offset 64) beside SDPA and the flops bound, and rows 3 and 1
   at the continuation's prefill and last step; the pool's kernels at
   16 rows over a 3584-position cache, at the main path's spread of depths
   and at spreads near 1800 and near 3000 positions; the hybrid's kernels
   at its paths' shapes (the fused Mamba step with its 42 planes cycled,
   so each launch reads its state from device memory; no single PyTorch
   call computes it, so it has no library time); the server's shapes (rows
   1 and 3 at its batches, ``qmm_int8``'s 105 launches at M = 4 and 8, rows
   6 and 8 at 8 rows).

Before them a ``{"graphs": ...}`` line gathers each path's eager and graph
ms/step, bound, capture time and host reads. The second-to-last line is
``{"kernels": [...]}``, the line before it the card's name and power limit,
and the last line
``{"ok": true, "device": {...}}``. Each kernel's ``launches`` in the
kernels line is one path's count: ``prefill_attention_continuation`` and
``decode_attention_continuation`` those of the clone + continuation run,
the pool kernels' that of their own pool
run (``stage_splice_rows``: the bf16 pool's), ``qmm_int8``'s the solo int8
path's; ``qmm_int8_m16_step`` (the pooled step's 105 launches at 16 rows,
timed as their sum) lists those counted during the int8 pool run's pooled
steps, and ``qmm_int8_m176_fc1`` the fc1 launches of the solo int8 path's
prefill, one per layer, at 2 * (cond_len + 1) rows; the
server's lines those of its runs (``decode_attention_b8``/``_b16`` and
``prefill_attention_b8``: the batches of 4 and 8 requests;
``decode_attention_pooled_r8``: the 4-slot pool's 2 requests;
``decode_attention_pooled_q_r8`` and ``qmm_int8_m8_step``: the int8 pool's;
``qmm_int8_m4_step``: the int8 job-path batch's, its prefill's included),
the hybrid's those of the hybrid's paths (the fused Mamba step is
one kernel with two entries, counted under ``ssd_gate_step``: row 9 lists
the solo path's launches, row 10 the pool's). Without a CUDA device, or without the
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
# The pooled attention kernels are also held row by row: each row's largest
# |error| over that row's largest |output|. A deep row's outputs are ~0.06
# at most (randn values over ~3000 positions), so an absolute limit set by
# the shallow rows (outputs up to ~4) would pass a deep row that lost a
# 256-position split (~25% of its largest output); the legitimate error is
# the bf16 rounding of the output and, for row 6's plain version, of its
# probabilities: under 1% of the row's largest output.
POOL_ROW_TOL = {"decode_attention_pooled": 2e-2, "decode_attention_pooled_q": 1e-2}
TVD_LIMIT = 0.05
PROJECTIONS = {"in_proj": (2048, 3072), "out_proj": (2048, 2048), "fc1": (2048, 16384),
               "fc2": (8192, 2048)}
HEADS_SHAPE = (9, 2048, 1152)
AUDIO_FRAMES = 431  # ~5 s at 86.13 frames/s
FRAME_RATE = 86.13
TEXT = "It would be nice to have time for testing, indeed. The port runs on the card now."
# The continuous-batching pool: 8 slots (16 CFG rows, cache length 3584),
# one join per 43-step segment (the server's segment_steps).
POOL_SLOTS, POOL_SEGMENT, POOL_T, POOL_SEED = 8, 43, 3584, 421
POOL_M = 2 * POOL_SLOTS  # rows of every pooled projection and of the heads
POOL_TEXTS = [TEXT, "Hello there. This is the second request in the pool.",
              "A third voice joins a little later, at its own position.",
              "Continuous batching shares every weight read between requests.",
              "The fifth request arrives while four others are still speaking.",
              "Six requests now decode together, each at its own depth.",
              "Seven rows, one step, and no row waits for another.",
              "The last request fills the pool; the first is almost done."]
ISOLATION_FRAMES = 86
# The transformer's paths launch none of the hybrid's kernels, and its solo
# paths none of the pool's.
NO_HYBRID_LAUNCHES = {"decode_attention_unstaged": 0, "decode_attention_pooled_unstaged": 0,
                      "ssd_gate_step": 0}
NO_POOL_LAUNCHES = {"decode_attention_pooled": 0, "decode_attention_pooled_q": 0,
                    "stage_splice_rows": 0, **NO_HYBRID_LAUNCHES}
# Per-row (base, ring length) pairs for the pooled kernels' checks: empty,
# one-position and chunk-edge prefixes, mid and deep rows, empty to full-but-one rings.
POOL_BASES = [0, 1, 255, 256, 500, 1800, 3000, 3456] * 2
POOL_LENS = [0, 1, 5, 127, 1, 5, 127, 0, 127, 0, 1, 5, 5, 127, 0, 1]


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


def decode_inputs(gen, T, Bx=B):
    return dict(q=randn(gen, Bx, 1, HQ, D), k_cache=randn(gen, L, Bx, T, W),
                v_cache=randn(gen, L, Bx, T, W), k_stage=randn(gen, L, Bx, STAGE, W),
                v_stage=randn(gen, L, Bx, STAGE, W), k_cur=randn(gen, Bx, W),
                v_cur=randn(gen, Bx, W))


def check_kernels() -> dict:
    """Phase 2: every kernel against its plain version; max |error| each."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain)
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

    err["prefill_attention"] = check_prefill(gen, HQ, HKV, D)
    return err


# Prefill chunk lengths for the checks: the 16-row warp tiles' and 32-key
# tiles' edges, the main path's ~88 and a long chunk.
PREFILL_S = (1, 7, 16, 17, 32, 33, 63, 64, 65, 88, 97, 600)


def check_prefill(gen, Hq, Hkv, Dh) -> float:
    """Row 3 against its plain version at both tile heights, every cache row
    at or past offset + S NaN (never read); the plain version reads the
    cache only up to offset + S. The kernel takes 64-row tiles when their
    grid covers at least half of the 132 SMs, else 32-row ones: one batch
    row keeps each chunk of up to 97 positions under that, 17 put it over;
    the 600-position chunk takes 64-row tiles at any batch."""
    worst = 0.0
    for S in PREFILL_S:
        for offset in (0, 64):
            for Bs in (1, 17) if S <= 128 else (B,):
                worst = max(worst, check_prefill_case(gen, Bs, S, offset, 768, Hq, Hkv, Dh))
    log(f"kernel prefill_attention D={Dh} Hq={Hq} Hkv={Hkv}: S {'/'.join(map(str, PREFILL_S))} x "
        f"offset 0/64 x batch 1 and 17 (32- and 64-row tiles; S = 600 at batch {B}), NaN in every "
        f"cache row at or past offset + S: max_abs_err {worst:.3e} <= {TOL}")
    return worst


def check_prefill_case(gen, Bs, S, offset, T, Hq, Hkv, Dh) -> float:
    """Row 3 at one shape against its plain version, every cache row at or
    past offset + S NaN; returns the max |error|."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import (
        prefill_attention, prefill_attention_plain)

    q = randn(gen, Bs, S, Hq, Dh)
    k, v = randn(gen, Bs, T, Hkv * Dh), randn(gen, Bs, T, Hkv * Dh)
    end = offset + S
    want = prefill_attention_plain(q, k[:, :end], v[:, :end], offset).float()
    k[:, end:] = float("nan")
    v[:, end:] = float("nan")
    got = prefill_attention(q, k, v, offset).float()
    e = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or e > TOL:
        raise AssertionError(f"prefill_attention D={Dh} S={S} offset={offset} B={Bs} T={T}: "
                             f"err {e}")
    return e


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
        for M in (1, 2, POOL_M, 176):
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
        f"M 1/2/{POOL_M}/176) max_abs_err {worst:.3e} within |err| <= atol + rtol |y| {QMM_TOL}")

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


def pool_decode_inputs(gen, T, bases, lens):
    """Pooled attention inputs for 16 rows; each row's prefix at or past its
    base is NaN (never read)."""
    import torch

    Bp = len(bases)
    x = dict(q=randn(gen, Bp, 1, HQ, D), k_cache=randn(gen, L, Bp, T, W),
             v_cache=randn(gen, L, Bp, T, W), k_stage=randn(gen, L, Bp, STAGE, W),
             v_stage=randn(gen, L, Bp, STAGE, W), k_cur=randn(gen, Bp, W),
             v_cur=randn(gen, Bp, W),
             bases=torch.tensor(bases, dtype=torch.int32, device="cuda"),
             lens=torch.tensor(lens, dtype=torch.int32, device="cuda"))
    for b, base in enumerate(bases):
        x["k_cache"][:, b, base:] = float("nan")
        x["v_cache"][:, b, base:] = float("nan")
    return x


def quantized(x):
    """The same inputs with an int8 prefix (NaN positions give NaN scales)."""
    from zonos_vibes_tpu_torch.ops import quant

    xq = dict(x)
    for name in ("k", "v"):
        xq[name + "_cache"], xq[name + "_scale"] = quant.quantize_rows(x[name + "_cache"], HKV)
    return xq


def row_rel_err(got, want) -> float:
    """The largest, over rows (dim 0), of a row's largest |got - want| over
    its largest |want|."""
    g, w = got.float().flatten(1), want.float().flatten(1)
    return ((g - w).abs().amax(1) / w.abs().amax(1)).max().item()


def check_pool_kernels() -> dict:
    """Phase 2, the pool's kernels against their plain versions at the
    8-slot pool's shapes."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_pooled_staged, decode_attention_pooled_staged_plain,
        decode_attention_pooled_staged_q, decode_attention_pooled_staged_q_plain)
    from zonos_vibes_tpu_torch.ops.cuda.stage_write import (
        stage_splice_rows, stage_splice_rows_plain)

    gen = torch.Generator(device="cuda").manual_seed(7)
    err = {}
    for name, kernel, plain, tol, quant in (
            ("decode_attention_pooled", decode_attention_pooled_staged,
             decode_attention_pooled_staged_plain, TOL, False),
            ("decode_attention_pooled_q", decode_attention_pooled_staged_q,
             decode_attention_pooled_staged_q_plain, Q_TOL, True)):
        worst = worst_rel = 0.0
        row_tol = POOL_ROW_TOL[name]
        for shift in (0, 5):  # two pairings of bases with ring lengths
            lens = POOL_LENS[shift:] + POOL_LENS[:shift]
            x = pool_decode_inputs(gen, POOL_T, POOL_BASES, lens)
            if quant:
                x = quantized(x)
            for layer in (0, 25):
                got = kernel(**x, layer=layer).float()
                want = plain(**x, layer=layer).float()
                e = (got - want).abs().max().item()
                rel = row_rel_err(got, want)
                if not torch.isfinite(got).all() or e > tol or rel > row_tol:
                    raise AssertionError(f"{name} shift={shift} layer={layer}: err {e}, "
                                         f"per-row relative err {rel}")
                worst, worst_rel = max(worst, e), max(worst_rel, rel)
            del x
        err[name] = worst
        log(f"kernel {name}: B=16 T={POOL_T}, bases {sorted(set(POOL_BASES))}, lens 0/1/5/127 "
            f"in two pairings, layers 0/25, NaN past each base: max_abs_err {worst:.3e} <= {tol}; "
            f"per row, max |err| / max |out| {worst_rel:.3e} <= {row_tol}")

    for shift in range(4):
        stage = randn(gen, L, 16, STAGE, W)
        cols = randn(gen, L, 16, W)
        order = [0, 7, 8, 127]
        slots = torch.tensor([order[(b + shift) % 4] for b in range(16)], dtype=torch.int32,
                             device="cuda")
        want = stage_splice_rows_plain(stage.clone(), cols, slots)
        got = stage_splice_rows(stage, cols, slots)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stage_splice_rows shift={shift}: differs from the plain version")
    err["stage_splice_rows"] = 0.0
    log("kernel stage_splice_rows: B=16, slots 0/7/8/127 mixed over rows (4 pairings) "
        "bit-exact, other slots untouched")
    return err


def check_decode_one_launch() -> None:
    """Phase 2, the decode-attention kernel's one-launch design and bounds:
    1000 back-to-back calls alternating the solo step at T = 528 and 3072
    (26 layers, CFG batch 2) and the pool (16 rows, T = 3584) give each
    shape's first bits every time (every split ticket was reset); rows 1 and
    5 with flushed_end past T or negative and stage_len past STAGE or
    negative equal their plain versions on the clamped scalars with NaN
    planes on both sides of the cache and the stage (nothing outside read),
    and a layer outside [0, L) gives an all-NaN output."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain, decode_attention_layered_q,
        decode_attention_layered_q_plain, decode_attention_pooled_staged)
    from zonos_vibes_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(17)
    calls = []
    for T, fe, sl in ((528, 472, 54), (3072, 2944, 127)):
        x = decode_inputs(gen, T)
        sc = torch.tensor([fe, sl, L - 1], dtype=torch.int32, device="cuda")
        calls.append(lambda x=x, sc=sc: decode_attention_layered(**x, scalars=sc))
    xp = pool_decode_inputs(gen, POOL_T, POOL_BASES, POOL_LENS)
    calls.append(lambda: decode_attention_pooled_staged(**xp, layer=L - 1))
    first = [c() for c in calls]
    outs = [calls[i % 3]() for i in range(1000)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        if not torch.equal(got, first[i % 3]):
            raise AssertionError(f"decode attention call {i}: bits differ from the first call")
    del calls, xp, outs
    log("kernel decode attention, one launch: 1000 calls alternating T=528, T=3072 (B=2) and "
        f"the pool (B=16, T={POOL_T}) bit-equal to each shape's first call")

    T = 528

    def padded(shape, dtype=torch.bfloat16, fill=float("nan")):
        full = torch.full((shape[0] + 2, *shape[1:]), fill, dtype=dtype, device="cuda")
        return full, full[1:-1]

    x = {"q": randn(gen, B, 1, HQ, D), "k_cur": randn(gen, B, W), "v_cur": randn(gen, B, W)}
    for name, rows in (("k_cache", T), ("v_cache", T), ("k_stage", STAGE), ("v_stage", STAGE)):
        _, x[name] = padded((L, B, rows, W))
        x[name].copy_(randn(gen, L, B, rows, W))
    xq = dict(x)
    for name in ("k", "v"):
        q8, sc8 = quant.quantize_rows(x[name + "_cache"], HKV)
        _, xq[name + "_cache"] = padded(q8.shape, torch.int8, 0)
        _, xq[name + "_scale"] = padded(sc8.shape, torch.float32)
        xq[name + "_cache"].copy_(q8)
        xq[name + "_scale"].copy_(sc8)
    worst = 0.0
    for name, kernel, plain, args, tol in (
            ("decode_attention", decode_attention_layered, decode_attention_layered_plain, x, TOL),
            ("decode_attention_q", decode_attention_layered_q, decode_attention_layered_q_plain,
             xq, Q_TOL)):
        for fe, sl, layer in ((T + 7, 5, L - 1), (2 * T, STAGE + 50, L - 1), (-3, 4, 0),
                              (400, -9, 1), (-1, STAGE + 1, L - 1)):
            got = kernel(**args, scalars=torch.tensor([fe, sl, layer], dtype=torch.int32,
                                                      device="cuda")).float()
            clamped = torch.tensor([min(max(fe, 0), T), min(max(sl, 0), STAGE), layer],
                                   dtype=torch.int32, device="cuda")
            want = plain(**args, scalars=clamped).float()
            e = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or e > tol:
                raise AssertionError(f"{name} scalars ({fe}, {sl}, {layer}): err {e}")
            worst = max(worst, e)
        for layer in (-1, L):
            got = kernel(**args, scalars=torch.tensor([400, 5, layer], dtype=torch.int32,
                                                      device="cuda"))
            if not torch.isnan(got).all():
                raise AssertionError(f"{name} layer {layer}: output not all NaN")
    log(f"kernel decode_attention/_q bounds: flushed_end T+7/2T/-3/-1, stage_len -9/STAGE+1/"
        f"STAGE+50 equal the plain versions on clamped scalars with NaN planes around the cache "
        f"and stage (max_abs_err {worst:.3e}); layers -1 and {L} give all-NaN outputs")


def check_stage_write() -> dict:
    """Phase 2, the stage write of the five staged templates (rows 1, 5, 6,
    6b and 8, as the backbones call them): at the main
    paths' per-layer shapes (the solo step: CFG batch 2, T = 528; the pools:
    16 rows over 3584 positions at head dim 64, and the hybrid's at 128),
    three layers inside a stage buffer with a NaN plane on each side, V a
    strided row view of a [B, 3W] buffer as the qkv projection's output
    gives it. Solo slots 0, 54, STAGE - 1, -1 and STAGE; pooled slots mixed
    over the rows, -1 and STAGE among them; layers 0 and 2. Each call's
    output against the plain version, its whole guarded stage bit for bit
    against the plain version's (``stage_splice_plain`` /
    ``stage_splice_rows_plain`` on the layer's plane), and nothing but the
    in-range slots of the layer's plane changed; a layer outside [0, L)
    (rows 1 and 5) gives NaN and writes nothing. Returns the largest
    output error per kernel name."""
    import torch

    from zonos_vibes_tpu_torch.ops import quant
    from zonos_vibes_tpu_torch.ops.cuda import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(29)
    Lw = 3

    def bits(t):
        return t.view(torch.int16)

    cases = (("decode_attention", da.decode_attention_layered,
              da.decode_attention_layered_plain, False, HQ, HKV, D, TOL),
             ("decode_attention_q", da.decode_attention_layered_q,
              da.decode_attention_layered_q_plain, False, HQ, HKV, D, Q_TOL),
             ("decode_attention_pooled", da.decode_attention_pooled_staged,
              da.decode_attention_pooled_staged_plain, True, HQ, HKV, D, TOL),
             ("decode_attention_pooled_q", da.decode_attention_pooled_staged_q,
              da.decode_attention_pooled_staged_q_plain, True, HQ, HKV, D, Q_TOL),
             ("decode_attention_pooled_hd128", da.decode_attention_pooled_staged,
              da.decode_attention_pooled_staged_plain, True, H_HQ, H_HKV, H_D, TOL))
    err, calls = {}, 0
    for name, kernel, plain, pooled, hq, hkv, d, tol in cases:
        bx, T, w = (POOL_M, POOL_T, hkv * d) if pooled else (B, 528, hkv * d)
        x = dict(q=randn(gen, bx, 1, hq, d), k_cache=randn(gen, Lw, bx, T, w),
                 v_cache=randn(gen, Lw, bx, T, w), k_cur=randn(gen, bx, w),
                 v_cur=randn(gen, bx, 3 * w)[:, w:2 * w])
        if name.endswith("_q"):
            for n in ("k", "v"):
                x[n + "_cache"], x[n + "_scale"] = quant.quantize_rows(x[n + "_cache"], hkv)
        full = {}
        for n in ("k_stage", "v_stage"):
            full[n] = torch.full((Lw + 2, bx, STAGE, w), float("nan"), dtype=torch.bfloat16,
                                 device="cuda")
            full[n][1:-1] = randn(gen, Lw, bx, STAGE, w)
        if pooled:
            x["bases"] = torch.tensor(POOL_BASES, dtype=torch.int32, device="cuda")
            lens = [(23 * b) % STAGE for b in range(bx)]
            lens[:4] = [-1, STAGE, STAGE - 1, 0]
            variants = [(dict(lens=torch.tensor(ln, dtype=torch.int32, device="cuda")), ln)
                        for ln in (lens, lens[::-1])]
        else:
            variants = [(dict(scalars=torch.tensor([472, s, 0], dtype=torch.int32,
                                                   device="cuda")), [s] * bx)
                        for s in (0, 54, STAGE - 1, -1, STAGE)]
        worst = 0.0
        for layer in (0, Lw - 1):
            for kw, slots in variants:
                kw = dict(kw)
                if pooled:
                    kw["layer"] = layer
                else:
                    kw["scalars"] = kw["scalars"].clone()
                    kw["scalars"][2] = layer
                outs, stages = [], []
                for fn in (kernel, plain):
                    st = {n: t.clone() for n, t in full.items()}
                    outs.append(fn(**x, k_stage=st["k_stage"][1:-1], v_stage=st["v_stage"][1:-1],
                                   **kw).float())
                    stages.append(st)
                torch.cuda.synchronize()
                e = (outs[0] - outs[1]).abs().max().item()
                for n in full:
                    changed = (bits(stages[0][n]) != bits(full[n])).any(-1)
                    where = torch.zeros_like(changed)
                    for b, s in enumerate(slots):
                        if 0 <= s < STAGE:
                            where[1 + layer, b, s] = True
                    if (not torch.equal(bits(stages[0][n]), bits(stages[1][n]))
                            or not torch.equal(changed, where)):
                        raise AssertionError(f"{name} stage write, layer {layer}, slots {slots}: "
                                             f"{n} differs from the plain version's or a byte "
                                             f"outside the slots changed")
                if not torch.isfinite(outs[0]).all() or e > tol:
                    raise AssertionError(f"{name} with the stage write, layer {layer}: err {e}")
                worst, calls = max(worst, e), calls + 1
        if not pooled:
            for layer in (-1, Lw):
                st = {n: t.clone() for n, t in full.items()}
                got = kernel(**x, k_stage=st["k_stage"][1:-1], v_stage=st["v_stage"][1:-1],
                             scalars=torch.tensor([472, 5, layer], dtype=torch.int32,
                                                  device="cuda"))
                torch.cuda.synchronize()
                if not torch.isnan(got).all() or not all(
                        torch.equal(bits(st[n]), bits(full[n])) for n in full):
                    raise AssertionError(f"{name} layer {layer} with the stage write: output not "
                                         f"all NaN, or the stage written")
        err[name] = worst
        del x, full
    log(f"kernel decode attention stage write (rows 1/5/6/8 at head dim 64, 6b at 128): {calls} "
        f"writing calls at the main paths' shapes, V a strided row view, slots 0/54/STAGE-1 "
        f"and -1/STAGE (outside: no write), NaN planes around the stage: every stage bit-equal "
        f"to the plain splice's, nothing outside the in-range slots changed, outputs within "
        f"tolerance (max_abs_err {max(err.values()):.3e}); layers -1 and 3 write nothing")
    return err


def check_step_kernels_one_launch() -> None:
    """Phase 2, the one-launch designs of ``qmm_int8`` at M <= 2 and of the
    fused Mamba step: each call is one device kernel (``torch.profiler``),
    and 300 calls alternating the five projections' shapes (M = 2, and M = 1
    for fc2, whose K is split in a cluster) and the Mamba step's four (B = 2
    and 16, fp32 and bf16 state, each from a fresh copy of its plane) give
    each shape's first bits: nothing is kept from one call to the next."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.ops.cuda.mamba_step import ssd_gate_step_layered
    from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8

    gen = torch.Generator(device="cuda").manual_seed(19)
    calls = {}  # name: (set-up before the call or None, the call, its state or None)
    shapes = [(name, 1, k, n, torch.bfloat16) for name, (k, n) in PROJECTIONS.items()]
    shapes.append(("heads", *HEADS_SHAPE, torch.float32))
    for name, G, K, N, out_dtype in shapes:
        w = torch.randint(-127, 128, (G, K, N), dtype=torch.int8, device="cuda", generator=gen)
        scale = torch.rand((G, 1, N), device="cuda", generator=gen) * 1e-3 + 1e-4
        x = randn(gen, 1 if name == "fc2" else 2, K)
        calls[f"qmm_int8 {name}"] = (
            None, lambda x=x, w=w, scale=scale, o=out_dtype: qmm_int8(x, w, scale, o), None)
    for Bs in (B, POOL_M):
        for sdt, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            states, x = ssd_inputs(gen, Bs, 2, sdt)
            states.normal_(generator=gen)
            init = states.clone()
            calls[f"ssd_gate_step B={Bs} {label}"] = (
                lambda states=states, init=init: states.copy_(init),
                lambda states=states, x=x: ssd_gate_step_layered(states, 1, **x), states)

    def run(name):
        prepare, call, state = calls[name]
        if prepare is not None:
            prepare()
        out = call()
        return [out] if state is None else [out, state.clone()]

    # A throwaway first session, so that the profiler's own start-up cannot
    # cost the counted sessions below a kernel (one run saw 0 kernels in
    # the first counted session; tools/profiler_first_session.py did not
    # reproduce it). Each counted session also reads the wrapper's launch
    # count, which tells a kernel the profiler missed from a missed launch.
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()
    for name, (prepare, call, _) in calls.items():
        run(name)
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        launched = build.LAUNCHES[name.split()[0]]
        if len(kernels) != 1 or launched != 1:
            raise AssertionError(f"{name}: {len(kernels)} device kernels in one call (wrapper "
                                 f"launches {launched}): {kernels}")
    names = list(calls)
    first = [run(n) for n in names]
    for i in range(300):
        got, want = run(names[i % len(names)]), first[i % len(names)]
        if not all(torch.equal(g.view(torch.uint8), w_.view(torch.uint8))
                   for g, w_ in zip(got, want)):
            raise AssertionError(f"{names[i % len(names)]}, call {i}: bits differ from the first")
    torch.cuda.synchronize()
    log(f"kernels qmm_int8 (M <= 2) and ssd_gate_step: one device kernel per call "
        f"(torch.profiler) for {len(names)} shapes; 300 calls alternating them give each "
        f"shape's first bits (output and state)")


def check_pooled_backbone_against_cpu(int8: bool = False, ring: bool = True) -> float:
    """The pooled backbone step on the card (pooled kernels) against the
    CPU path (plain versions) on a small input: 2 layers at the flagship's
    head geometry, 2 slots (4 CFG rows) at positions 20 and 9 over a random
    flushed prefix, 14 pooled steps with a ring flush every 6; with
    ``int8``, int8 projections and an int8 KV cache. Without ``ring`` the
    stage-less pooled decode (row 12): no ring, each step's columns written
    at the rows' positions. Returns the largest |difference| of the hidden
    states."""
    import torch

    from zonos_vibes_tpu_torch.config import BackboneConfig, _freeze
    from zonos_vibes_tpu_torch.engine.pool import flush_pool_rings
    from zonos_vibes_tpu_torch.models import backbone
    from zonos_vibes_tpu_torch.ops.quant import quantize_backbone_params, quantize_rows
    from zonos_vibes_tpu_torch.ops.rope import rope_table

    cfg = BackboneConfig(d_model=256, n_layer=2, attn_mlp_d_intermediate=512,
                         attn_cfg=_freeze({"num_heads": 4, "num_heads_kv": 2}))
    gen = torch.Generator().manual_seed(4)
    params = backbone.init_transformer_backbone(gen, cfg, torch.bfloat16, "cpu")
    if int8:
        params = quantize_backbone_params(params)
    Lt, Bt, Tt, St, Wt = cfg.n_layer, 4, 64, 8, 2 * 64
    prefix = {n: torch.randn(Lt, Bt, Tt, Wt, generator=gen).to(torch.bfloat16) for n in "kv"}

    def setup(dev):
        p = {"layers": {n: {k: t.to(dev) for k, t in leaf.items()}
                        for n, leaf in params["layers"].items()},
             "norm_f": {k: t.to(dev) for k, t in params["norm_f"].items()}}
        cache = backbone.allocate_kv_cache(cfg, Bt, Tt, torch.bfloat16, dev, kv_int8=int8)
        for n in "kv":
            if int8:
                cache[n], cache[n + "_scale"] = (t.to(dev) for t in quantize_rows(prefix[n], 2))
            else:
                cache[n] = prefix[n].to(dev)
            cache[n + "_stage"] = torch.zeros(Lt, Bt, St, Wt, dtype=torch.bfloat16, device=dev)
        pos = torch.tensor([20, 9], device=dev)
        return {"p": p, "pool": {"cache": cache, "pos": pos, "flush_base": pos.clone()},
                "rope": rope_table(64, device=dev)}

    sides = {dev: setup(dev) for dev in ("cpu", "cuda")}
    inputs = [torch.randn(Bt, 1, 256, generator=gen).to(torch.bfloat16) for _ in range(14)]
    worst = 0.0
    with torch.inference_mode():
        for i, x in enumerate(inputs):
            outs = {}
            for dev, side in sides.items():
                pool = side["pool"]
                outs[dev] = backbone.transformer_forward(
                    side["p"], cfg, x.to(dev), pool["cache"], 0, side["rope"],
                    positions=torch.cat([pool["pos"], pool["pos"]]),
                    pool_base=torch.cat([pool["flush_base"], pool["flush_base"]]) if ring
                    else None)
                pool["pos"] = pool["pos"] + 1
                if ring and i % 6 == 5:
                    flush_pool_rings(pool)
            diff = (outs["cuda"].float().cpu() - outs["cpu"].float()).abs().max().item()
            if diff > 0.1:
                raise AssertionError(f"pooled backbone card vs CPU, step {i}: max |diff| {diff}")
            worst = max(worst, diff)
    kind = "int8 weights and KV cache" if int8 else "bf16"
    mode = "14 steps across two ring flushes" if ring else "14 stage-less steps (row 12)"
    log(f"reference: pooled backbone on the card vs the CPU plain path, {kind}, 4 rows at "
        f"positions 20/9, {mode}: max |hidden diff| {worst:.3e} <= 0.1")
    return worst


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


# The least time a decode step could take (PERF.md section 2): the weights
# read once per step at 3.35 TB/s, with the hybrid's fp32 SSM state read
# and written (CFG batch 2 solo, 16 rows pooled). KV reads are left out.
STEP_BOUND_MS = {"bf16": 0.955, "int8": 0.478, "hybrid": 0.89 + 0.105}
POOL_STEP_BOUND_MS = {"bf16": 0.955, "int8": 0.478, "hybrid": 0.89 + 0.84}


def graph_against_eager(label: str, model, params, prefix, graph, want: dict, per_step: dict,
                        bound_ms: float, card: str, prefix_codes=None, **engine_kw) -> dict:
    """The eager counterpart of a counted generate that replayed its
    captured step (``graph``): the same seed and inputs (``prefix_codes``:
    the audio prefix) through ``DecodeEngine(cuda_graphs=False)``. Codes, valid lengths and steps must
    be equal, the eager run's launch counts must equal ``want`` as the graph
    run's do (the eager steps' plus the captured step's ``per_step`` times
    the replays), and the graph run must have replayed every step after its
    first. Returns the two runs' numbers."""
    import torch

    from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
    from zonos_vibes_tpu_torch.ops.cuda import build

    engine = DecodeEngine(model, cuda_graphs=False, **engine_kw)
    engine.generate(params, prefix, generator=torch.Generator("cuda").manual_seed(1),
                    max_new_tokens=8, disable_eos=True)
    build.reset_launches()
    eager = engine.generate(params, prefix, prefix_codes,
                            generator=torch.Generator("cuda").manual_seed(421),
                            max_new_tokens=AUDIO_FRAMES, disable_eos=True)
    launches = dict(build.LAUNCHES)
    steps = graph.steps
    if (eager.steps != steps or not torch.equal(eager.codes, graph.codes)
            or eager.valid_length != graph.valid_length
            or not torch.equal(eager.valid_lengths, graph.valid_lengths)):
        raise AssertionError(f"{label}: graph codes differ from the eager run's (steps {steps} "
                             f"vs {eager.steps})")
    if launches != want:
        raise AssertionError(f"{label} eager launch counts {launches}, expected {want}")
    if (eager.replays, graph.replays) != (0, steps - 1) or graph.step_launches != per_step:
        raise AssertionError(f"{label}: {graph.replays} replays of {steps} steps capturing "
                             f"{graph.step_launches}, expected {steps - 1} of {per_step}")
    out = {"eager_ms_per_step": eager.decode_seconds * 1e3 / steps,
           "graph_ms_per_step": (graph.decode_seconds - graph.capture_seconds) * 1e3 / steps,
           "capture_ms": graph.capture_seconds * 1e3, "reads": graph.host_reads,
           "eager_reads": eager.host_reads, "bound_ms": bound_ms, "replays": graph.replays,
           "step_launches": graph.step_launches}
    log(f"graphs {label} ({card}): {steps} steps, codes equal to the eager run's; eager "
        f"{out['eager_ms_per_step']:.3f} ms/step, graph {out['graph_ms_per_step']:.3f} ms/step "
        f"(capture {out['capture_ms']:.1f} ms once, not in the figure; with it "
        f"{graph.decode_seconds * 1e3 / steps:.3f}), bound {bound_ms:.3f} ms/step; host reads "
        f"per generate {graph.host_reads} (eager {eager.host_reads}); {graph.replays} replays "
        f"of {per_step} + the eager steps' launches = {want}")
    return out


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
    want = {"decode_attention": L * steps, "decode_attention_q": 0, "stage_splice": 0,
            "prefill_attention": L, "qmm_int8": 0, **NO_POOL_LAUNCHES}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.wav").write_bytes(wav_bytes(wav[0], pipe.dac.sampling_rate))
    prefix = pipe.prepare_conditioning(cond)
    graphs = graph_against_eager("bf16", pipe.model, pipe.params, prefix, result, want,
                                 {"decode_attention": L}, STEP_BOUND_MS["bf16"], card)
    stream = run_stream(pipe, cond, result, card)

    audio_s = wav.shape[-1] / pipe.dac.sampling_rate
    e2e = {
        "cond_len": cond_len, "steps": steps, "audio_s": audio_s,
        "prefill_ms": result.prefill_seconds * 1e3,
        "decode_ms_per_step": result.decode_seconds * 1e3 / steps,
        "generate_s": t_gen, "dac_ms": t_dac * 1e3, "rtf": audio_s / (t_gen + t_dac),
        "launches": launches, "graphs": graphs, "stream": stream, "wav": wav[0],
    }
    log(f"e2e ({card}): text -> {audio_s:.2f} s of audio; cond_len {cond_len}, "
        f"{steps} decode steps; prefill {e2e['prefill_ms']:.2f} ms, decode "
        f"{e2e['decode_ms_per_step']:.3f} ms/step, DAC {e2e['dac_ms']:.1f} ms, "
        f"RTF {e2e['rtf']:.3f}; launches {launches}")
    return pipe, cond, e2e


# Clone + continuation on the bf16 transformer. The speaker reference is the
# bf16 main path's own 5.00 s output at 44.1 kHz (the 44.1 -> 16 kHz
# resample); the audio prefix is 5.0 s of a 24 kHz chirp plus noise from a
# fixed seed (24 -> 44.1 kHz, 431 frames once padded to the hop).
PREFIX_SR, PREFIX_SECONDS, PREFIX_SEED = 24000, 5.0, 10
PREFIX_FRAMES = 431
# The card against the port on the CPU, both fp32 (TF32 off): max |diff| of
# the resampled waveforms and of the log filterbank; max |diff| / max |ref|
# of the 128-d embedding (97 SimAM blocks deep) and of the encoder latents.
RESAMPLE_TOL, FBANK_TOL, EMBED_TOL, LATENT_TOL = 1e-5, 1e-4, 1e-3, 1e-4
# RVQ codes: at least this share equal to the CPU's; a code that differs
# must be a near tie on the CPU, its score within TIE_MARGIN of the best
# given the same earlier stages (the argmax may flip on such a tie).
CODES_EQUAL_MIN, TIE_MARGIN = 0.999, 1e-4


def prefix_signal():
    """The continuation's audio prefix: ``[PREFIX_SR * PREFIX_SECONDS]``
    float32, a chirp from 150 Hz plus noise."""
    import numpy as np

    rng = np.random.default_rng(PREFIX_SEED)
    n = int(PREFIX_SR * PREFIX_SECONDS)
    t = np.arange(n) / PREFIX_SR
    return (0.5 * np.sin(2 * np.pi * (150.0 + 300.0 * t) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def timed(fn):
    """(result, host ms) of ``fn()`` with the device synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_clone_dsp(ref, prefix, card: str) -> dict:
    """The DSP on the card against the CPU: the 44.1 -> 16 kHz resample of
    the speaker reference, the 24 -> 44.1 kHz resample of the prefix and the
    log filterbank of the 16 kHz reference."""
    import torch

    from zonos_vibes_tpu_torch.utils import dsp

    errs = {}
    for name, x, a, b in (("resample_44k_16k", ref, 44100, 16000),
                          ("resample_24k_44k", prefix, PREFIX_SR, 44100)):
        xt = torch.from_numpy(x)[None]
        errs[name] = (dsp.resample(xt.cuda(), a, b).cpu() - dsp.resample(xt, a, b)).abs().max().item()
    wav16 = dsp.resample(torch.from_numpy(ref)[None], 44100, 16000)
    errs["log_fbank"] = (dsp.log_fbank(wav16.cuda()).cpu() - dsp.log_fbank(wav16)).abs().max().item()
    for name, tol in (("resample_44k_16k", RESAMPLE_TOL), ("resample_24k_44k", RESAMPLE_TOL),
                      ("log_fbank", FBANK_TOL)):
        if not errs[name] <= tol:
            raise AssertionError(f"clone DSP {name}: card vs CPU max |diff| {errs[name]} > {tol}")
    log(f"clone DSP ({card}): card vs CPU max |diff| resample 44.1 -> 16 kHz "
        f"{errs['resample_44k_16k']:.3e}, 24 -> 44.1 kHz {errs['resample_24k_44k']:.3e} "
        f"(<= {RESAMPLE_TOL}); log_fbank {errs['log_fbank']:.3e} (<= {FBANK_TOL})")
    return errs


def rvq_against_cpu(dac, params_cpu, latents_cpu, codes) -> dict:
    """The card's codes against the CPU's RVQ on the CPU's latents. Equal
    share over all codes (free-running CPU codes); then stage by stage with
    the card's earlier codes forced, every code that differs from the CPU's
    argmax must score within ``TIE_MARGIN`` of the CPU's best."""
    import torch

    from zonos_vibes_tpu_torch.models.dac import rvq_dequantize, rvq_scores

    codes = codes.cpu()
    with torch.inference_mode():
        free = dac.model.quantize(params_cpu, latents_cpu)
        residual, forced_differ, worst = latents_cpu, 0, 0.0
        for i, q in enumerate(params_cpu["quantizers"]):
            scores = rvq_scores(q, residual)  # [1, T', N]
            card = codes[:, i]
            gap = scores.max(dim=-1).values - scores.gather(-1, card[..., None])[..., 0]
            differ = card != scores.argmax(dim=-1)
            forced_differ += int(differ.sum())
            if differ.any():
                worst = max(worst, gap[differ].max().item())
            residual = residual - rvq_dequantize(q, card)
    equal = (codes == free).float().mean().item()
    out = {"equal_share": equal, "differ": int((codes != free).sum()),
           "forced_differ": forced_differ, "worst_tie_gap": worst}
    if equal < CODES_EQUAL_MIN or worst >= TIE_MARGIN:
        raise AssertionError(f"RVQ codes card vs CPU: {out} (need share >= {CODES_EQUAL_MIN}, "
                             f"every differing code within {TIE_MARGIN} of the CPU's best)")
    return out


def run_continuation(pipe, ref, card: str) -> dict:
    """Phase 3, clone + continuation on the bf16 main path's pipeline:
    ``make_speaker_embedding`` (the seed-0 ResNet293) of the main path's
    WAV, ``encode_audio`` of the 24 kHz prefix, ``make_cond_dict(speaker=)``,
    ``generate(cond, audio_prefix_codes=...)`` of 431 frames with the counts
    exact, ``decode_audio``; the DSP, embedding, latents and codes held
    against the CPU, graph codes against eager. Returns the numbers."""
    import numpy as np
    import torch

    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.serve.sample import wav_bytes

    prefix = prefix_signal()
    dsp_errs = check_clone_dsp(ref, prefix, card)

    # Voice cloning: the first call also draws the seed-0 weights.
    _, first_spk_ms = timed(lambda: pipe.make_speaker_embedding(ref, 44100))
    speaker, spk_ms = timed(lambda: pipe.make_speaker_embedding(ref, 44100))
    enc = pipe.speaker_encoder
    _, lda = enc(pipe.speaker_params, ref, 44100)
    _, lda_cpu = enc(to_cpu(pipe.speaker_params), ref, 44100)
    embed_rel = ((lda.cpu() - lda_cpu).abs().max() / lda_cpu.abs().max()).item()
    if (tuple(speaker.shape) != (1, 1, 128) or speaker.dtype != torch.bfloat16
            or not torch.isfinite(lda).all() or not embed_rel <= EMBED_TOL):
        raise AssertionError(f"speaker embedding {tuple(speaker.shape)} {speaker.dtype}: card vs "
                             f"CPU {embed_rel} > {EMBED_TOL}")
    log(f"clone speaker embedding ({card}): {spk_ms:.2f} ms (first call {first_spk_ms:.2f} ms "
        f"with the weight draw) for {ref.shape[-1] / 44100:.2f} s at 44.1 kHz -> [1, 1, 128] "
        f"bf16; card vs CPU max |diff| / max |ref| {embed_rel:.3e} <= {EMBED_TOL}")

    # Audio prefix: DSP, encoder and RVQ on the card.
    pipe.encode_audio(prefix, PREFIX_SR)
    codes, enc_ms = timed(lambda: pipe.encode_audio(prefix, PREFIX_SR))
    lp = codes.shape[-1]
    if tuple(codes.shape) != (1, 9, PREFIX_FRAMES) or int(codes.min()) < 0 or int(codes.max()) >= 1024:
        raise AssertionError(f"prefix codes misshapen or out of range: {tuple(codes.shape)}")
    dac, dac_cpu = pipe.dac, to_cpu(pipe.dac_params)
    with torch.inference_mode():
        x = torch.from_numpy(prefix)[None]
        lat = dac.model.encoder_forward(pipe.dac_params, dac.preprocess(x.cuda(), PREFIX_SR)[:, None])
        lat_cpu = dac.model.encoder_forward(dac_cpu, dac.preprocess(x, PREFIX_SR)[:, None])
    lat_rel = ((lat.cpu() - lat_cpu).abs().max() / lat_cpu.abs().max()).item()
    if not lat_rel <= LATENT_TOL:
        raise AssertionError(f"encoder latents card vs CPU {lat_rel} > {LATENT_TOL}")
    rvq = rvq_against_cpu(dac, dac_cpu, lat_cpu, codes)
    log(f"clone encode ({card}): {enc_ms:.2f} ms (DSP, encoder and RVQ) for {PREFIX_SECONDS} s at "
        f"{PREFIX_SR} Hz -> codes [1, 9, {lp}]; latents card vs CPU max |diff| / max |ref| "
        f"{lat_rel:.3e} <= {LATENT_TOL}; codes equal to the CPU's {rvq['equal_share']:.5f} "
        f"(>= {CODES_EQUAL_MIN}), {rvq['differ']} differ, {rvq['forced_differ']} with the "
        f"card's earlier stages forced, worst gap {rvq['worst_tie_gap']:.3e} < {TIE_MARGIN}")

    cond = pipe.make_cond_dict(text=TEXT, language="en-us", speaker=speaker)
    prefix_cond = pipe.prepare_conditioning(cond)
    cond_len = prefix_cond.shape[1]
    # Rows 3 and 1 at the shapes this run gives them (disable_eos: 431 + 8
    # decode steps), against their plain versions first.
    S = cond_len + lp + 1
    T, fe, sl = main_path_decode_step(cond_len, AUDIO_FRAMES + 8, lp)
    errors = check_continuation_kernels(S, T, fe, sl)
    warm = pipe.generate(cond, codes, generator=torch.Generator("cuda").manual_seed(1),
                         max_new_tokens=8, disable_eos=True)
    pipe.decode_audio(warm)

    build.reset_launches()
    t0 = time.perf_counter()
    result = pipe.generate(cond, codes, generator=torch.Generator("cuda").manual_seed(421),
                           max_new_tokens=AUDIO_FRAMES, disable_eos=True)
    launches = dict(build.LAUNCHES)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    wav = pipe.decode_audio(result)
    torch.cuda.synchronize()
    t_dac = time.perf_counter() - t0

    steps = result.steps
    out_codes = result.codes
    if (tuple(out_codes.shape) != (1, 9, lp + AUDIO_FRAMES) or int(out_codes.min()) < 0
            or int(out_codes.max()) >= 1024 or not torch.equal(out_codes[..., :lp], codes)):
        raise AssertionError(f"continuation codes misshapen, out of range or not starting with "
                             f"the prefix: {tuple(out_codes.shape)}")
    if result.valid_length != lp + AUDIO_FRAMES:
        raise AssertionError(f"continuation valid length {result.valid_length}")
    if wav.shape[-1] != (lp + AUDIO_FRAMES) * dac.hop or not np.isfinite(wav).all():
        raise AssertionError("continuation waveform misshapen or not finite")
    want = {"decode_attention": L * steps, "decode_attention_q": 0, "stage_splice": 0,
            "prefill_attention": L, "qmm_int8": 0, **NO_POOL_LAUNCHES}
    if launches != want:
        raise AssertionError(f"continuation launch counts {launches}, expected {want}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_continue.wav").write_bytes(wav_bytes(wav[0], dac.sampling_rate))
    graphs = graph_against_eager("continuation", pipe.model, pipe.params, prefix_cond, result,
                                 want, {"decode_attention": L}, STEP_BOUND_MS["bf16"], card,
                                 prefix_codes=codes)

    if steps != AUDIO_FRAMES + 8:
        raise AssertionError(f"continuation ran {steps} decode steps, not {AUDIO_FRAMES + 8}")
    new_s = AUDIO_FRAMES * dac.hop / dac.sampling_rate
    total_s = (spk_ms + enc_ms) / 1e3 + t_gen + t_dac
    cont = {"cond_len": cond_len, "lp": lp, "S": S, "T": T, "fe": fe, "sl": sl, "steps": steps,
            "speaker_ms": spk_ms, "encode_ms": enc_ms, "prefill_ms": result.prefill_seconds * 1e3,
            "decode_ms_per_step": result.decode_seconds * 1e3 / steps, "generate_s": t_gen,
            "dac_ms": t_dac * 1e3, "rtf": new_s / total_s, "launches": launches,
            "graphs": graphs, "rvq": rvq, "dsp": dsp_errs, "embed_rel": embed_rel,
            "latent_rel": lat_rel, "errors": errors}
    log(f"continuation prefill ({card}): S = {S} positions (cond_len {cond_len} + {lp} prefix "
        f"frames + 1) at offset 0 in a cache of T = {T}, B = {B}: {cont['prefill_ms']:.2f} ms "
        f"(host, the engine's prefill with the first frame); prefill_attention {L} launches")
    log(f"continuation decode ({card}): T = {T}, {steps} steps, graph "
        f"{graphs['graph_ms_per_step']:.3f} ms/step, eager {graphs['eager_ms_per_step']:.3f} "
        f"ms/step, bound {STEP_BOUND_MS['bf16']} ms/step; launches {launches}")
    log(f"continuation RTF ({card}): {cont['rtf']:.3f} = {new_s:.2f} s of new audio / "
        f"({spk_ms:.1f} ms speaker + {enc_ms:.1f} ms encode + {t_gen * 1e3:.1f} ms generate + "
        f"{t_dac * 1e3:.1f} ms DAC of {wav.shape[-1] / dac.sampling_rate:.2f} s); "
        f"build/chip_smoke_continue.wav")
    return cont


def check_continuation_kernels(S: int, T: int, fe: int, sl: int) -> dict:
    """Phase 2 at the continuation's shapes: row 3 at B = 2, S = its
    prefill, offset 0, T = its cache (the two-pass path past 128 keys), NaN
    past offset + S; row 1 at its last decode step's scalars (flushed_end
    ``fe``, stage_len ``sl``) against the plain version."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain)

    gen = torch.Generator(device="cuda").manual_seed(21)
    e_pre = check_prefill_case(gen, B, S, 0, T, HQ, HKV, D)
    x = decode_inputs(gen, T)
    e_dec = 0.0
    for layer in (0, 25):
        sc = torch.tensor([fe, sl, layer], dtype=torch.int32, device="cuda")
        want = decode_attention_layered_plain(**x, scalars=sc).float()
        got = decode_attention_layered(**x, scalars=sc).float()
        e_dec = max(e_dec, (got - want).abs().max().item())
        if not torch.isfinite(got).all() or e_dec > TOL:
            raise AssertionError(f"decode_attention at the continuation's step: err {e_dec}")
    log(f"kernel prefill_attention at the continuation's prefill (B={B}, S={S}, offset 0, T={T}, "
        f"NaN past S): max_abs_err {e_pre:.3e} <= {TOL}; decode_attention at its last step "
        f"(T={T}, flushed_end={fe}, stage_len={sl}, layers 0/25): {e_dec:.3e} <= {TOL}")
    return {"prefill_attention_continuation": e_pre, "decode_attention_continuation": e_dec}


def time_continuation_kernels(cont: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4, rows 3 and 1 at the continuation's shapes: the prefill at S
    in a cache of T beside causal SDPA, decode attention at the last step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(22)
    S, T = cont["S"], cont["T"]
    ms, plain, lib, b, by = time_prefill(gen, HQ, HKV, D, S, T, card, long=())[S, 0]
    rows = [dict(name="prefill_attention_continuation", route="cuda",
                 source="zonos_vibes_tpu_torch/csrc/prefill_attention.cu",
                 replaces="zonos_vibes_tpu/ops/pallas/prefill_attention.py:111",
                 launches=cont["launches"]["prefill_attention"],
                 max_abs_err=errors["prefill_attention_continuation"], ms=ms, plain_ms=plain,
                 bound_ms=b, bound_by=by, library_ms=lib)]
    ms, plain, lib, b, by, held = time_decode(gen, T, cont["fe"], cont["sl"],
                                              "continuation last step", card)
    require_stage_write("decode_attention_continuation", held)
    rows.append(dict(name="decode_attention_continuation", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:253",
                     launches=cont["launches"]["decode_attention"],
                     max_abs_err=errors["decode_attention_continuation"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


STREAM_AUDIO_TOL = 1e-3  # fp32 DAC; cuDNN may pick other algorithms for the shorter windows


def run_stream(pipe, cond, one_shot, card: str) -> dict:
    """Phase 3, streaming on the bf16 main path. ``pipe.engine.generate_stream``
    with the one-shot run's seed and inputs, in 43-step chunks: every yield
    cumulative, the last one's codes equal to the one-shot codes. Then
    ``pipe.generate_stream`` (EOS on, as its JAX counterpart has no
    ``disable_eos``) against one-shot ``generate`` + ``decode_audio`` with the
    same seed: the concatenated chunks equal its waveform within
    ``STREAM_AUDIO_TOL``. Returns the times to the first chunk."""
    import numpy as np
    import torch

    prefix = pipe.prepare_conditioning(cond)
    torch.cuda.synchronize()
    chunks, t0 = [], time.perf_counter()
    for res in pipe.engine.generate_stream(
            pipe.params, prefix, generator=torch.Generator("cuda").manual_seed(421),
            max_new_tokens=AUDIO_FRAMES, disable_eos=True, chunk_steps=POOL_SEGMENT):
        chunks.append((time.perf_counter() - t0, res))  # each yield follows a device sync
    final = chunks[-1][1]
    if (len(chunks) != -(-one_shot.steps // POOL_SEGMENT) or final.steps != one_shot.steps
            or not torch.equal(final.codes, one_shot.codes)):
        raise AssertionError(f"stream: {len(chunks)} chunks of {final.steps} steps, codes "
                             f"differ from the one-shot run's {one_shot.steps} steps")
    for _, res in chunks:
        n = res.valid_length
        if not torch.equal(res.codes[..., :n], final.codes[..., :n]):
            raise AssertionError(f"stream: a chunk's first {n} frames differ from the final codes")

    kw = dict(max_new_tokens=AUDIO_FRAMES)
    ref = pipe.decode_audio(pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(421),
                                          **kw))
    pieces, t1 = [], time.perf_counter()
    for piece in pipe.generate_stream(cond, generator=torch.Generator("cuda").manual_seed(421),
                                      **kw):
        pieces.append((time.perf_counter() - t1, piece))
    got = np.concatenate([p for _, p in pieces], axis=-1)
    diff = float(np.abs(got - ref).max()) if got.shape == ref.shape and got.size else float("inf")
    if not np.isfinite(got).all() or diff > STREAM_AUDIO_TOL:
        raise AssertionError(f"stream audio: shape {got.shape} vs {ref.shape}, max |diff| {diff}")
    out = {"chunks": len(chunks), "first_chunk_ms": chunks[0][0] * 1e3,
           "stream_ms": chunks[-1][0] * 1e3, "audio_chunks": len(pieces),
           "first_audio_ms": pieces[0][0] * 1e3, "audio_s": got.shape[-1] / pipe.dac.sampling_rate,
           "audio_max_diff": diff}
    log(f"stream bf16 ({card}): {len(chunks)} chunks of {POOL_SEGMENT} steps, codes equal to "
        f"the one-shot run's; first chunk after {out['first_chunk_ms']:.1f} ms (prefill, capture "
        f"and {POOL_SEGMENT} steps), all {final.steps} steps after {out['stream_ms']:.1f} ms; "
        f"pipeline audio stream: first of {len(pieces)} chunks after "
        f"{out['first_audio_ms']:.1f} ms, {out['audio_s']:.2f} s of audio, max |diff| to the "
        f"one-shot waveform {diff:.3e} <= {STREAM_AUDIO_TOL}")
    return out


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
    want = {"decode_attention": 0, "decode_attention_q": L * steps, "stage_splice": 0,
            "prefill_attention": L, "qmm_int8": (4 * L + 1) * (steps + 1), **NO_POOL_LAUNCHES}
    if launches != want:
        raise AssertionError(f"int8 launch counts {launches}, expected {want}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_int8.wav").write_bytes(wav_bytes(wav[0], pipe.dac.sampling_rate))
    graphs = graph_against_eager("int8", pipe.model, pipe.params, prefix, result, want,
                                 {"decode_attention_q": L, "qmm_int8": 4 * L + 1},
                                 STEP_BOUND_MS["int8"], card, kv_int8=True)

    audio_s = wav.shape[-1] / pipe.dac.sampling_rate
    e2e = {
        "cond_len": cond_len, "steps": steps, "audio_s": audio_s,
        "prefill_ms": result.prefill_seconds * 1e3,
        "decode_ms_per_step": result.decode_seconds * 1e3 / steps,
        "generate_s": t_gen, "dac_ms": t_dac * 1e3, "rtf": audio_s / (t_gen + t_dac),
        "launches": launches, "tvd": mean_tvd, "graphs": graphs,
    }
    log(f"e2e int8 ({card}): text -> {audio_s:.2f} s of audio; cond_len {cond_len}, "
        f"{steps} decode steps; prefill {e2e['prefill_ms']:.2f} ms, decode "
        f"{e2e['decode_ms_per_step']:.3f} ms/step, DAC {e2e['dac_ms']:.1f} ms, "
        f"RTF {e2e['rtf']:.3f}; launches {launches}")
    return e2e


def run_pool(pipe, card: str, kv_int8: bool, hybrid: bool = False) -> dict:
    """Phase 3, the continuous-batching pool at flagship width on the
    pipeline's current weights: row 0 alone for 3 segments (the isolation
    reference), then the counted staggered pool of 8 requests, one joining
    per segment, until every row finishes. With ``hybrid`` (the hybrid
    pipeline) the result also holds a copy of the pool's state right after
    the last join (``snapshot``), for the stage-less pooled phase."""
    import numpy as np
    import torch

    from zonos_vibes_tpu_torch.engine import pool as plib
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
    from zonos_vibes_tpu_torch.serve.sample import wav_bytes

    label = ("hybrid pool bf16" if hybrid else
             "pool int8 KV, int8 weights" if kv_int8 else "pool bf16")
    model, params = pipe.model, pipe.params
    bcfg = model.config.backbone
    n_attn = len(bcfg.attn_layer_idx) if hybrid else bcfg.n_layer
    pc = plib.PoolConfig(slots=POOL_SLOTS)
    conds = [pipe.prepare_conditioning(pipe.make_cond_dict(text=t, language="en-us"))
             for t in POOL_TEXTS]

    def join(pool, s):
        req, knobs = plib.prefill_request(
            model, params, conds[s], torch.Generator("cuda").manual_seed(100 + s), AUDIO_FRAMES,
            2.0, SamplingParams(min_p=0.1), kv_int8=kv_int8)
        plib.join(pool, req, s, conds[s].shape[1], 1000 + s, knobs)

    def new_pool(graphs: bool = True):
        pool = plib.make_pool(model, pc, conds[0].dtype, kv_int8=kv_int8, device="cuda",
                              cuda_graphs=graphs)
        if pool["cache"]["k"].shape[2] != POOL_T:
            raise AssertionError(f"pool cache length {pool['cache']['k'].shape[2]} != {POOL_T}")
        return pool

    # Row 0 alone (this also warms the pooled step's kernels and handles).
    pool = new_pool()
    join(pool, 0)
    for _ in range(3):
        plib.pool_steps(model, params, pool, POOL_SEED, POOL_SEGMENT)
    alone, alone_valid = plib.extract_row(model, pool, 0)
    del pool
    torch.cuda.empty_cache()

    def staggered(graphs: bool) -> dict:
        """The counted schedule: one join per segment, then segments until
        every row finishes. Returns its numbers, the rows' codes and (for the
        hybrid) the state right after the last join."""
        pool = new_pool(graphs)
        out = {"kv_bytes": sum(t.numel() * t.element_size() for t in pool["cache"].values())}
        torch.cuda.synchronize()
        build.reset_launches()
        joins = steps = step_qmm = segments = 0
        t_join = t_steps = 0.0
        t_window = time.perf_counter()
        for seg in range(POOL_SLOTS + AUDIO_FRAMES // POOL_SEGMENT + 4):
            if seg < POOL_SLOTS:
                t0 = time.perf_counter()
                join(pool, seg)
                torch.cuda.synchronize()
                t_join += time.perf_counter() - t0
                joins += 1
                if hybrid and seg == POOL_SLOTS - 1:
                    snapshot = {k: v.clone() for k, v in pool["cache"].items()}
                    snapshot.update(pos=pool["pos"].clone(), cfg_scale=pool["knobs"]["cfg_scale"])
                    out["snapshot"] = snapshot
            elif all(plib.row_finished(pool, s) for s in range(POOL_SLOTS)):
                break
            t0 = time.perf_counter()
            qmm_before = build.LAUNCHES["qmm_int8"]
            steps += plib.pool_steps(model, params, pool, POOL_SEED, POOL_SEGMENT)
            segments += 1
            step_qmm += build.LAUNCHES["qmm_int8"] - qmm_before
            torch.cuda.synchronize()
            t_steps += time.perf_counter() - t0
            if seg == POOL_SLOTS - 1:  # every row joined: the spread the kernels are timed at
                out["bases_mid"] = pool["flush_base"].tolist()
        out["launches"] = dict(build.LAUNCHES)
        out["t_window"] = time.perf_counter() - t_window
        if not all(plib.row_finished(pool, s) for s in range(POOL_SLOTS)):
            raise AssertionError(f"{label}: rows still running after {steps} steps")
        out["alloc"] = torch.cuda.memory_allocated()
        runners = pool["graphs"].values()
        out.update(joins=joins, steps=steps, step_qmm=step_qmm, t_join=t_join, t_steps=t_steps,
                   segments=segments,
                   host_reads=pool["host_reads"], rows=[plib.extract_row(model, pool, s)
                                                         for s in range(POOL_SLOTS)],
                   graphs=len(runners), replays=sum(r.replays for r in runners),
                   capture_ms=sum(r.capture_seconds for r in runners) * 1e3,
                   step_launches=[r.step_launches for r in runners])
        del pool
        torch.cuda.empty_cache()
        return out

    run = staggered(graphs=True)
    eager = staggered(graphs=False)
    joins, steps, launches = run["joins"], run["steps"], run["launches"]
    step_qmm, t_steps, t_join = run["step_qmm"], run["t_steps"], run["t_join"]
    t_window = run["t_window"]
    kv_bytes, alloc, bases_mid = run["kv_bytes"], run["alloc"], run["bases_mid"]
    want = {"decode_attention": 0, "decode_attention_q": 0, "stage_splice": 0,
            "prefill_attention": n_attn * joins,
            "qmm_int8": (4 * L + 1) * (joins + steps) * kv_int8,
            "decode_attention_pooled": 0 if kv_int8 else n_attn * steps,
            "decode_attention_pooled_q": L * steps if kv_int8 else 0,
            "stage_splice_rows": 0, **NO_HYBRID_LAUNCHES}
    if hybrid:
        want["ssd_gate_step"] = (bcfg.n_layer - n_attn) * steps
    if launches != want or step_qmm != (4 * L + 1) * steps * kv_int8:
        raise AssertionError(f"{label} launch counts {launches} ({step_qmm} qmm_int8 in the "
                             f"pooled steps), expected {want}")
    per_step = {k: v // steps for k, v in want.items() if k != "prefill_attention" and v}
    if kv_int8:
        per_step["qmm_int8"] = 4 * L + 1
    if (eager["launches"] != want or eager["steps"] != steps or eager["replays"]
            or any(r != per_step for r in run["step_launches"])
            or run["replays"] != steps - run["graphs"]):
        raise AssertionError(f"{label}: eager run {eager['steps']} steps, launches "
                             f"{eager['launches']}; graph run {run['replays']} replays of "
                             f"{run['step_launches']}, expected {steps - run['graphs']} of "
                             f"{per_step}")
    for s, ((codes, valid), (e_codes, e_valid)) in enumerate(zip(run["rows"], eager["rows"])):
        if valid != e_valid or not torch.equal(codes, e_codes):
            raise AssertionError(f"{label} row {s}: graph codes ({valid} frames) differ from "
                                 f"the eager run's ({e_valid} frames)")
    graphs = {"eager_ms_per_step": eager["t_steps"] * 1e3 / steps,
              "graph_ms_per_step": (t_steps - run["capture_ms"] / 1e3) * 1e3 / steps,
              "capture_ms": run["capture_ms"], "graphs": run["graphs"],
              "reads_per_segment": run["host_reads"] / run["segments"],
              "reads": run["host_reads"], "eager_reads": eager["host_reads"],
              "bound_ms": POOL_STEP_BOUND_MS["hybrid" if hybrid else "int8" if kv_int8 else "bf16"],
              "replays": run["replays"]}
    log(f"graphs {label} ({card}): {steps} pooled steps, every row's codes equal to the eager "
        f"run's; eager {graphs['eager_ms_per_step']:.3f} ms/step, graph "
        f"{graphs['graph_ms_per_step']:.3f} ms/step ({run['graphs']} graphs captured in "
        f"{graphs['capture_ms']:.1f} ms, not in the figure), bound {graphs['bound_ms']:.3f} "
        f"ms/step (weights{' and fp32 state' if hybrid else ''}); host reads {run['host_reads']} "
        f"(eager {eager['host_reads']}) in {run['segments']} segments of {steps} steps; "
        f"{run['replays']} replays of {per_step} "
        f"+ the eager steps' launches = {want}")

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    frames = []
    for s, (codes, valid) in enumerate(run["rows"]):
        if valid <= 0 or valid > AUDIO_FRAMES or int(codes.min()) < 0 or int(codes.max()) >= 1024:
            raise AssertionError(f"{label} row {s}: {valid} frames, codes out of range")
        if s == 0:
            n = min(ISOLATION_FRAMES, valid, alone_valid)
            if (n < ISOLATION_FRAMES and valid != alone_valid) or not torch.equal(
                    codes[:, :n], alone[:, :n]):
                raise AssertionError(f"{label}: row 0 alone differs from row 0 in the full pool "
                                     f"within its first {n} frames")
        wav = pipe.decode_audio(codes[None])[0]
        if wav.size == 0 or not np.isfinite(wav).all():
            raise AssertionError(f"{label} row {s}: waveform empty or not finite")
        suffix = "_hybrid" if hybrid else "_int8" if kv_int8 else ""
        (out_dir / f"chip_smoke_pool{suffix}_row{s}.wav").write_bytes(
            wav_bytes(wav, pipe.dac.sampling_rate))
        frames.append(valid)

    e2e = {"joins": joins, "steps": steps, "frames": frames,
           "ms_per_step": t_steps * 1e3 / steps,
           "audio_s_per_s": sum(frames) / FRAME_RATE / t_steps,
           "audio_s_per_s_window": sum(frames) / FRAME_RATE / t_window,
           "prefill_join_ms": t_join * 1e3 / joins, "kv_cache_bytes": kv_bytes,
           "memory_allocated": alloc, "bases_mid": bases_mid, "launches": launches,
           "step_qmm_launches": step_qmm, "graphs": graphs}
    if hybrid:
        e2e["snapshot"] = run["snapshot"]
    log(f"e2e {label} ({card}): {joins} requests x {AUDIO_FRAMES} frames max, one join per "
        f"{POOL_SEGMENT}-step segment; {steps} pooled steps at {e2e['ms_per_step']:.3f} ms/step; "
        f"valid frames {frames}; aggregate {e2e['audio_s_per_s']:.3f} audio-s/s over the pooled "
        f"segments' {t_steps:.3f} s, {e2e['audio_s_per_s_window']:.3f} over the whole "
        f"{t_window:.3f} s window (joins included); prefill+join "
        f"{e2e['prefill_join_ms']:.2f} ms/request; cache {kv_bytes / 1e9:.3f} GB; "
        f"memory_allocated {alloc / 2**30:.3f} GiB; row 0 alone == row 0 pooled for "
        f"{min(ISOLATION_FRAMES, frames[0], alone_valid)} frames; launches {launches}")
    return e2e


# The hybrid (ZONOS_V01_HYBRID): 48 layers, 6 attention layers (16 query
# and 4 KV heads, head dim 128) and 42 Mamba-2 layers (d_state 128, d_inner
# 4096 in 64 heads of 64).
H_LA, H_M, H_HQ, H_HKV, H_D = 6, 42, 16, 4, 128
H_W = H_HKV * H_D
M_N, M_HP, M_H = 128, 4096, 64
PEAK_FP32_FLOPS = 67e12  # CUDA cores, no tensor cores (the Mamba step's fp32 math)
# The fused Mamba step's bf16 output against its plain version, |err| <=
# atol + rtol |want|: both run the same fp32 chain in another order and
# round once to bf16 (outputs up to ~5).
SSM_TOL = (1e-2, 1e-2)
SSM_STATE_TOL = {"fp32": (1e-5, 1e-5), "bf16": (8e-3, 1e-2)}  # (rtol, atol); bf16: one step
# The stage-less pooled steps against the ring steps from the same state:
# the same keys in another split order, so bf16 roundings of attention
# outputs may differ, carried through the 48 layers into fp32 logits of
# magnitude up to ~9 (CFG scale 2 triples a difference). With plain
# attention the two modes agree exactly (run_stage_less checks it), so the
# kernels' arithmetic is the only cause. On an H100 the sound steps gave a
# max |diff| of 0.076 (0.085 with argmax frames) and steps with each
# stage-less column written one position off gave 0.313; the limit sits
# about 2x from each.
STAGELESS_LOGIT_TOL = 0.15
NO_TRANSFORMER_LAUNCHES = {"decode_attention": 0, "decode_attention_q": 0, "stage_splice": 0,
                           "qmm_int8": 0, "decode_attention_pooled_q": 0}


def within(got, want, rtol: float, atol: float) -> bool:
    """Finite, and |got - want| <= atol + rtol |want| everywhere."""
    import torch

    g, w = got.float(), want.float()
    return bool(torch.isfinite(g).all() and ((g - w).abs() <= atol + rtol * w.abs()).all())


def ssd_inputs(gen, B: int, planes: int, state_dtype):
    """Per-head Mamba step inputs at the hybrid's widths and a stacked state
    whose planes are NaN (the caller fills the plane it updates)."""
    import torch
    import torch.nn.functional as F

    def f(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    states = torch.full((planes, B, M_N, M_HP), float("nan"), device="cuda", dtype=state_dtype)
    dt = F.softplus(f(B, M_H))
    return states, dict(xs=f(B, M_HP).bfloat16(), dt=dt, decay=torch.exp(-dt * torch.rand(
        M_H, generator=gen, device="cuda")), bm=f(B, M_N) * 0.3, cm=f(B, M_N) * 0.3,
        z=f(B, M_HP).bfloat16(), d_skip=f(M_H), norm_w=(1.0 + 0.1 * f(M_HP)).bfloat16())


def check_hybrid_kernels(solo_T: int) -> dict:
    """Phase 2, the hybrid's kernels against their plain versions at its
    shapes: the fused Mamba step (rows 9 and 10) at 2 and 16 rows with an
    fp32 and a bf16 state, in place on one plane of a 42-plane stack whose
    other planes are NaN; rows 11 and 12 and the head-dim-128 variants of
    rows 3 and 6, NaN past every bound; row 12 at the transformer's head
    dim 64 too."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_pooled_staged, decode_attention_pooled_staged_plain,
        decode_attention_pooled_unstaged, decode_attention_pooled_unstaged_plain,
        decode_attention_unstaged, decode_attention_unstaged_plain)
    from zonos_vibes_tpu_torch.ops.cuda.mamba_step import (
        ssd_gate_step, ssd_gate_step_layered, ssd_gate_step_layered_plain)

    gen = torch.Generator(device="cuda").manual_seed(31)
    err = {}
    worst = 0.0
    for Bs in (B, POOL_M):
        for sdt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            for layer in (0, H_M - 1):
                states, x = ssd_inputs(gen, Bs, H_M, sdt)
                states[layer] = torch.randn(Bs, M_N, M_HP, generator=gen, device="cuda").to(sdt)
                ref = states[layer:layer + 1].clone()
                want = ssd_gate_step_layered_plain(ref, 0, **x)
                ptr = states.data_ptr()
                got = ssd_gate_step_layered(states, layer, **x)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                others = torch.cat([states[:layer], states[layer + 1:]])
                if (not within(got, want, *SSM_TOL) or states.data_ptr() != ptr
                        or not within(states[layer], ref[0], *SSM_STATE_TOL[name])
                        or not torch.isnan(others).all()):
                    raise AssertionError(f"ssd_gate_step_layered B={Bs} {name} layer={layer}: "
                                         f"err {e}, or the state not in place, or another "
                                         f"plane touched")
                worst = max(worst, e)
                del states, others, ref
        state = torch.randn(Bs, M_N, M_HP, generator=gen, device="cuda")
        _, x = ssd_inputs(gen, Bs, 1, torch.float32)
        ref = state.clone()[None]
        want = ssd_gate_step_layered_plain(ref, 0, **x)
        got = ssd_gate_step(state, **x)
        torch.cuda.synchronize()
        if not within(got, want, *SSM_TOL) or not within(state, ref[0], *SSM_STATE_TOL["fp32"]):
            raise AssertionError(f"ssd_gate_step B={Bs}: differs from the plain version")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
    err["ssd_gate_step"] = err["ssd_gate_step_layered"] = worst
    log(f"kernel ssd_gate_step (rows 9/10): B 2/16, fp32 and bf16 state, planes 0/{H_M - 1} of "
        f"[{H_M}, B, {M_N}, {M_HP}] with the other planes NaN and untouched, in place; "
        f"max_abs_err {worst:.3e} within |err| <= {SSM_TOL[1]} + {SSM_TOL[0]} |out|; state "
        f"within {SSM_STATE_TOL}")

    def inputs(Bx, T, L_, Hq, Hkv, D):
        W_ = Hkv * D
        return dict(q=randn(gen, Bx, 1, Hq, D), k_cache=randn(gen, L_, Bx, T, W_),
                    v_cache=randn(gen, L_, Bx, T, W_), k_cur=randn(gen, Bx, W_),
                    v_cur=randn(gen, Bx, W_))

    worst = 0.0
    x = inputs(2, solo_T, H_LA, H_HQ, H_HKV, H_D)
    for seq_end in (1, 255, 256, solo_T // 2, solo_T):
        k, v = x["k_cache"].clone(), x["v_cache"].clone()
        k[:, :, seq_end:] = float("nan")
        v[:, :, seq_end:] = float("nan")
        sc = torch.tensor([seq_end], dtype=torch.int32, device="cuda")
        for layer in (0, H_LA - 1):
            got = decode_attention_unstaged(x["q"], k, v, sc, layer).float()
            want = decode_attention_unstaged_plain(x["q"], k, v, sc, layer).float()
            e = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or e > TOL:
                raise AssertionError(f"decode_attention_unstaged seq_end={seq_end}: err {e}")
            worst = max(worst, e)
    err["decode_attention_unstaged"] = worst
    log(f"kernel decode_attention_unstaged (row 11): B=2 T={solo_T} L={H_LA} Hq={H_HQ} "
        f"Hkv={H_HKV} D={H_D}, seq_end 1/255/256/{solo_T // 2}/{solo_T}, layers 0/{H_LA - 1}, NaN "
        f"past seq_end: max_abs_err {worst:.3e} <= {TOL}")
    del x, k, v

    worst = worst_rel = 0.0
    ends = torch.tensor(POOL_BASES, dtype=torch.int32, device="cuda")
    for L_, Hq, Hkv, D_ in ((H_LA, H_HQ, H_HKV, H_D), (L, HQ, HKV, D)):
        x = inputs(16, POOL_T, L_, Hq, Hkv, D_)
        for b, e in enumerate(POOL_BASES):
            x["k_cache"][:, b, e:] = float("nan")
            x["v_cache"][:, b, e:] = float("nan")
        for layer in (0, L_ - 1):
            got = decode_attention_pooled_unstaged(**x, prefix_ends=ends, layer=layer)
            want = decode_attention_pooled_unstaged_plain(**x, prefix_ends=ends, layer=layer)
            e = (got.float() - want.float()).abs().max().item()
            rel = row_rel_err(got, want)
            if not torch.isfinite(got).all() or e > TOL or rel > POOL_ROW_TOL[
                    "decode_attention_pooled"]:
                raise AssertionError(f"decode_attention_pooled_unstaged D={D_} layer={layer}: "
                                     f"err {e}, per-row relative err {rel}")
            worst, worst_rel = max(worst, e), max(worst_rel, rel)
        del x
    err["decode_attention_pooled_unstaged"] = worst
    log(f"kernel decode_attention_pooled_unstaged (row 12): B=16 T={POOL_T}, prefix ends "
        f"{sorted(set(POOL_BASES))}, hybrid (L 6, D 128) and transformer (L 26, D 64) heads, "
        f"first and last layer, NaN past each end: max_abs_err {worst:.3e} <= {TOL}; per row "
        f"{worst_rel:.3e} <= {POOL_ROW_TOL['decode_attention_pooled']}")

    worst = worst_rel = 0.0
    x = inputs(16, POOL_T, H_LA, H_HQ, H_HKV, H_D)
    x["k_stage"], x["v_stage"] = (randn(gen, H_LA, 16, STAGE, H_W) for _ in range(2))
    for b, e in enumerate(POOL_BASES):
        x["k_cache"][:, b, e:] = float("nan")
        x["v_cache"][:, b, e:] = float("nan")
    bases = torch.tensor(POOL_BASES, dtype=torch.int32, device="cuda")
    lens = torch.tensor(POOL_LENS, dtype=torch.int32, device="cuda")
    for layer in (0, H_LA - 1):
        got = decode_attention_pooled_staged(**x, bases=bases, lens=lens, layer=layer)
        want = decode_attention_pooled_staged_plain(**x, bases=bases, lens=lens, layer=layer)
        e = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        if not torch.isfinite(got).all() or e > TOL or rel > POOL_ROW_TOL["decode_attention_pooled"]:
            raise AssertionError(f"decode_attention_pooled D=128 layer={layer}: err {e}, {rel}")
        worst, worst_rel = max(worst, e), max(worst_rel, rel)
    err["decode_attention_pooled_hd128"] = worst
    log(f"kernel decode_attention_pooled at head dim 128 (row 6): B=16 T={POOL_T} L={H_LA}, bases "
        f"and ring lengths as above, NaN past each base: max_abs_err {worst:.3e} <= {TOL}; per row "
        f"{worst_rel:.3e}")
    del x

    err["prefill_attention_hd128"] = check_prefill(gen, H_HQ, H_HKV, H_D)
    return err


def check_hybrid_backbone_against_cpu() -> dict:
    """The hybrid backbone on the card (kernels) against the CPU path (plain
    versions) on a small input: 4 layers (attention at 1 and 3) with the
    flagship's head dim 128 and d_state 128, d_model 128, bf16 weights: a
    prefill of 5 positions and 12 solo decode steps; 4 rows at their own
    positions for 14 pooled ring steps (a flush every 6), with an fp32 and
    a bf16 SSM state; 14 stage-less pooled steps. Returns the largest
    |difference| of the hidden states per mode."""
    import torch

    from zonos_vibes_tpu_torch.config import BackboneConfig, _freeze
    from zonos_vibes_tpu_torch.engine.pool import flush_pool_rings
    from zonos_vibes_tpu_torch.models.mamba_backbone import HybridBackbone

    cfg = BackboneConfig(
        d_model=128, n_layer=4, d_intermediate=0, attn_mlp_d_intermediate=256,
        attn_layer_idx=(1, 3), rms_norm=True, residual_in_fp32=True,
        ssm_cfg=_freeze({"layer": "Mamba2", "d_state": 128, "headdim": 64, "chunk_size": 8}),
        attn_cfg=_freeze({"num_heads": 2, "num_heads_kv": 1, "head_dim": 128,
                          "rotary_emb_dim": 64}))
    bb = HybridBackbone(cfg)
    gen = torch.Generator().manual_seed(6)
    params = bb.init(gen, torch.bfloat16, "cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    worst = {}
    with torch.inference_mode():
        # Solo: prefill, then decode steps.
        sides = {dev: (to(params, dev), bb.allocate_cache(2, 32, torch.bfloat16, dev))
                 for dev in ("cpu", "cuda")}
        xs = [torch.randn(2, 5, 128, generator=gen).to(torch.bfloat16)]
        xs += [torch.randn(2, 1, 128, generator=gen).to(torch.bfloat16) for _ in range(12)]
        w = 0.0
        for i, x in enumerate(xs):
            off = 0 if i == 0 else 4 + i
            outs = {dev: bb.forward(p, x.to(dev), c, off) for dev, (p, c) in sides.items()}
            w = max(w, (outs["cuda"].float().cpu() - outs["cpu"].float()).abs().max().item())
        worst["solo"] = w
        # Pooled: ring (fp32 and bf16 state) and stage-less.
        for mode, state_dtype in (("ring", torch.float32), ("ring_bf16_state", torch.bfloat16),
                                  ("stage_less", torch.float32)):
            ring = mode != "stage_less"
            prefix = [torch.randn(2, 4, 64, 128, generator=gen).to(torch.bfloat16)
                      for _ in range(2)]
            state = torch.randn(2, 4, 128, 256, generator=gen) * 0.3
            sides = {}
            for dev in ("cpu", "cuda"):
                c = bb.allocate_cache(4, 64, torch.bfloat16, dev, state_dtype, pool_ring=ring)
                if ring:  # an 8-row ring, so that flushes land inside the 64 positions
                    for name in ("k_stage", "v_stage"):
                        c[name] = torch.zeros(2, 4, 8, 128, dtype=torch.bfloat16, device=dev)
                c["k"].copy_(prefix[0])
                c["v"].copy_(prefix[1])
                c["ssm"].copy_(state)
                pos = torch.tensor([20, 9], device=dev)  # 2 slots: CFG rows [20, 9, 20, 9]
                sides[dev] = (to(params, dev), {"cache": c, "pos": pos, "flush_base": pos.clone()})
            w = 0.0
            for i in range(14):
                x = torch.randn(4, 1, 128, generator=gen).to(torch.bfloat16)
                outs = {}
                for dev, (p, pool) in sides.items():
                    outs[dev] = bb.forward(
                        p, x.to(dev), pool["cache"], 0,
                        positions=torch.cat([pool["pos"], pool["pos"]]),
                        pool_base=torch.cat([pool["flush_base"]] * 2) if ring else None)
                    pool["pos"] = pool["pos"] + 1
                    if ring and i % 6 == 5:
                        flush_pool_rings(pool)
                w = max(w, (outs["cuda"].float().cpu() - outs["cpu"].float()).abs().max().item())
            worst[mode] = w
    if max(worst.values()) > 0.1:
        raise AssertionError(f"hybrid backbone card vs CPU: max |hidden diff| {worst}")
    log(f"reference: hybrid backbone (4 layers, attention at 1/3, head dim 128, d_state 128, "
        f"bf16) on the card vs the CPU plain path: max |hidden diff| solo prefill + 12 steps "
        f"{worst['solo']:.3e}, 2 slots (4 rows) x 14 ring steps across two flushes "
        f"{worst['ring']:.3e} (fp32 state) / {worst['ring_bf16_state']:.3e} (bf16 state), 14 "
        f"stage-less steps {worst['stage_less']:.3e}; all <= 0.1")
    return worst


def run_hybrid_path(card: str):
    """Phase 3, the hybrid: text -> codes -> WAV through
    ``ZonosPipeline.from_config(ZONOS_V01_HYBRID)``, counted. Returns the
    pipeline and the numbers."""
    import numpy as np
    import torch

    from zonos_vibes_tpu_torch.config import ZONOS_V01_HYBRID
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
    from zonos_vibes_tpu_torch.serve.sample import wav_bytes

    t0 = time.perf_counter()
    pipe = ZonosPipeline.from_config(ZONOS_V01_HYBRID, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(422))
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(pipe.params["backbone"]))
    log(f"init hybrid: random bf16 weights in {time.perf_counter() - t0:.1f} s; backbone "
        f"{nparams / 1e9:.3f} G parameters ({param_bytes(pipe.params) / 2**30:.3f} GiB Zonos); "
        f"memory_allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB with the DAC")
    cond = pipe.make_cond_dict(text=TEXT, language="en-us")
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

    codes, steps = result.codes, result.steps
    cond_len = pipe.prepare_conditioning(cond).shape[1]
    if codes.shape != (1, 9, AUDIO_FRAMES) or int(codes.min()) < 0 or int(codes.max()) >= 1024:
        raise AssertionError(f"hybrid codes out of range or misshapen: {tuple(codes.shape)}")
    if result.valid_length != AUDIO_FRAMES:
        raise AssertionError(f"hybrid valid length {result.valid_length} != {AUDIO_FRAMES}")
    if wav.size == 0 or not np.isfinite(wav).all():
        raise AssertionError("hybrid waveform empty or not finite")
    want = {**NO_TRANSFORMER_LAUNCHES, "decode_attention_pooled": 0, "stage_splice_rows": 0,
            "decode_attention_pooled_unstaged": 0, "prefill_attention": H_LA,
            "decode_attention_unstaged": H_LA * steps, "ssd_gate_step": H_M * steps}
    if launches != want:
        raise AssertionError(f"hybrid launch counts {launches}, expected {want}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_hybrid.wav").write_bytes(wav_bytes(wav[0], pipe.dac.sampling_rate))
    graphs = graph_against_eager("hybrid", pipe.model, pipe.params,
                                 pipe.prepare_conditioning(cond), result, want,
                                 {"decode_attention_unstaged": H_LA, "ssd_gate_step": H_M},
                                 STEP_BOUND_MS["hybrid"], card)
    audio_s = wav.shape[-1] / pipe.dac.sampling_rate
    e2e = {
        "cond_len": cond_len, "steps": steps, "audio_s": audio_s,
        "T": _solo_cache_len(cond_len),
        "prefill_ms": result.prefill_seconds * 1e3,
        "decode_ms_per_step": result.decode_seconds * 1e3 / steps,
        "generate_s": t_gen, "dac_ms": t_dac * 1e3, "rtf": audio_s / (t_gen + t_dac),
        "launches": launches, "graphs": graphs,
    }
    log(f"e2e hybrid ({card}): text -> {audio_s:.2f} s of audio; cond_len {cond_len}, {steps} "
        f"decode steps; prefill {e2e['prefill_ms']:.2f} ms, decode "
        f"{e2e['decode_ms_per_step']:.3f} ms/step, DAC {e2e['dac_ms']:.1f} ms, RTF "
        f"{e2e['rtf']:.3f}; launches {launches}")
    return pipe, e2e


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _solo_cache_len(cond_len: int) -> int:
    from zonos_vibes_tpu_torch.engine.generate import _find_multiple

    T = cond_len + AUDIO_FRAMES + 9
    return _find_multiple(T, 512 if T >= 1024 else 8)


def run_stage_less(pipe, pool_e2e: dict, card: str) -> dict:
    """Phase 3, the stage-less pooled decode (row 12) on the hybrid pool's
    state right after its last join: POOL_SEGMENT steps of all 16 rows at
    their own positions through ``model.compute_logits`` with ``positions``
    and no ring, each held against the ring mode's step (``pool_base``)
    from the same state. Both read the same cache prefix; the ring steps
    keep their columns in the ring while the stage-less steps write theirs
    at each row's position, which the ring mode never reads. Every step's
    input frame is drawn in advance from a seed.

    Three passes from the same state back the limit: the kernels (counted
    and timed); the same steps with both modes' attention in its plain
    version, which must agree exactly (the modes then gather the same keys
    in the same order, so a kernel difference is the only cause left); and
    the kernels with each stage-less column moved one position on after its
    step (a wrong stage-less step), which must exceed the limit."""
    import torch

    import zonos_vibes_tpu_torch.models.mamba_backbone as mb
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_pooled_staged_plain, decode_attention_pooled_unstaged_plain)

    model, params = pipe.model, pipe.params
    snap = pool_e2e.pop("snapshot")
    start = {k: snap[k].clone() for k in ("k", "v", "k_stage", "v_stage", "conv", "ssm")}
    pos0 = torch.cat([snap["pos"], snap["pos"]])
    rows = torch.arange(pos0.numel(), device="cuda")
    gen = torch.Generator("cuda").manual_seed(7)
    frames = torch.randint(0, 1024, (POOL_SEGMENT, POOL_SLOTS, 9, 1), generator=gen,
                           device="cuda")
    vocab = model.config.head_vocab_size  # the columns past it are masked

    def one_pass(shift_column: bool = False):
        for k, v in start.items():
            snap[k].copy_(v)
        ring_cache = {k: snap[k] for k in start}
        sl_cache = {k: snap[k] for k in ("k", "v", "conv", "ssm")}
        pos = pos0.clone()
        counts = {k: 0 for k in build.LAUNCHES}
        worst, diff_sum, diff_n, largest, t_sl, logits = 0.0, 0.0, 0, 0.0, 0.0, []
        with torch.inference_mode():
            for i in range(POOL_SEGMENT):
                emb = model.embed_codes(params, frames[i])
                emb = torch.cat([emb, emb])
                conv, ssm = snap["conv"].clone(), snap["ssm"].clone()
                ring = model.compute_logits(params, emb, ring_cache, 0, snap["cfg_scale"], None,
                                            positions=pos, pool_base=pos0)
                snap["conv"].copy_(conv)
                snap["ssm"].copy_(ssm)
                del conv, ssm
                torch.cuda.synchronize()
                before = dict(build.LAUNCHES)
                t0 = time.perf_counter()
                sl = model.compute_logits(params, emb, sl_cache, 0, snap["cfg_scale"], None,
                                          positions=pos)
                torch.cuda.synchronize()
                t_sl += time.perf_counter() - t0
                for k, v in build.LAUNCHES.items():
                    counts[k] += v - before[k]
                if shift_column:
                    at = pos.long()
                    for name in ("k", "v"):
                        snap[name][:, rows, at + 1] = snap[name][:, rows, at]
                        snap[name][:, rows, at] = start[name][:, rows, at]
                if not torch.isfinite(sl).all():
                    raise AssertionError(f"stage-less step {i}: logits not finite")
                diff = (sl - ring)[..., :vocab].abs()
                worst = max(worst, diff.max().item())
                diff_sum, diff_n = diff_sum + diff.sum().item(), diff_n + diff.numel()
                largest = max(largest, ring[..., :vocab].abs().max().item())
                logits.append(sl[..., :vocab].float())
                pos = pos + 1
        return dict(worst=worst, mean=diff_sum / diff_n, largest=largest, counts=counts,
                    ms_per_step=t_sl * 1e3 / POOL_SEGMENT, logits=logits, prefix_ends=pos - 1)

    kern = one_pass()
    saved = mb.decode_attention_pooled_staged, mb.decode_attention_pooled_unstaged
    mb.decode_attention_pooled_staged = decode_attention_pooled_staged_plain
    mb.decode_attention_pooled_unstaged = decode_attention_pooled_unstaged_plain
    try:
        plain = one_pass()
    finally:
        mb.decode_attention_pooled_staged, mb.decode_attention_pooled_unstaged = saved
    wrong = one_pass(shift_column=True)
    kernel_vs_plain = max((a - b).abs().max().item()
                          for a, b in zip(kern["logits"], plain["logits"]))

    want = {k: 0 for k in kern["counts"]}
    want.update(decode_attention_pooled_unstaged=H_LA * POOL_SEGMENT,
                ssd_gate_step=H_M * POOL_SEGMENT)
    if kern["counts"] != want:
        raise AssertionError(f"stage-less launch counts {kern['counts']}, expected {want}")
    if plain["worst"] != 0.0:
        raise AssertionError(f"stage-less vs ring logits with plain attention: max |diff| "
                             f"{plain['worst']}, expected 0 (the modes differ in more than "
                             f"the attention kernels' arithmetic)")
    if kern["worst"] > STAGELESS_LOGIT_TOL:
        raise AssertionError(f"stage-less vs ring logits: max |diff| {kern['worst']}")
    if wrong["worst"] <= STAGELESS_LOGIT_TOL:
        raise AssertionError(f"a stage-less step with its column one position off gives max "
                             f"|diff| {wrong['worst']} <= {STAGELESS_LOGIT_TOL}: the check "
                             f"cannot tell it from a sound one")
    out = {"steps": POOL_SEGMENT, "max_logit_diff": kern["worst"],
           "mean_logit_diff": kern["mean"], "max_logit": kern["largest"],
           "plain_max_logit_diff": plain["worst"], "kernel_vs_plain": kernel_vs_plain,
           "wrong_max_logit_diff": wrong["worst"], "wrong_mean_logit_diff": wrong["mean"],
           "launches": kern["counts"], "ms_per_step": kern["ms_per_step"],
           "prefix_ends": kern["prefix_ends"].tolist()}
    log(f"e2e hybrid stage-less pooled ({card}): {POOL_SEGMENT} steps of 16 rows from the pool's "
        f"state after its last join (positions {int(pos0.min())}-{int(pos0.max())} at the "
        f"start), {out['ms_per_step']:.3f} ms/step; logits vs the ring mode's from the same "
        f"state: max |diff| {kern['worst']:.4e} <= {STAGELESS_LOGIT_TOL} (mean |diff| "
        f"{kern['mean']:.4e}, largest |logit| {kern['largest']:.3f}); with plain attention in "
        f"both modes {plain['worst']:.4e} (must be 0); stage-less kernels vs stage-less plain "
        f"{kernel_vs_plain:.4e}; with each stage-less column one position off "
        f"{wrong['worst']:.4e} (mean {wrong['mean']:.4e}) > {STAGELESS_LOGIT_TOL}; launches "
        f"{kern['counts']}")
    return out


def ssd_bound(B, sdt_bytes):
    nbytes = 2 * B * M_N * M_HP * sdt_bytes + 3 * B * M_HP * 2 + 4 * B * (2 * M_H + 2 * M_N)
    flops = 6 * B * M_N * M_HP + 12 * B * M_HP
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ssd(gen, card) -> dict:
    """Rows 9 and 10 at the solo step's B = 2 and the pool's 16, with an fp32
    and a bf16 state: {(B, "fp32" or "bf16"): (kernel, plain, bound ms,
    bound_by)}. The 42 planes are cycled through, so that every launch reads
    its plane from device memory as a decode step does."""
    import itertools

    import torch

    from zonos_vibes_tpu_torch.ops.cuda.mamba_step import (
        ssd_gate_step, ssd_gate_step_layered, ssd_gate_step_layered_plain)

    ssd = {}
    for Bs, name in ((B, "ssd_gate_step"), (POOL_M, "ssd_gate_step_layered")):
        for sdt, label, nb in ((torch.float32, "fp32", 4), (torch.bfloat16, "bf16", 2)):
            states, x = ssd_inputs(gen, Bs, H_M, sdt)
            states.normal_(generator=gen)
            idx = itertools.cycle(range(H_M))
            if Bs == B:
                def kernel():
                    return ssd_gate_step(states[next(idx)], **x)
            else:
                def kernel():
                    return ssd_gate_step_layered(states, next(idx), **x)
            ms = device_ms(kernel, H_M * 10)
            plain = device_ms(lambda: ssd_gate_step_layered_plain(states, next(idx), **x), H_M)
            b, by = ssd_bound(Bs, nb)
            ssd[(Bs, label)] = (ms, plain, b, by)
            log(f"time {name} B={Bs} state {label} [{H_M} planes cycled] ({card}): kernel_ms "
                f"{ms:.5f} plain_ms {plain:.4f} library_ms none (no single PyTorch call computes "
                f"the fused update, readout, gate and norm) bound_ms {b:.5f} ({by}); per "
                f"decode step ({H_M} launches) {H_M * ms:.4f} ms against {H_M * b:.4f}")
            del states
    return ssd


def time_hybrid_kernels(solo: dict, pool: dict, stage_less: dict, errors: dict,
                        card: str) -> list[dict]:
    """Phase 4, the hybrid's kernels at the shapes its paths gave them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    ssd = time_ssd(gen, card)
    for Bs, name, line, count in ((B, "ssd_gate_step", 178, solo["launches"]["ssd_gate_step"]),
                                  (POOL_M, "ssd_gate_step_layered", 116,
                                   pool["launches"]["ssd_gate_step"])):
        ms, plain, b, by = ssd[(Bs, "fp32")]
        rows.append(dict(name=name, route="cuda", source="zonos_vibes_tpu_torch/csrc/mamba_step.cu",
                         replaces=f"zonos_vibes_tpu/ops/pallas/mamba_step.py:{line}",
                         launches=count, max_abs_err=errors[name], ms=ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, library_ms=None))

    # Row 11 at the solo path's last step.
    ms, plain, lib, b, by = time_unstaged(gen, solo["T"], solo["cond_len"] + solo["steps"] + 1,
                                          card)
    rows.append(dict(name="decode_attention_unstaged", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:1158",
                     launches=solo["launches"]["decode_attention_unstaged"],
                     max_abs_err=errors["decode_attention_unstaged"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))

    # Row 3 at head dim 128: the solo path's prefill.
    S = solo["cond_len"] + 1
    ms, plain, lib, b, by = time_prefill(gen, H_HQ, H_HKV, H_D, S, solo["T"], card)[S, 0]
    rows.append(dict(name="prefill_attention_hd128", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/prefill_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/prefill_attention.py:111",
                     launches=solo["launches"]["prefill_attention"],
                     max_abs_err=errors["prefill_attention_hd128"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))

    # Rows 12 and 6 at 16 rows over the pool's 3584 positions.
    ms, plain, lib, b, by = time_pooled_unstaged(gen, stage_less["prefix_ends"], card)
    rows.append(dict(name="decode_attention_pooled_unstaged", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:1092",
                     launches=stage_less["launches"]["decode_attention_pooled_unstaged"],
                     max_abs_err=errors["decode_attention_pooled_unstaged"], ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib))
    ms, plain, lib, b, by, held = time_pooled_hd128(gen, pool["bases_mid"] * 2,
                                                    [POOL_SEGMENT - 1] * 2 * POOL_SLOTS, card)
    require_stage_write("decode_attention_pooled_hd128", held)
    rows.append(dict(name="decode_attention_pooled_hd128", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:790",
                     launches=pool["launches"]["decode_attention_pooled"],
                     max_abs_err=errors["decode_attention_pooled_hd128"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


def time_unstaged(gen, T, seq_end, card):
    """Row 11 at the hybrid's solo shapes (CFG batch 2, 16/4 heads at head
    dim 128), layer 3 of 6, attending [0, seq_end): kernel, plain version and
    SDPA. Returns (ms, plain, library, bound, by)."""
    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_unstaged, decode_attention_unstaged_plain)

    q = randn(gen, B, 1, H_HQ, H_D)
    k, v = randn(gen, H_LA, B, T, H_W), randn(gen, H_LA, B, T, H_W)
    sc = torch.tensor([seq_end], dtype=torch.int32, device="cuda")
    kh = k[3, :, :seq_end].view(B, seq_end, H_HKV, H_D).transpose(1, 2).contiguous()
    vh = v[3, :, :seq_end].view(B, seq_end, H_HKV, H_D).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    ms = device_ms(lambda: decode_attention_unstaged(q, k, v, sc, 3), 200)
    plain = device_ms(lambda: decode_attention_unstaged_plain(q, k, v, sc, 3), 20)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True), 200)
    b, by = bound(2 * B * seq_end * H_W * 2 + 2 * B * H_HQ * H_D * 2, 4 * B * H_HQ * seq_end * H_D)
    log(f"time decode_attention_unstaged T={T} seq_end={seq_end} ({card}): kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} library_ms {lib:.4f} (SDPA, gathered K/V) bound_ms {b:.5f} "
        f"({by}); kernel / SDPA {ms / lib:.2f}")
    return ms, plain, lib, b, by


def _hybrid_pooled_inputs(gen, stage: bool):
    x = dict(q=randn(gen, POOL_M, 1, H_HQ, H_D), k_cache=randn(gen, H_LA, POOL_M, POOL_T, H_W),
             v_cache=randn(gen, H_LA, POOL_M, POOL_T, H_W), k_cur=randn(gen, POOL_M, H_W),
             v_cur=randn(gen, POOL_M, H_W))
    if stage:
        x["k_stage"] = randn(gen, H_LA, POOL_M, STAGE, H_W)
        x["v_stage"] = randn(gen, H_LA, POOL_M, STAGE, H_W)
    return x


def time_pooled_unstaged(gen, ends, card):
    """Row 12 at the hybrid pool's shapes (16 rows, T = 3584, head dim 128),
    layer 3, rows at prefix ends ``ends``: kernel, plain version and one
    masked SDPA. Returns (ms, plain, library, bound, by)."""
    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_pooled_unstaged, decode_attention_pooled_unstaged_plain)

    x = _hybrid_pooled_inputs(gen, stage=False)
    pe = torch.tensor(ends, dtype=torch.int32, device="cuda")
    qg, kg, vg, mask, n_total = gathered_sdpa_inputs(x, 3, ends)
    ms = device_ms(lambda: decode_attention_pooled_unstaged(**x, prefix_ends=pe, layer=3), 200)
    plain = device_ms(lambda: decode_attention_pooled_unstaged_plain(**x, prefix_ends=pe,
                                                                     layer=3), 10)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                           enable_gqa=True), 200)
    b, by = bound(2 * n_total * H_W * 2 + 2 * POOL_M * H_HQ * H_D * 2 + POOL_M * 4,
                  4 * H_HQ * H_D * n_total)
    log(f"time decode_attention_pooled_unstaged B={POOL_M} T={POOL_T} prefix ends {min(ends)}-"
        f"{max(ends)} ({card}): kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"(SDPA, per-row mask over gathered K/V) bound_ms {b:.5f} ({by}); kernel / SDPA "
        f"{ms / lib:.2f}")
    return ms, plain, lib, b, by


def time_pooled_hd128(gen, bases, lens, card):
    """Row 6 at the hybrid pool's shapes (head dim 128, 16/4 heads), layer
    3, with its stage write: kernel, plain version and one masked SDPA.
    Returns (ms, plain, library, bound, by, stage write held)."""
    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_pooled_staged, decode_attention_pooled_staged_plain)

    x = _hybrid_pooled_inputs(gen, stage=True)
    bt = torch.tensor(bases, dtype=torch.int32, device="cuda")
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qg, kg, vg, mask, n_total = gathered_sdpa_inputs(x, 3, bases, lens)
    before = stage_planes(x, 3)
    ms = device_ms(lambda: decode_attention_pooled_staged(**x, bases=bt, lens=lt, layer=3), 200)
    held = stage_write_held(x, before, 3, lt)
    plain = device_ms(lambda: decode_attention_pooled_staged_plain(**x, bases=bt, lens=lt,
                                                                   layer=3), 10)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                           enable_gqa=True), 200)
    b, by = bound(2 * n_total * H_W * 2 + 2 * POOL_M * H_HQ * H_D * 2 + 2 * POOL_M * 4
                  + 2 * POOL_M * H_W * 2, 4 * H_HQ * H_D * n_total)
    log(f"time decode_attention_pooled head dim 128 B={POOL_M} T={POOL_T} bases {min(bases)}-"
        f"{max(bases)} ({card}): kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"(SDPA, masked) bound_ms {b:.5f} ({by}); kernel / SDPA {ms / lib:.2f}; "
        f"{_write_label(held)}")
    return ms, plain, lib, b, by, held


# Long prefill chunks timed beside SDPA and the bound: (S, offset).
PREFILL_LONG = ((2048, 0), (512, 64))


def time_prefill(gen, Hq, Hkv, Dh, S, T, card, long=PREFILL_LONG, Bx=B) -> dict:
    """Row 3 at a path's chunk (S at offset 0 in a cache of T, batch
    ``Bx``): the kernel, the plain version and SDPA; then the ``long``
    chunks, kernel and SDPA only. Returns {(S, offset): (kernel, plain or
    None, library, bound ms, bound_by)}."""
    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import (
        prefill_attention, prefill_attention_plain)

    W_ = Hkv * Dh
    out = {}
    for S_, offset, T_ in ((S, 0, T), *((s_, o_, s_ + o_) for s_, o_ in long)):
        end = offset + S_
        q = randn(gen, Bx, S_, Hq, Dh)
        k, v = randn(gen, Bx, T_, W_), randn(gen, Bx, T_, W_)
        qh = q.transpose(1, 2).contiguous()
        kh = k[:, :end].view(Bx, end, Hkv, Dh).transpose(1, 2).contiguous()
        vh = v[:, :end].view(Bx, end, Hkv, Dh).transpose(1, 2).contiguous()
        if offset:  # query i attends keys [0, offset + i]
            mask = (torch.arange(end, device="cuda")[None, :]
                    <= offset + torch.arange(S_, device="cuda")[:, None])
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=True)
        iters = 200 if S_ < 256 else 20
        ms = device_ms(lambda: prefill_attention(q, k, v, offset), iters)
        lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True,
                                                               **sdpa), iters)
        b, by = bound(2 * Bx * S_ * Hq * Dh * 2 + 2 * Bx * end * W_ * 2,
                      4 * Bx * Hq * Dh * (S_ * offset + S_ * (S_ + 1) / 2))
        plain = None
        if not out:
            plain = device_ms(lambda: prefill_attention_plain(q, k, v, offset), 20)
        out[S_, offset] = (ms, plain, lib, b, by)
        log(f"time prefill_attention D={Dh} Hq={Hq} Hkv={Hkv} B={Bx} S={S_} offset={offset} T={T_} "
            f"({card}): kernel_ms {ms:.4f} plain_ms {'-' if plain is None else f'{plain:.4f}'} "
            f"library_ms {lib:.4f} (SDPA, {'masked' if offset else 'causal'}) bound_ms {b:.6f} ({by}); "
            f"kernel / SDPA {ms / lib:.2f}")
        del q, k, v, qh, kh, vh
    return out


def main_path_decode_step(cond_len: int, steps: int, lp: int = 0) -> tuple[int, int, int]:
    """(T, flushed_end, stage_len) of a solo path's last decode step after
    an ``lp``-frame audio prefix: stage_base = cond_len + lp + 1 plus the
    flushed stages; the step attends positions [0, cond_len + lp +
    steps]."""
    from zonos_vibes_tpu_torch.engine.generate import _find_multiple

    T = cond_len + lp + AUDIO_FRAMES + 9
    T = _find_multiple(T, 512 if T >= 1024 else 8)
    base = cond_len + lp + 1
    last_pos = cond_len + lp + steps
    fe = base + ((last_pos - base) // STAGE) * STAGE
    return T, fe, last_pos - fe


def stage_planes(x, layer) -> dict:
    """Copies of layer ``layer``'s stage planes of a staged call's inputs."""
    return {n: x[n][layer:layer + 1].clone() for n in ("k_stage", "v_stage")}


def stage_write_held(x, before, layer, slots) -> bool:
    """Whether the staged calls just made on ``x`` stored their columns as
    the decode step needs them: layer ``layer``'s stage planes equal
    ``stage_splice_rows_plain`` of the columns at ``slots`` (int32 [B]) on
    ``before``, the planes as they were. A version of the port that kept
    the splice as a launch of its own leaves them unchanged."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.stage_write import stage_splice_rows_plain

    torch.cuda.synchronize()
    return all(torch.equal(x[n][layer:layer + 1],
                           stage_splice_rows_plain(before[n].clone(), x[col][None], slots))
               for n, col in (("k_stage", "k_cur"), ("v_stage", "v_cur")))


def require_stage_write(name, held) -> None:
    if not held:
        raise AssertionError(f"{name}: the timed calls' stage write differs from the plain "
                             f"splice")


def _write_label(held) -> str:
    return ("stage write bit-equal to the plain splice" if held else
            "stage not written as the plain splice writes it")


def time_decode(gen, T, fe, sl, label, card, quant=False, Bx=B):
    """Row 1 (row 5 with ``quant``: an int8 prefix) at one step's scalars,
    layer 5 of the 26-layer cache, CFG batch ``Bx``, with its stage write:
    kernel, plain version and SDPA over the gathered (dequantized) K/V.
    Returns (ms, plain, library, bound, by, stage write held); the bound
    counts the stage write's bytes."""
    import torch
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain, decode_attention_layered_q,
        decode_attention_layered_q_plain)
    from zonos_vibes_tpu_torch.ops.quant import dequantize_rows, quantize_rows

    x = decode_inputs(gen, T, Bx)
    sc = torch.tensor([fe, sl, 5], dtype=torch.int32, device="cuda")
    n = fe + sl + 1
    parts = {}
    for name in ("k", "v"):
        prefix = x[name + "_cache"][5, :, :fe]
        if quant:
            x[name + "_cache"], x[name + "_scale"] = quantize_rows(x[name + "_cache"], HKV)
            prefix = dequantize_rows(x[name + "_cache"][5, :, :fe],
                                     x[name + "_scale"][5, :, :fe]).to(torch.bfloat16)
        g = torch.cat([prefix, x[name + "_stage"][5, :, :sl], x[name + "_cur"][:, None]], 1)
        parts[name] = g.view(Bx, n, HKV, D).transpose(1, 2).contiguous()
    qg = x["q"].transpose(1, 2).contiguous()
    kernel, plain = ((decode_attention_layered_q, decode_attention_layered_q_plain) if quant
                     else (decode_attention_layered, decode_attention_layered_plain))
    before = stage_planes(x, 5)
    ms = device_ms(lambda: kernel(**x, scalars=sc), 200)
    held = stage_write_held(x, before, 5, torch.full((Bx,), sl, dtype=torch.int32, device="cuda"))
    plain_ms = device_ms(lambda: plain(**x, scalars=sc), 20)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qg, parts["k"], parts["v"],
                                                           enable_gqa=True), 200)
    per_prefix = W + HKV * 4 if quant else W * 2
    nbytes = (2 * Bx * fe * per_prefix + 2 * Bx * (sl + 1) * W * 2 + 2 * Bx * HQ * D * 2
              + 2 * Bx * W * 2)
    b, by = bound(nbytes, 4 * Bx * HQ * n * D)
    log(f"time decode_attention{'_q' if quant else ''} {label} B={Bx} T={T} flushed_end={fe} "
        f"stage_len={sl} ({card}): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{lib:.4f} (SDPA, {'dequantized ' if quant else ''}gathered K/V) bound_ms {b:.5f} ({by}); "
        f"kernel / SDPA {ms / lib:.2f}; {_write_label(held)}")
    return ms, plain_ms, lib, b, by, held


def time_kernels(e2e: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4: kernel, plain and library times at the main path's shapes."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.stage_write import stage_splice, stage_splice_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    cond_len = e2e["cond_len"]
    T, fe, sl = main_path_decode_step(cond_len, e2e["steps"])
    rows = []
    ms, plain, lib, b, by, held = time_decode(gen, T, fe, sl, "main-path last step", card)
    require_stage_write("decode_attention", held)
    require_stage_write("decode_attention", time_decode(gen, 3072, 2944, 127, "30 s depth",
                                                        card)[5])
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
        f"{plain:.4f} library_ms {lib:.4f} bound_ms {b:.6f} ({by}); standalone, "
        f"{e2e['launches']['stage_splice']} launches on the main path (the decode-attention "
        f"calls store the columns)")
    rows.append(dict(name="stage_splice", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/stage_write.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/stage_write.py:41",
                     launches=e2e["launches"]["stage_splice"],
                     max_abs_err=errors["stage_splice"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))

    ms, plain, lib, b, by = time_prefill(gen, HQ, HKV, D, cond_len + 1, T, card)[cond_len + 1, 0]
    rows.append(dict(name="prefill_attention", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/prefill_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/prefill_attention.py:111",
                     launches=e2e["launches"]["prefill_attention"],
                     max_abs_err=errors["prefill_attention"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


def time_qmm(gen, G, K, N, out_dtype, layers, Ms) -> dict:
    """``qmm_int8`` at each M in ``Ms``: {M: (kernel, plain, library, bound
    ms, bound_by)}. The weights of all ``layers`` are cycled through, so
    that each launch reads its weight from device memory as a decode step
    does (one layer's fc1 is 33.5 MB, within the 50 MB L2). The library call
    is the matmul on a bf16 copy of the weight."""
    import itertools

    import torch

    from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8, qmm_int8_plain

    w = torch.randint(-127, 128, (layers, G, K, N), dtype=torch.int8, device="cuda",
                      generator=gen)
    scale = torch.rand((layers, G, 1, N), device="cuda", generator=gen) * 1e-3 + 1e-4
    w_bf16 = torch.empty(w.shape, dtype=torch.bfloat16, device="cuda")
    for l in range(layers):
        w_bf16[l] = (w[l].float() * scale[l]).to(torch.bfloat16)
    lib_w = w_bf16[:, 0] if G == 1 else w_bf16
    idx = itertools.cycle(range(layers))
    out = {}
    for M in Ms:
        x = randn(gen, M, K)

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
        out[M] = (ms, plain, lib, *bound(M * K * 2 + G * K * N + G * N * 4
                                         + M * G * N * out_bytes, 2 * M * G * K * N))
    return out


def time_qmm_steps(gen, card, Ms=(2, POOL_M)):
    """One forward's 105 ``qmm_int8`` launches at each M of ``Ms``: M = 2
    (the solo decode step) and M = 16 (the 8-slot pool's step), each shape
    timed alone and summed over its launches. Returns ({M: {"ms", "plain",
    "lib", "bound"}}, {(shape name, M): (kernel, plain, library, bound ms,
    bound_by)})."""
    import torch

    step = {M: dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0) for M in Ms}
    per_shape = {}
    shapes = [(name, 1, k, n, torch.bfloat16, L) for name, (k, n) in PROJECTIONS.items()]
    shapes.append(("heads", *HEADS_SHAPE, torch.float32, 1))
    for name, G, K, N, out_dtype, count in shapes:
        times = time_qmm(gen, G, K, N, out_dtype, count, tuple(step))
        for M, (ms, plain, lib, b, by) in times.items():
            per_shape[name, M] = times[M]
            for key, v in zip(("ms", "plain", "lib", "bound"), (ms, plain, lib, b)):
                step[M][key] += count * v
            log(f"time qmm_int8 {name} M={M} G={G} {K}x{N} ({card}): kernel_ms {ms:.5f} "
                f"plain_ms {plain:.4f} library_ms {lib:.5f} (matmul, bf16 weight) bound_ms "
                f"{b:.5f} ({by})")
    for M, t in step.items():
        label = "one decode step" if M <= 2 else f"one step at M={M}"
        log(f"time qmm_int8 {label} (M={M}), 105 launches ({card}): kernel_ms {t['ms']:.4f} "
            f"plain_ms {t['plain']:.3f} library_ms {t['lib']:.4f} bound_ms {t['bound']:.4f}; "
            f"kernel / library {t['ms'] / t['lib']:.3f}")
    return step, per_shape


def time_int8_kernels(e2e: dict, pool_int8: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4, the int8 path's kernels at the shapes of its main path."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    cond_len, steps = e2e["cond_len"], e2e["steps"]
    rows = []

    step, per_shape = time_qmm_steps(gen, card)
    fc1 = per_shape["fc1", 2]
    M = 2 * (cond_len + 1)
    prefill = time_qmm(gen, 1, *PROJECTIONS["fc1"], torch.bfloat16, L, (M,))[M]
    log(f"time qmm_int8 fc1 prefill M={M} ({card}): kernel_ms {prefill[0]:.4f} plain_ms "
        f"{prefill[1]:.4f} library_ms {prefill[2]:.4f} bound_ms {prefill[3]:.5f} ({prefill[4]})")
    source = dict(route="cuda", source="zonos_vibes_tpu_torch/csrc/qmm_int8.cu",
                  replaces="zonos_vibes_tpu/ops/pallas/qmm.py:46", max_abs_err=errors["qmm_int8"])
    ms, plain, lib, b, by = fc1
    rows.append(dict(name="qmm_int8", launches=e2e["launches"]["qmm_int8"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib, **source))
    # The pooled step's 105 launches at M = 16, timed as their sum; launches:
    # those counted during the int8 pool run's pooled steps.
    t = step[POOL_M]
    rows.append(dict(name="qmm_int8_m16_step", launches=pool_int8["step_qmm_launches"],
                     ms=t["ms"], plain_ms=t["plain"], bound_ms=t["bound"], bound_by="bytes",
                     library_ms=t["lib"], **source))
    # fc1 at the prefill's M; launches: one per layer in each of the solo
    # int8 path's prefill forwards (its counted launches, 105 per forward,
    # less those of its decode steps).
    prefills = e2e["launches"]["qmm_int8"] // (4 * L + 1) - steps
    ms, plain, lib, b, by = prefill
    rows.append(dict(name="qmm_int8_m176_fc1", launches=L * prefills, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib, **source))

    T, fe, sl = main_path_decode_step(cond_len, steps)
    ms, plain, lib, b, by, held = time_decode(gen, T, fe, sl, "main-path last step", card,
                                              quant=True)
    require_stage_write("decode_attention_q", held)
    require_stage_write("decode_attention_q", time_decode(gen, 3072, 2944, 127, "30 s depth",
                                                          card, quant=True)[5])
    rows.append(dict(name="decode_attention_q", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:479",
                     launches=e2e["launches"]["decode_attention_q"],
                     max_abs_err=errors["decode_attention_q"], ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


def gathered_sdpa_inputs(x, layer, prefix, ring_rows=None, quant=False):
    """Each row's prefix (dequantized to bf16 for an int8 prefix), ring rows
    and column of layer ``layer`` gathered into [B, Hkv, n_max, D] for one
    SDPA call, with a [B, 1, 1, n_max] mask: (q, k, v, mask, positions)."""
    import torch

    from zonos_vibes_tpu_torch.ops.quant import dequantize_rows

    Bx, _, _, d = x["q"].shape
    w = x["k_cur"].shape[1]
    ring_rows = ring_rows or [0] * Bx
    n = [p + r + 1 for p, r in zip(prefix, ring_rows)]
    kg = torch.zeros(Bx, max(n), w, dtype=torch.bfloat16, device="cuda")
    vg = torch.zeros_like(kg)
    for b in range(Bx):
        for dst, name in ((kg, "k"), (vg, "v")):
            part = x[name + "_cache"][layer, b, :prefix[b]]
            if quant:
                part = dequantize_rows(part, x[name + "_scale"][layer, b, :prefix[b]])
            parts = [part.to(torch.bfloat16)]
            if ring_rows[b]:
                parts.append(x[name + "_stage"][layer, b, :ring_rows[b]])
            parts.append(x[name + "_cur"][b, None])
            dst[b, :n[b]] = torch.cat(parts)
    mask = (torch.arange(max(n), device="cuda")[None, :]
            < torch.tensor(n, device="cuda")[:, None])[:, None, None, :]

    def heads(t):
        return t.view(Bx, max(n), w // d, d).transpose(1, 2).contiguous()

    return x["q"].transpose(1, 2).contiguous(), heads(kg), heads(vg), mask, sum(n)


def time_pooled(gen, quant, label, bases, lens, card):
    """Row 6 (row 8 with ``quant``) at 16 rows over the pool's 3584-position
    cache, layer 5 of 26, with its stage write: kernel, plain version and
    one masked SDPA over the gathered (dequantized) K/V. Returns (ms, plain,
    library, bound, by, stage write held)."""
    import torch.nn.functional as F

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_pooled_staged, decode_attention_pooled_staged_plain,
        decode_attention_pooled_staged_q, decode_attention_pooled_staged_q_plain)

    kernel, plain = ((decode_attention_pooled_staged_q, decode_attention_pooled_staged_q_plain)
                     if quant else
                     (decode_attention_pooled_staged, decode_attention_pooled_staged_plain))
    Bp = len(bases)
    x = pool_decode_inputs(gen, POOL_T, bases, lens)
    if quant:
        x = quantized(x)
    qg, kg, vg, mask, n_total = gathered_sdpa_inputs(x, 5, bases, lens, quant)
    before = stage_planes(x, 5)
    ms = device_ms(lambda: kernel(**x, layer=5), 200)
    held = stage_write_held(x, before, 5, x["lens"])
    plain_ms = device_ms(lambda: plain(**x, layer=5), 10)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                           enable_gqa=True), 200)
    prefix = sum(bases)
    ring = n_total - prefix  # ring rows and current columns
    per_prefix = W + HKV * 4 if quant else W * 2
    nbytes = (2 * prefix * per_prefix + 2 * ring * W * 2 + 2 * Bp * HQ * D * 2 + 2 * Bp * 4
              + 2 * Bp * W * 2)
    b, by = bound(nbytes, 4 * HQ * D * n_total)
    log(f"time decode_attention_pooled{'_q' if quant else ''} B={Bp} T={POOL_T} {label} (bases "
        f"{min(bases)}-{max(bases)}, {ring} ring+current positions) ({card}): kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {lib:.4f} (SDPA, per-row mask over gathered"
        f"{' dequantized' if quant else ''} K/V) bound_ms {b:.5f} ({by}); kernel / SDPA "
        f"{ms / lib:.2f}; {_write_label(held)}")
    return ms, plain_ms, lib, b, by, held


def time_pool_kernels(pool_bf16: dict, pool_int8: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4, the pool's kernels at its shapes (16 CFG rows, T = 3584):
    the main path's spread of bases once every row has joined, and spreads
    near 1800 and near 3000 positions."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.stage_write import (
        stage_splice_rows, stage_splice_rows_plain)

    gen = torch.Generator(device="cuda").manual_seed(11)
    Bp = 2 * POOL_SLOTS
    lens = [(23 * b) % STAGE for b in range(Bp)]
    spreads = [("main path, all rows joined", pool_bf16["bases_mid"] * 2, [POOL_SEGMENT - 1] * Bp),
               ("near 1800", [1800 + 37 * (b - 8) for b in range(Bp)], lens),
               ("near 3000", [3000 + 37 * (b - 8) for b in range(Bp)], lens)]

    rows = []
    for name, quant, pallas_line, stats in (
            ("decode_attention_pooled", False, 790, pool_bf16),
            ("decode_attention_pooled_q", True, 1011, pool_int8)):
        first = None
        for label, bases, lns in spreads:
            t = time_pooled(gen, quant, label, bases, lns, card)
            require_stage_write(name, t[5])
            first = first or t
        ms, plain_ms, lib, b, by, _ = first
        rows.append(dict(name=name, route="cuda",
                         source="zonos_vibes_tpu_torch/csrc/decode_attention.cu",
                         replaces=f"zonos_vibes_tpu/ops/pallas/decode_attention.py:{pallas_line}",
                         launches=stats["launches"][name], max_abs_err=errors[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib))
        torch.cuda.empty_cache()

    stage = randn(gen, L, Bp, STAGE, W)
    cols = randn(gen, L, Bp, W)
    slots = torch.tensor([(7 * b) % STAGE for b in range(Bp)], dtype=torch.int32, device="cuda")
    rows_idx = torch.arange(Bp, device="cuda")
    slots_long = slots.long()
    ms = device_ms(lambda: stage_splice_rows(stage, cols, slots), 500)
    plain_ms = device_ms(lambda: stage_splice_rows_plain(stage, cols, slots), 100)

    def index_assign():
        stage[:, rows_idx, slots_long] = cols

    lib = device_ms(index_assign, 500)
    b, by = bound(2 * L * Bp * W * 2 + Bp * 4, 0)
    log(f"time stage_splice_rows L={L} B={Bp} W={W} ({card}): kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {lib:.4f} (advanced-index assignment) bound_ms {b:.6f} ({by}); "
        f"launches {pool_bf16['launches']['stage_splice_rows']} in the bf16 pool run, "
        f"{pool_int8['launches']['stage_splice_rows']} in the int8 one (standalone: the pooled "
        f"decode-attention calls store the columns)")
    rows.append(dict(name="stage_splice_rows", route="cuda",
                     source="zonos_vibes_tpu_torch/csrc/stage_write.cu",
                     replaces="zonos_vibes_tpu/ops/pallas/stage_write.py:105",
                     launches=pool_bf16["launches"]["stage_splice_rows"],
                     max_abs_err=errors["stage_splice_rows"], ms=ms, plain_ms=plain_ms,
                     bound_ms=b, bound_by=by, library_ms=lib))
    return rows


# The HTTP server (serve/server.py) on the flagship pipeline. Texts of the
# batched requests: each within the 128-position conditioning bucket of TEXT.
SERVER_TEXTS = [TEXT, "Four requests share one decode call on the card.",
                "The batch pads every text to one bucket, on the left.",
                "A fourth text joins the group before the window closes.",
                "Eight requests make a batch of sixteen CFG rows.",
                "Each row decodes its own text at its own length.",
                "The graph for this shape is captured once and kept.",
                "The last of the eight, and the batch is full."]
SERVER_MNT = 430  # the 430-frame bucket (5 s)
SERVER_COND_BUCKET = 128
# The measured requests are greedy, and codebook 0's EOS column of the
# output head is zeroed while they run: random weights otherwise end rows
# at random frames (10 under the default sampler, 19-269 greedy), where a
# trained model speaks its text. So each measured row runs the 430-frame
# budget: a fixed output length, as serving benchmarks on random weights
# fix it (ignore-EOS), here without a request option JAX's server lacks.
GREEDY = {"temperature": 0}


def _http(port: int, method: str, path: str, payload=None, timeout=600):
    """One request to the server on ``port``: (status, content type, body,
    seconds to the first body byte, seconds to the last)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    body = None if payload is None else json.dumps(payload).encode()
    conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first, t_first = resp.read1(65536), time.perf_counter() - t0
    if resp.headers.get("Transfer-Encoding") == "chunked" and len(first) <= 44:
        # A stream: the first chunk is the WAV header, the next the first PCM.
        more = resp.read1(65536)
        t_first, first = time.perf_counter() - t0, first + more
    rest = resp.read()
    t_last = time.perf_counter() - t0
    conn.close()
    return resp.status, resp.headers.get("Content-Type"), first + rest, t_first, t_last


def _wav_samples(body: bytes, streamed: bool = False):
    """PCM samples of a WAV body (a stream's header holds no sizes)."""
    import io
    import wave

    import numpy as np

    if streamed:
        if body[:4] != b"RIFF" or body[8:16] != b"WAVEfmt " or body[36:40] != b"data":
            raise AssertionError("stream: not a WAV header")
        sr = int.from_bytes(body[24:28], "little")
        if sr != 44100 or int.from_bytes(body[34:36], "little") != 16 or len(body[44:]) % 2:
            raise AssertionError(f"stream: {sr} Hz, {len(body[44:])} PCM bytes")
        return np.frombuffer(body[44:], np.int16)
    with wave.open(io.BytesIO(body)) as w:
        if w.getframerate() != 44100 or w.getnchannels() != 1 or w.getsampwidth() != 2:
            raise AssertionError("not a 44.1 kHz mono 16-bit WAV")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _require_wav(label, status, ctype, body, min_samples, streamed=False):
    if status != 200 or ctype != "audio/wav":
        raise AssertionError(f"{label}: HTTP {status} {ctype}: {body[:200]!r}")
    pcm = _wav_samples(body, streamed)
    if pcm.size < min_samples or not (pcm != 0).any():
        raise AssertionError(f"{label}: {pcm.size} samples (at least {min_samples} expected)")
    return pcm


def _post_all(port, payloads, stagger_s=0.0):
    """Post each payload from its own thread, ``stagger_s`` apart; returns
    the answers in order."""
    import threading

    out = [None] * len(payloads)

    def post(i):
        out[i] = _http(port, "POST", "/tts", payloads[i])

    threads = []
    for i in range(len(payloads)):
        t = threading.Thread(target=post, args=(i,))
        t.start()
        threads.append(t)
        time.sleep(stagger_s)
    for t in threads:
        t.join(900)
    return out


def _clean(label, srv, **want) -> dict:
    """The server's metrics, which must show no error, no replay and no
    failed pool admit, and equal ``want``."""
    m = srv.metrics.snapshot()
    bad = {k: m[k] for k in ("errors_total", "replayed_requests", "pool_admit_failures")
           if m[k] != 0}
    bad.update({k: m[k] for k, v in want.items() if m[k] != v})
    if bad:
        raise AssertionError(f"server {label}: metrics {bad} (expected 0, or {want}); {m}")
    return m


def _engine_ms_per_step(pipe, texts, speaker) -> tuple:
    """ms per decode step of the server's greedy group shape (its texts
    padded to the bucket, CFG batch 2 x len(texts), the 430-frame bucket)
    through the pipeline's engine with ``disable_eos``, so every shape runs
    its whole budget: (ms per step, steps), the capture left out."""
    import torch

    from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
    from zonos_vibes_tpu_torch.serve.server import DEFAULT_UNCONDITIONAL

    conds = [pipe.make_cond_dict(text=t, speaker=speaker,
                                 unconditional_keys=tuple(sorted(DEFAULT_UNCONDITIONAL)))
             for t in texts]
    prefix = pipe.prepare_conditioning(pipe.merge_cond_dicts(conds, pad_len=SERVER_COND_BUCKET))
    res = pipe.engine.generate(pipe.params, prefix, generator=torch.Generator("cuda").manual_seed(3),
                               sampling_params=SamplingParams.from_dict(GREEDY),
                               max_new_tokens=SERVER_MNT, disable_eos=True)
    return (res.decode_seconds - res.capture_seconds) * 1e3 / res.steps, res.steps


def run_server(pipe, card: str) -> dict:
    """Phase 3, the HTTP server on the bf16 flagship pipeline (after the
    clone + continuation run): warmup and the graph cache, batching,
    streaming, continuation, the pool under staggered arrivals and the
    surface, with the metrics clean throughout. A default-sampler request
    ends at EOS on the main path's weights; then codebook 0's EOS column
    of the head is zeroed (restored at the end) and the measured requests,
    greedy with distinct texts, each run their 430 frames; every row's
    frame count is printed beside its times. Returns the numbers and the
    launch counts of each part."""
    import numpy as np
    import torch

    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.serve.sample import wav_bytes
    from zonos_vibes_tpu_torch.serve.server import TTSServer

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    spk_path = str(out_dir / "chip_smoke.wav")  # the main path's 5 s WAV
    prefix_path = out_dir / "chip_smoke_server_prefix.wav"
    prefix_path.write_bytes(wav_bytes(prefix_signal(), PREFIX_SR))
    hop, sr = pipe.dac.hop, pipe.dac.sampling_rate
    engine = pipe.engine
    bucket = TTSServer._cond_bucket(int(pipe.make_cond_dict(text=TEXT)["espeak"].shape[1]))
    if bucket != SERVER_COND_BUCKET:
        raise AssertionError(f"TEXT's conditioning bucket {bucket} != {SERVER_COND_BUCKET}")
    stats = {"launches": {}}
    servers = []
    torch.cuda.reset_peak_memory_stats()
    head = pipe.params["heads"]["weight"]  # [codebooks, d_model, vocab]
    eos = pipe.model.config.eos_token_id
    eos_column = head[0, :, eos].clone()

    def frames(pcm) -> int:
        return pcm.size // hop

    def start(**kw):
        srv = TTSServer(pipe, host="127.0.0.1", port=0, request_timeout_s=600, **kw)
        srv.start_background()
        servers.append(srv)
        return srv, srv._httpd.server_address[1]

    try:
        # 1. Warmup, then a request in its buckets: no capture.
        srv, port = start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.warmup([(1, SERVER_COND_BUCKET, SERVER_MNT, True)])
        warm_s = time.perf_counter() - t0
        capture_ms = engine._entries[-1].runner.capture_seconds * 1e3
        captures, misses = engine.captures, engine.misses
        solo = {"text": TEXT, "speaker_audio_path": spk_path, "max_new_tokens": SERVER_MNT}
        speaker = srv._speaker_embedding(spk_path)  # cached; the worker is idle
        cond = pipe.make_cond_dict(text=TEXT, speaker=speaker)
        stats["cond_len"] = pipe.prepare_conditioning(
            pipe.merge_cond_dicts([cond], pad_len=SERVER_COND_BUCKET)).shape[1]
        # The warmed-up shape takes the default sampler (warmup's own).
        status, ctype, body, _, wall = _http(port, "POST", "/tts", solo)
        pcm = _require_wav("warm", status, ctype, body, hop)
        if (engine.captures, engine.misses) != (captures, misses):
            raise AssertionError(f"server: the warmed-up request captured "
                                 f"({engine.captures - captures} captures, "
                                 f"{engine.misses - misses} new entries)")
        warm_frames, warm_wall = frames(pcm), wall
        head[0, :, eos] = 0  # every measured row runs its budget (GREEDY)
        # The solo request: greedy, seed 7, twice (the second a cache hit).
        greedy = {**solo, "seed": 7, "sampling": GREEDY}
        twice = [_http(port, "POST", "/tts", greedy) for _ in range(2)]
        if twice[0][2] != twice[1][2]:
            raise AssertionError("server: the same greedy payload with an explicit seed gave "
                                 "different WAV bytes")
        pcm = _require_wav("solo", *twice[1][:3], hop)
        (out_dir / "chip_smoke_server.wav").write_bytes(twice[1][2])
        wall = twice[1][4]
        solo_ms, solo_steps = _engine_ms_per_step(pipe, [TEXT], speaker)
        stats.update(warmup_s=warm_s, capture_ms=capture_ms, solo_wall_ms=wall * 1e3,
                     solo_frames=frames(pcm), solo_audio_s=pcm.size / sr,
                     solo_rtf=pcm.size / sr / wall, solo_ms_per_step=solo_ms)
        log(f"server warmup ({card}): {warm_s:.3f} s for (batch 1, cond bucket "
            f"{SERVER_COND_BUCKET}, {SERVER_MNT} frames, speaker): one capture of "
            f"{capture_ms:.1f} ms; a default-sampler request in those buckets then captured "
            f"nothing ({warm_frames} frames before EOS, {warm_wall * 1e3:.1f} ms; engine captures "
            f"{engine.captures}, hits {engine.hits})")
        log(f"server solo ({card}): /tts {TEXT!r} with the main path's WAV as speaker, greedy, "
            f"seed 7, twice: identical WAV bytes ({len(twice[0][2])} B); the second (a cache hit) "
            f"{frames(pcm)} of {SERVER_MNT} frames, {pcm.size / sr:.3f} s of audio in "
            f"{wall * 1e3:.1f} ms HTTP wall, RTF {pcm.size / sr / wall:.3f}; decode at this "
            f"shape {solo_ms:.3f} ms/step ({solo_steps} steps, disable_eos)")

        # 2. Batching: 4 and then 8 concurrent compatible requests.
        bsrv, bport = start(batch_window_s=1.0)
        for n in (4, 8):
            build.reset_launches()
            before = bsrv.metrics.snapshot()["batched_requests"]
            t0 = time.perf_counter()
            # No explicit seed: one would isolate each request's group.
            answers = _post_all(bport, [{**solo, "text": t, "sampling": GREEDY}
                                        for t in SERVER_TEXTS[:n]])
            wall = time.perf_counter() - t0
            stats["launches"][f"batch{n}"] = dict(build.LAUNCHES)
            for i, (status, ctype, body, _, _) in enumerate(answers):
                _require_wav(f"batch {n} row {i}", status, ctype, body, hop)
                if n == 4:
                    (out_dir / f"chip_smoke_server_batch_row{i}.wav").write_bytes(body)
            batched = bsrv.metrics.snapshot()["batched_requests"] - before
            if batched != n - 1:
                raise AssertionError(f"server batch {n}: {batched} requests batched, not {n - 1}")
            ms, steps = _engine_ms_per_step(pipe, SERVER_TEXTS[:n], speaker)
            row_frames = [frames(_wav_samples(a[2])) for a in answers]
            audio = sum(row_frames) * hop / sr
            stats[f"batch{n}"] = dict(ms_per_step=ms, wall_s=wall, audio_s=audio,
                                      audio_per_s=audio / wall, frames=row_frames)
            log(f"server batch {n} ({card}): {n} concurrent greedy requests, {batched} batched "
                f"into one decode of CFG batch {2 * n}; at this shape {ms:.3f} ms/step ({steps} "
                f"steps, disable_eos) against {solo_ms:.3f} at CFG batch 2; frames per row "
                f"{row_frames}: {audio:.2f} s of audio in {wall:.3f} s wall "
                f"({audio / wall:.3f} audio-s/s); launches {stats['launches'][f'batch{n}']}")
        _clean("batching", bsrv)

        # 3. Streaming: time to the first PCM chunk.
        status, ctype, body, first, wall = _http(port, "POST", "/tts",
                                                 {**greedy, "stream": True})
        pcm = _require_wav("stream", status, ctype, body, hop, streamed=True)
        (out_dir / "chip_smoke_server_stream.wav").write_bytes(
            wav_bytes(pcm.astype(np.float32) / 32767.0, sr))
        stats.update(stream_first_ms=first * 1e3, stream_wall_ms=wall * 1e3,
                     stream_frames=frames(pcm), stream_audio_s=pcm.size / sr)
        log(f"server stream ({card}): the solo greedy payload streamed: first PCM chunk after "
            f"{first * 1e3:.1f} ms, all {frames(pcm)} frames ({pcm.size / sr:.3f} s of audio) "
            f"after {wall * 1e3:.1f} ms; the chunks form a 44.1 kHz 16-bit WAV "
            f"(build/chip_smoke_server_stream.wav)")

        # 4. Continuation from the 5 s chirp.
        status, ctype, body, _, wall = _http(port, "POST", "/tts",
                                             {**greedy, "prefix_audio_path": str(prefix_path)})
        pcm = _require_wav("continuation", status, ctype, body, PREFIX_FRAMES * hop)
        (out_dir / "chip_smoke_server_continue.wav").write_bytes(body)
        stats.update(continuation_wall_ms=wall * 1e3, continuation_audio_s=pcm.size / sr)
        log(f"server continuation ({card}): prefix {prefix_path.name} ({PREFIX_FRAMES} frames), "
            f"{pcm.size / sr:.3f} s of audio (prefix and continuation) in {wall * 1e3:.1f} ms")
        stats["solo_metrics"] = _clean("solo", srv)

        # 5. The pool, 8 slots: 8 requests 0.5 s apart, 4 of them streaming.
        psrv, pport = start(pooled=True, pool_slots=POOL_SLOTS)
        build.reset_launches()
        payloads = [{"text": t, "speaker_audio_path": spk_path, "max_new_tokens": SERVER_MNT,
                     "sampling": GREEDY, "seed": 100 + i, "stream": i % 2 == 1}
                    for i, t in enumerate(POOL_TEXTS)]
        t0 = time.perf_counter()
        answers = _post_all(pport, payloads, stagger_s=0.5)
        wall = time.perf_counter() - t0
        stats["launches"]["pool8"] = dict(build.LAUNCHES)
        ttfa, row_frames = [], []
        for i, (status, ctype, body, first, last) in enumerate(answers):
            pcm = _require_wav(f"pool row {i}", status, ctype, body, hop,
                               streamed=payloads[i]["stream"])
            ttfa.append(first if payloads[i]["stream"] else last)
            row_frames.append(frames(pcm))
        audio = sum(row_frames) * hop / sr
        _clean("pool", psrv, pooled_requests=8)
        stats["pool"] = dict(ttfa_ms=[t * 1e3 for t in ttfa], frames=row_frames, audio_s=audio,
                             wall_s=wall, audio_per_s=audio / wall)
        log(f"server pool ({card}): 8 slots, 8 greedy requests 0.5 s apart (rows 1/3/5/7 "
            f"streaming), pooled_requests 8, pool_admit_failures 0; time to first audio per "
            f"request {', '.join(f'{t * 1e3:.1f}' for t in ttfa)} ms (streams: first PCM "
            f"chunk; the others: the whole WAV); frames per row {row_frames}: {audio:.2f} s of "
            f"audio in {wall:.3f} s wall: {audio / wall:.3f} audio-s/s; launches "
            f"{stats['launches']['pool8']}")
        psrv.shutdown()
        servers.remove(psrv)
        del psrv
        torch.cuda.empty_cache()

        # 6. The surface, on a pooled server at its default 4 slots.
        ssrv, sport = start(pooled=True)
        for path in ("/healthz", "/metrics", "/"):
            status = _http(sport, "GET", path)[0]
            if status != 200:
                raise AssertionError(f"server GET {path}: HTTP {status}")
        for payload, want in (({"text": ""}, 400),
                              ({"text": "x", "speaker_audio_path": "/no/such/file.wav"}, 404)):
            status = _http(sport, "POST", "/tts", payload)[0]
            if status != want:
                raise AssertionError(f"server {payload}: HTTP {status}, not {want}")
        build.reset_launches()
        for status, ctype, body, _, _ in _post_all(sport, [{**solo, "text": t}
                                                           for t in SERVER_TEXTS[:2]], 0.5):
            _require_wav("pool4", status, ctype, body, hop)
        stats["launches"]["pool4"] = dict(build.LAUNCHES)
        _clean("surface", ssrv, pooled_requests=2)
        log(f"server surface ({card}): /healthz, /metrics, / 200; empty text 400; a missing "
            f"speaker path 404; 2 requests through the 4-slot pool, launches "
            f"{stats['launches']['pool4']}")
        stats.update(entries=len(engine._entries), resident_bytes=engine.resident_bytes,
                     peak_bytes=torch.cuda.max_memory_allocated())
        log(f"server memory ({card}): the engine's graph cache holds {len(engine._entries)} "
            f"entries, resident_bytes {engine.resident_bytes} (bound {engine.cache_bytes}); "
            f"device memory peak over the server phase {stats['peak_bytes']} B allocated "
            f"(torch.cuda.max_memory_allocated), of {torch.cuda.get_device_properties(0).total_memory} B")
    finally:
        for s in servers:
            s.shutdown()
        head[0, :, eos] = eos_column
    for name in ("solo_frames", "stream_frames"):
        if stats[name] != SERVER_MNT:
            raise AssertionError(f"server: {name} {stats[name]}, not the {SERVER_MNT}-frame budget")
    for run in ("batch4", "batch8", "pool"):
        if stats[run]["frames"] != [SERVER_MNT] * len(stats[run]["frames"]):
            raise AssertionError(f"server {run}: frames {stats[run]['frames']}, not "
                                 f"{SERVER_MNT} each")
    return stats


def run_server_int8(pipe, card: str) -> dict:
    """Phase 3, the server on the int8 pipeline (after the int8 path): a
    pooled server with an int8 KV pool (4 slots) serves 2 requests, and 2
    requests whose repetition window exceeds the pool's take the job path
    as one batch (``qmm_int8`` at M = 4)."""
    from zonos_vibes_tpu_torch.ops.cuda import build
    from zonos_vibes_tpu_torch.serve.server import TTSServer

    spk_path = str(ROOT / "build" / "chip_smoke.wav")
    hop = pipe.dac.hop
    srv = TTSServer(pipe, host="127.0.0.1", port=0, request_timeout_s=600, pooled=True,
                    pool_kv_int8=True, batch_window_s=1.0)
    srv.start_background()
    port = srv._httpd.server_address[1]
    stats = {"launches": {}}
    try:
        base = {"speaker_audio_path": spk_path, "max_new_tokens": SERVER_MNT}
        build.reset_launches()
        for status, ctype, body, _, _ in _post_all(port, [{**base, "text": t}
                                                          for t in SERVER_TEXTS[:2]], 0.5):
            _require_wav("int8 pool", status, ctype, body, hop)
        stats["launches"]["pool4_int8"] = dict(build.LAUNCHES)
        build.reset_launches()
        job = {**base, "sampling": {"linear": 0.5, "conf": 0.4, "repetition_penalty_window": 9}}
        for status, ctype, body, _, _ in _post_all(port, [{**job, "text": t}
                                                          for t in SERVER_TEXTS[2:4]]):
            _require_wav("int8 job", status, ctype, body, hop)
        stats["launches"]["batch2_int8"] = dict(build.LAUNCHES)
        m = _clean("int8", srv, pooled_requests=2, batched_requests=1)
        if not srv._pool_jobs["default"].kv_int8:
            raise AssertionError("int8 server: the pool's KV is not int8")
    finally:
        srv.shutdown()
    log(f"server int8 ({card}): int8 weights, int8 KV pool at 4 slots: 2 pooled requests, "
        f"launches {stats['launches']['pool4_int8']}; 2 job-path requests (repetition window 9 "
        f"> the pool's 8) in one batch of CFG batch 4, launches "
        f"{stats['launches']['batch2_int8']}; metrics {m}")
    return stats

def server_decode_step(cond_len: int, steps: int) -> tuple[int, int, int]:
    """(T, flushed_end, stage_len) of a server request's last decode step
    (the 430-frame bucket, no audio prefix)."""
    from zonos_vibes_tpu_torch.engine.generate import _find_multiple

    T = cond_len + SERVER_MNT + 9
    T = _find_multiple(T, 512 if T >= 1024 else 8)
    base = cond_len + 1
    last_pos = cond_len + steps
    fe = base + ((last_pos - base) // STAGE) * STAGE
    return T, fe, last_pos - fe


SERVER_POOL_BASES = [0, 1, 255, 256, 500, 1800, 3000, 3456]
SERVER_POOL_LENS = [0, 1, 5, 127, 127, 0, 5, 1]


def check_server_kernels() -> dict:
    """Phase 2, the kernels at the shapes the server gives them: row 1 at
    CFG batch 8 and 16 (4 and 8 batched requests), row 3 at batch 8 over a
    conditioning left-padded to its bucket, ``qmm_int8`` at M = 4 and 8
    (the int8 job path's batch of 2, the 4-slot pool's step), rows 6 and 8
    at the 4-slot pool's 8 rows over its 3584-position cache."""
    import torch

    from zonos_vibes_tpu_torch.ops import quant
    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain,
        decode_attention_pooled_staged, decode_attention_pooled_staged_plain,
        decode_attention_pooled_staged_q, decode_attention_pooled_staged_q_plain)
    from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8, qmm_int8_plain

    gen = torch.Generator(device="cuda").manual_seed(13)
    err = {}
    for Bx in (8, 16):
        x = decode_inputs(gen, 1024, Bx)
        worst = 0.0
        for fe in (0, 1, 131, 512, 896):
            for sl in (0, 5, 127):
                for layer in (0, 25):
                    sc = torch.tensor([fe, sl, layer], dtype=torch.int32, device="cuda")
                    got = decode_attention_layered(**x, scalars=sc).float()
                    want = decode_attention_layered_plain(**x, scalars=sc).float()
                    e = (got - want).abs().max().item()
                    if not torch.isfinite(got).all() or e > TOL:
                        raise AssertionError(f"decode_attention B={Bx} fe={fe} sl={sl} "
                                             f"l={layer}: err {e}")
                    worst = max(worst, e)
        err[f"decode_attention_b{Bx}"] = worst
        log(f"kernel decode_attention B={Bx}: 30 cases (flushed_end 0/1/131/512/896, stage_len "
            f"0/5/127, layer 0/25, T=1024) max_abs_err {worst:.3e} <= {TOL}")
        del x

    worst = 0.0
    for S in (SERVER_COND_BUCKET + 4, SERVER_COND_BUCKET + 1, 65, 33):
        worst = max(worst, check_prefill_case(gen, 8, S, 0, 576, HQ, HKV, D))
    err["prefill_attention_b8"] = worst
    log(f"kernel prefill_attention B=8: S {SERVER_COND_BUCKET + 4}/{SERVER_COND_BUCKET + 1}/65/33 "
        f"at offset 0, T=576, NaN in every cache row at or past S: max_abs_err {worst:.3e} <= {TOL}")

    shapes = [(name, 1, k, n, torch.bfloat16) for name, (k, n) in PROJECTIONS.items()]
    shapes.append(("heads", *HEADS_SHAPE, torch.float32))
    for M in (4, 8):
        worst = 0.0
        for name, G, K, N, out_dtype in shapes:
            wq = quant.quantize_weight(randn(gen, G, K, N) / K ** 0.5)
            rtol, atol = QMM_TOL["fp32" if out_dtype == torch.float32 else "bf16"]
            x = randn(gen, M, K)
            got = qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype)
            want = qmm_int8_plain(x, wq["weight_int8"], wq["scale"], out_dtype)
            diff = (got.float() - want.float()).abs()
            if (got.shape != want.shape or got.dtype != out_dtype or not torch.isfinite(got).all()
                    or (diff > atol + rtol * want.float().abs()).any()):
                raise AssertionError(f"qmm_int8 {name} M={M}: max |err| {diff.max().item()}")
            worst = max(worst, diff.max().item())
        err[f"qmm_int8_m{M}"] = worst
        log(f"kernel qmm_int8 M={M}: in_proj/out_proj/fc1/fc2 and the 9 heads, max_abs_err "
            f"{worst:.3e} within |err| <= atol + rtol |y| {QMM_TOL}")

    for name, kernel, plain, tol, quantize in (
            ("decode_attention_pooled", decode_attention_pooled_staged,
             decode_attention_pooled_staged_plain, TOL, False),
            ("decode_attention_pooled_q", decode_attention_pooled_staged_q,
             decode_attention_pooled_staged_q_plain, Q_TOL, True)):
        x = pool_decode_inputs(gen, POOL_T, SERVER_POOL_BASES, SERVER_POOL_LENS)
        if quantize:
            x = quantized(x)
        worst = worst_rel = 0.0
        for layer in (0, 25):
            got = kernel(**x, layer=layer).float()
            want = plain(**x, layer=layer).float()
            e, rel = (got - want).abs().max().item(), row_rel_err(got, want)
            if not torch.isfinite(got).all() or e > tol or rel > POOL_ROW_TOL[name]:
                raise AssertionError(f"{name} 8 rows layer={layer}: err {e}, per-row {rel}")
            worst, worst_rel = max(worst, e), max(worst_rel, rel)
        err[f"{name}_r8"] = worst
        log(f"kernel {name} B=8: T={POOL_T}, bases {SERVER_POOL_BASES}, lens "
            f"{SERVER_POOL_LENS}, layers 0/25, NaN past each base: max_abs_err {worst:.3e} <= "
            f"{tol}; per row {worst_rel:.3e} <= {POOL_ROW_TOL[name]}")
        del x
    return err


def check_server_shapes(cond_len: int) -> dict:
    """Phase 2 at the shapes the server ran (after the server phase, as
    its conditioning length is known then): row 3 at CFG batch 8 and 16
    (4 and 8 batched requests), S = cond_len + 1 at offset 0 in the
    430-frame bucket's cache T, NaN past S; row 1 at CFG batch 8 and 16 in
    that cache at the first decode step's and the last step's scalars
    (flushed_end, stage_len), layers 0/25. Returns each check's max
    |error| under the keys of the kernels line."""
    import torch

    from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_layered, decode_attention_layered_plain)

    gen = torch.Generator(device="cuda").manual_seed(23)
    S = cond_len + 1
    T, fe, sl = server_decode_step(cond_len, SERVER_MNT + 8)
    err = {}
    for Bx in (8, 16):
        err[f"prefill_attention_b{Bx}"] = check_prefill_case(gen, Bx, S, 0, T, HQ, HKV, D)
        x = decode_inputs(gen, T, Bx)
        worst = 0.0
        for f, l in ((S, 0), (fe, sl)):
            for layer in (0, 25):
                sc = torch.tensor([f, l, layer], dtype=torch.int32, device="cuda")
                got = decode_attention_layered(**x, scalars=sc).float()
                want = decode_attention_layered_plain(**x, scalars=sc).float()
                e = (got - want).abs().max().item()
                if not torch.isfinite(got).all() or e > TOL:
                    raise AssertionError(f"decode_attention at the server's B={Bx} T={T} "
                                         f"flushed_end={f} stage_len={l} l={layer}: err {e}")
                worst = max(worst, e)
        err[f"decode_attention_b{Bx}"] = worst
        del x
        log(f"kernel prefill_attention at the server's batched prefill (B={Bx}, S={S}, offset 0, "
            f"T={T}, NaN past S): max_abs_err {err[f'prefill_attention_b{Bx}']:.3e} <= {TOL}; "
            f"decode_attention at its first and last steps (B={Bx}, T={T}, flushed_end/stage_len "
            f"{S}/0 and {fe}/{sl}, layers 0/25): {worst:.3e} <= {TOL}")
    torch.cuda.empty_cache()
    return err


def _launched(stats: dict, run: str, name: str) -> int:
    n = stats["launches"][run].get(name, 0)
    if n <= 0:
        raise AssertionError(f"server {run}: {name} was not launched")
    return n


def time_server_kernels(srv: dict, srv_int8: dict, errors: dict, card: str) -> list[dict]:
    """Phase 4, the kernels at the server's shapes: rows 1 and 3 at the
    batched requests' (CFG batch 8 and 16) last step and prefill, ``qmm_int8``'s 105 launches at
    M = 4 and 8 summed, rows 6 and 8 at the 4-slot pool's 8 rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(17)
    cond_len = srv["cond_len"]
    T, fe, sl = server_decode_step(cond_len, SERVER_MNT + 8)
    rows = []
    decode = dict(route="cuda", source="zonos_vibes_tpu_torch/csrc/decode_attention.cu")
    for Bx, run in ((8, "batch4"), (16, "batch8")):
        ms, plain, lib, b, by, held = time_decode(gen, T, fe, sl, "server batch last step", card,
                                                  Bx=Bx)
        require_stage_write("decode_attention", held)
        rows.append(dict(name=f"decode_attention_b{Bx}",
                         replaces="zonos_vibes_tpu/ops/pallas/decode_attention.py:253",
                         launches=_launched(srv, run, "decode_attention"),
                         max_abs_err=errors[f"decode_attention_b{Bx}"], ms=ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, library_ms=lib, **decode))
        torch.cuda.empty_cache()
    for Bx, run in ((8, "batch4"), (16, "batch8")):
        ms, plain, lib, b, by = time_prefill(gen, HQ, HKV, D, cond_len + 1, T, card, long=(),
                                             Bx=Bx)[cond_len + 1, 0]
        rows.append(dict(name=f"prefill_attention_b{Bx}", route="cuda",
                         source="zonos_vibes_tpu_torch/csrc/prefill_attention.cu",
                         replaces="zonos_vibes_tpu/ops/pallas/prefill_attention.py:111",
                         launches=_launched(srv, run, "prefill_attention"),
                         max_abs_err=errors[f"prefill_attention_b{Bx}"], ms=ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, library_ms=lib))
    step, _ = time_qmm_steps(gen, card, Ms=(4, 8))
    for M, run in ((4, "batch2_int8"), (8, "pool4_int8")):
        t = step[M]
        rows.append(dict(name=f"qmm_int8_m{M}_step", route="cuda",
                         source="zonos_vibes_tpu_torch/csrc/qmm_int8.cu",
                         replaces="zonos_vibes_tpu/ops/pallas/qmm.py:46",
                         launches=_launched(srv_int8, run, "qmm_int8"),
                         max_abs_err=errors[f"qmm_int8_m{M}"], ms=t["ms"], plain_ms=t["plain"],
                         bound_ms=t["bound"], bound_by="bytes", library_ms=t["lib"]))
    lens = [(23 * b) % STAGE for b in range(8)]
    bases = [cond_len + 200 + 37 * b for b in range(8)]
    for name, quant, line, stats, run in (
            ("decode_attention_pooled", False, 790, srv, "pool4"),
            ("decode_attention_pooled_q", True, 1011, srv_int8, "pool4_int8")):
        ms, plain, lib, b, by, held = time_pooled(gen, quant, "server 4-slot pool", bases, lens,
                                                  card)
        require_stage_write(name, held)
        rows.append(dict(name=f"{name}_r8",
                         replaces=f"zonos_vibes_tpu/ops/pallas/decode_attention.py:{line}",
                         launches=_launched(stats, run, name), max_abs_err=errors[f"{name}_r8"],
                         ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                         **decode))
        torch.cuda.empty_cache()
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
    errors.update(check_pool_kernels())
    errors.update(check_server_kernels())
    check_decode_one_launch()
    write_errors = check_stage_write()
    check_step_kernels_one_launch()
    check_backbone_against_cpu()
    check_backbone_against_cpu(int8=True)
    check_pooled_backbone_against_cpu()
    check_pooled_backbone_against_cpu(int8=True)
    check_pooled_backbone_against_cpu(ring=False)
    pipe, cond, e2e = run_main_path(card)
    errors.update(check_hybrid_kernels(_solo_cache_len(e2e["cond_len"])))
    check_hybrid_backbone_against_cpu()
    cont = run_continuation(pipe, e2e["wav"], card)
    errors.update(cont["errors"])
    server = run_server(pipe, card)
    for name, e in check_server_shapes(server["cond_len"]).items():
        errors[name] = max(errors.get(name, 0.0), e)
    pool_bf16 = run_pool(pipe, card, kv_int8=False)
    e2e_int8 = run_int8_path(pipe, cond, card)
    server_int8 = run_server_int8(pipe, card)
    pool_int8 = run_pool(pipe, card, kv_int8=True)
    del pipe
    torch.cuda.empty_cache()
    pipe, hybrid = run_hybrid_path(card)
    pool_hybrid = run_pool(pipe, card, kv_int8=False, hybrid=True)
    stage_less = run_stage_less(pipe, pool_hybrid, card)
    del pipe
    torch.cuda.empty_cache()
    for name, e in write_errors.items():  # each decode row's error, with and without the write
        errors[name] = max(errors[name], e)
    rows = (time_kernels(e2e, errors, card) + time_continuation_kernels(cont, errors, card)
            + time_int8_kernels(e2e_int8, pool_int8, errors, card)
            + time_pool_kernels(pool_bf16, pool_int8, errors, card)
            + time_hybrid_kernels(hybrid, pool_hybrid, stage_less, errors, card)
            + time_server_kernels(server, server_int8, errors, card))
    summary = {name: {k: v for k, v in run["graphs"].items() if k != "step_launches"}
               for name, run in (("bf16", e2e), ("continuation", cont), ("int8", e2e_int8),
                                 ("hybrid", hybrid),
                                 ("pool_bf16", pool_bf16), ("pool_int8", pool_int8),
                                 ("pool_hybrid", pool_hybrid))}
    log(json.dumps({"graphs": summary, "stream": e2e["stream"], "card": card}))
    log(json.dumps({"server": {k: v for k, v in server.items() if k not in ("launches",
                                                                            "solo_metrics")},
                    "card": card}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
