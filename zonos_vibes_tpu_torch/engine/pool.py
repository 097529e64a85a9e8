"""Continuous-batching decode pool (the JAX package's ``engine/pool.py``) for
the transformer and the hybrid backbone.

A fixed number of slots, each one request: cond row ``s`` and its CFG row
``slots + s`` of one batch. Every pooled step advances all rows at once, so
the weights are read once per step for every request in the pool, whatever
their arrival times. Rows sit at their own positions; positions, ring
lengths, knobs and counters are device tensors, so joining, stepping and
releasing need no per-slot code path and no host value per row.

Row lifecycle:

* :func:`prefill_request` prefills the request alone (CFG batch 2, its own
  cache) and samples its first frame with its runtime knobs;
* :func:`join` copies its cache rows (and int8 scales), delayed codes and
  counters into a free slot and resets the slot's ring watermark
  (``flush_base``) to its position;
* :func:`pool_steps` runs up to ``n_steps`` pooled steps (fewer once no row
  is running), each row's fresh K/V columns landing in its ring slot
  ``pos - flush_base``, then :func:`flush_pool_rings` copies every row's
  ring window into the cache and advances the watermarks. On the card a
  pooled step is captured once as a CUDA graph per sampler variant and
  replayed (``engine/graphs.py``), as JAX compiles one program per
  ``sorted_sampler``; the host reads the rows' state only when the steps
  the last read guarantees are spent (``engine/generate._refill``);
* :func:`extract_row` returns a finished row's codes and
  :func:`release_row` frees its slot.

A row's draws depend only on ``(base_seed, row_seed, row step)``
(``ops/sampling.pool_noise``), so its codes never depend on its neighbours;
greedy rows equal the solo engine's codes.

The hybrid pool keeps the same design: its attention layers' cache is the
transformer's flat ``[L_attn, 2S, T, W]`` layout with per-row rings, and its
Mamba conv and SSM states (``[M, 2S, ...]``) are per-row recurrent state
with no position, so a join copies them with the KV rows and nothing else
changes. ``state_bf16`` (hybrid only) stores the SSM state in bf16.

Pool state is a dict of tensors on one device, updated in place: every
tensor keeps its storage for the pool's lifetime, so the graphs captured
over them stay valid across joins, segments and flushes. Beside the
tensors it holds the captured steps (``"graphs"``) and the count of the
stop test's device reads (``"host_reads"``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..models.backbone import KV_STAGE
from ..models.zonos import ZonosModel
from ..ops.attention import NEG_INF
from ..ops.delay_pattern import revert_delay_pattern
from ..ops.quant import quantize_rows
from ..ops.sampling import (
    SamplingParams,
    knobs_from_params,
    pool_noise,
    sample_from_logits_dyn,
)
from ..utils.device import resolve_device
from .generate import (
    EOS_CASCADE,
    DecodeState,
    _find_multiple,
    _masked_scatter_frame,
    _prefill_state,
)
from .graphs import StepGraph

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class PoolConfig:
    slots: int = 4
    max_cond_len: int = 512
    max_new_tokens: int = 86 * 30  # per-request ceiling (30 s)
    # Width of the repetition-penalty window buffer; a row's own window
    # (any value up to this) masks the older columns out of the counts.
    max_rep_window: int = 8


def _pool_cache_len(model: ZonosModel, pc: PoolConfig) -> int:
    # +KV_STAGE margin: a ring flush writes a full stage window at each
    # row's watermark, which must never reach past the cache end.
    seq = pc.max_cond_len + pc.max_new_tokens + model.config.num_codebooks + KV_STAGE
    return _find_multiple(seq, 512 if seq >= 1024 else 8)


@torch.inference_mode()
def make_pool(model: ZonosModel, pc: PoolConfig, dtype=torch.bfloat16, kv_int8: bool = False,
              state_bf16: bool = False, device=None, cuda_graphs: bool | None = None) -> dict:
    """All-slots-free pool state on ``device`` (CUDA unless the caller asks
    for the CPU). The cache holds ``2 * slots`` rows of
    ``_pool_cache_len`` positions; its stage is the rows' rings. With
    ``kv_int8`` (transformer) the flushed prefixes are int8 with
    per-(position, kv head) scales; rings and current columns stay exact.
    ``state_bf16`` (hybrid) stores the SSM state in bf16. ``cuda_graphs``
    (default: on for a CUDA device) replays captured pooled steps;
    ``False`` runs them eagerly, for comparisons; ``True`` on the CPU
    raises."""
    dev = resolve_device(device)
    graphs = dev.type == "cuda" if cuda_graphs is None else cuda_graphs
    if graphs and dev.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, got {dev}")
    cfg = model.config
    K, S = cfg.num_codebooks, pc.slots
    cache = model.allocate_cache(2 * S, _pool_cache_len(model, pc), dtype, dev, kv_int8,
                                 state_bf16, pool_ring=True)
    knobs = {name: v.expand(S).clone()
             for name, v in knobs_from_params(SamplingParams(), 2.0, dev).items()}

    def zeros():
        return torch.zeros((S,), dtype=torch.long, device=dev)

    return {
        "cache": cache,
        "delayed": torch.zeros((S, K, pc.max_new_tokens + K), dtype=torch.long, device=dev),
        "pos": zeros(),  # absolute cache position of the row's next token
        "step": zeros(),  # next delayed column to write
        "active": torch.zeros((S,), dtype=torch.bool, device=dev),
        "remaining": zeros(),
        "stopping": torch.zeros((S,), dtype=torch.bool, device=dev),
        "stop_offset": torch.full((S,), -1, dtype=torch.long, device=dev),
        "row_seed": zeros(),  # uint32 values
        "flush_base": zeros(),  # ring watermark: the ring holds [flush_base, pos)
        "knobs": knobs,
        # Columns of the repetition window relative to ``step`` (static width).
        "window": torch.arange(-pc.max_rep_window, 0, device=dev),
        "rope": model.rope_for(dev),
        "cuda_graphs": graphs,
        "graphs": {},  # (needs_sort, base_seed, id(params)) -> StepGraph
        "host_reads": 0,
    }


def prefill_request(model: ZonosModel, params: dict, prefix_conditioning: torch.Tensor,
                    generator: torch.Generator, max_new_tokens: int, cfg_scale: float,
                    sampling: SamplingParams, kv_int8: bool = False, state_bf16: bool = False,
                    audio_prefix_codes: torch.Tensor | None = None) -> tuple[DecodeState, dict]:
    """Solo prefill of a joining request; returns ``(request state, knobs)``
    for :func:`join`. ``prefix_conditioning`` is ``[2, Lc, D]`` (cond and
    uncond), ``audio_prefix_codes`` an optional ``[1, K, Lp]`` continuation;
    ``kv_int8`` and ``state_bf16`` must match the pool's. The first frame
    is drawn with the request's knobs, its noise from ``generator``."""
    dev = prefix_conditioning.device
    K = model.config.num_codebooks
    if audio_prefix_codes is None:
        audio_prefix_codes = torch.zeros((1, K, 0), dtype=torch.long, device=dev)
    knobs = knobs_from_params(sampling, float(cfg_scale), dev)
    with torch.inference_mode():
        state = _prefill_state(model, params, prefix_conditioning, audio_prefix_codes,
                               generator, int(max_new_tokens), 0.0, None, False, kv_int8,
                               knobs=knobs, state_bf16=state_bf16)
    return state, knobs


@torch.inference_mode()
def join(pool: dict, req_state: DecodeState, slot: int, cond_len: int, row_seed: int,
         knobs: dict | None = None) -> dict:
    """Splice a prefilled request into ``slot`` (cond row ``slot``, uncond
    row ``slots + slot``), in place; returns ``pool``. The request's cache
    rows (and scales) cover its own, shorter cache; the hybrid's conv and
    SSM states are copied whole; the ring is not copied (a fresh request
    has an empty ring) and the watermark becomes the row's position.
    ``knobs`` are the request's runtime knobs."""
    S = pool["active"].shape[0]
    if not 0 <= slot < S:
        raise ValueError(f"slot {slot} outside [0, {S})")
    cache, req = pool["cache"], req_state.cache
    timed = ("k", "v") + (("k_scale", "v_scale") if "k_scale" in cache else ())
    states = ("conv", "ssm") if "ssm" in cache else ()
    if ("k_scale" in cache) != ("k_scale" in req):
        raise ValueError("join: the request's kv_int8 differs from the pool's")
    if states and req["ssm"].dtype != cache["ssm"].dtype:
        raise ValueError("join: the request's state_bf16 differs from the pool's")
    T, STAGE = cache["k"].shape[2], cache["k_stage"].shape[2]
    width = req_state.delayed.shape[-1]
    if width > pool["delayed"].shape[-1] or cond_len + width + STAGE > T:
        raise ValueError("join: the request is longer than the pool's geometry")
    t_req = req["k"].shape[2]
    for name in timed:
        cache[name][:, slot, :t_req] = req[name][:, 0]
        cache[name][:, S + slot, :t_req] = req[name][:, 1]
    for name in states:
        cache[name][:, slot] = req[name][:, 0]
        cache[name][:, S + slot] = req[name][:, 1]
    pool["delayed"][slot, :, :width] = req_state.delayed[0]
    pos = cond_len + req_state.offset
    pool["pos"][slot] = pos
    pool["step"][slot] = req_state.offset + 1
    pool["active"][slot] = True
    pool["remaining"][slot] = req_state.remaining[0]
    pool["stopping"][slot] = req_state.stopping[0]
    pool["stop_offset"][slot] = req_state.stop_offset[0]
    pool["row_seed"][slot] = int(row_seed) & _M32
    pool["flush_base"][slot] = pos
    if knobs is not None:
        for name, value in knobs.items():
            pool["knobs"][name][slot] = value
    return pool


def _pool_body(model: ZonosModel, params: dict, pool: dict, base_seed: int,
               needs_sort: bool) -> None:
    """One pooled step over every row, in place; inactive rows are computed
    and their results masked out. It reads no host value, so a CUDA graph
    can capture it."""
    cfg = model.config
    K, eos, mask_tok = cfg.num_codebooks, cfg.eos_token_id, cfg.masked_token_id
    delayed, step = pool["delayed"], pool["step"]
    S, _, ncol = delayed.shape
    dev = delayed.device
    active = pool["active"] & (pool["remaining"] > 0)

    # A row that spent its whole budget sits at step ncol + 1 while others
    # run: its reads clamp into the buffer (JAX's gathers never fault), and
    # its results are masked out below.
    frame_in = torch.gather(delayed, 2,
                            (step - 1).clamp(0, ncol - 1)[:, None, None].expand(S, K, 1))
    emb = model.embed_codes(params, frame_in)
    emb = torch.cat([emb, emb], dim=0)  # CFG rows [cond..., uncond...]
    logits = model.compute_logits(
        params, emb, pool["cache"], 0, pool["knobs"]["cfg_scale"], pool["rope"],
        positions=torch.cat([pool["pos"], pool["pos"]]),
        pool_base=torch.cat([pool["flush_base"], pool["flush_base"]]))
    logits[:, 1:, eos] += NEG_INF  # EOS only from codebook 0

    widx = (step[:, None] + pool["window"][None, :]).clamp(0, ncol - 1)
    window = torch.gather(delayed, 2, widx[:, None, :].expand(S, K, widx.shape[1]))
    noise = pool_noise(base_seed, pool["row_seed"], step, K, logits.shape[-1])
    next_token = sample_from_logits_dyn(logits, pool["knobs"], noise, window, needs_sort)

    # EOS cascade (codebook 9 - remaining emits EOS), active rows only.
    eos_in_cb0 = (next_token[:, 0] == eos) & active
    remaining = torch.where(eos_in_cb0, pool["remaining"].clamp(max=EOS_CASCADE),
                            pool["remaining"])
    stop_offset = torch.where(eos_in_cb0 & ~pool["stopping"], step, pool["stop_offset"])
    stopping = pool["stopping"] | eos_in_cb0
    eos_idx = (EOS_CASCADE - remaining).clamp(0, K - 1)[:, None]
    cb = torch.arange(K, device=dev)[None, :]
    cascade = torch.where(cb < eos_idx, mask_tok, torch.where(cb == eos_idx, eos, next_token))
    next_token = torch.where(stopping[:, None], cascade, next_token)

    # Masked scatter into each row's column ``step``; a column past the
    # buffer (a row's last step) is not written.
    col = step.clamp(max=ncol - 1)[:, None, None].expand(S, K, 1)
    cur = torch.gather(delayed, 2, col)[..., 0]
    write = (active & (step < ncol))[:, None]
    delayed.scatter_(2, col, torch.where(write, _masked_scatter_frame(cur, next_token), cur)[..., None])

    adv = active.long()
    pool["stopping"].copy_(torch.where(active, stopping, pool["stopping"]))
    pool["stop_offset"].copy_(torch.where(active, stop_offset, pool["stop_offset"]))
    pool["remaining"].copy_(torch.where(active, remaining - 1, pool["remaining"]))
    pool["pos"] += adv
    step += adv  # pool["step"], in place


def _read_running(pool: dict) -> tuple[bool, int]:
    """The stop test's one device read: ``(some active row sets top-p or
    top-k, max remaining over the active rows)``."""
    pool["host_reads"] += 1
    knobs, active = pool["knobs"], pool["active"]
    sort = (active & ((knobs["top_p"] > 0) | (knobs["top_k"] > 0))).any()
    running = torch.where(active, pool["remaining"], 0).max()
    flag, r = torch.stack([sort.long(), running]).tolist()
    return bool(flag), r


@torch.inference_mode()
def pool_steps(model: ZonosModel, params: dict, pool: dict, base_seed: int,
               n_steps: int) -> int:
    """Advance every active row by up to ``n_steps`` pooled steps, stopping
    early on exactly the step where no row is running, then flush the
    rings; returns the number of steps run. ``n_steps`` may not exceed the
    ring depth. The host reads the rows' state once, then again only when
    the steps that read guarantees are spent (``min(R, 9)`` for ``R`` the
    largest ``remaining`` of an active row; ``engine/generate._refill``
    derives it), so a segment of ``n`` steps makes at most ``ceil(n / 9) +
    1`` reads. The sort-bearing top-p and top-k stages run only in a
    segment where some active row sets ``top_p`` or ``top_k``; rows that
    leave them at 0 draw the same either way. On the card each such variant
    (and base seed) is one graph, captured at its first segment after one
    eager step."""
    depth = pool["cache"]["k_stage"].shape[2]
    if n_steps > depth:
        raise ValueError(f"a segment of {n_steps} steps overflows the {depth}-deep ring stage")
    needs_sort, running = _read_running(pool)
    key = (needs_sort, base_seed, id(params))
    runner = pool["graphs"].get(key)
    if runner is None:
        # The step sees the pool's tensors (all updated in place) but not its
        # graphs, so the runner and the pool hold no reference cycle.
        tensors = {k: v for k, v in pool.items() if k != "graphs"}
        step = functools.partial(_pool_body, model, params, tensors, base_seed, needs_sort)
        runner = StepGraph(step, pool["delayed"].device, pool["cuda_graphs"])
        pool["graphs"][key] = runner  # the runner holds params: its id stays unique
    steps = 0
    while steps < n_steps and running > 0:
        n = min(running, EOS_CASCADE, n_steps - steps)
        runner.run(n)
        steps += n
        if steps < n_steps:
            _, running = _read_running(pool)
    flush_pool_rings(pool)
    return steps


@torch.inference_mode()
def flush_pool_rings(pool: dict) -> dict:
    """Copy every row's full ring window into the cache at ``[flush_base,
    flush_base + STAGE)`` (quantized first for an int8 cache) and advance
    the watermarks to ``pos``, in place. Ring slots past a row's position
    hold stale rows; they lie past its attention bound, and the next flush,
    whose window starts at the new watermark, overwrites them first. The
    hybrid's rings are its attention layers' ``[L_attn, 2S, STAGE, W]``
    stages: the same copy."""
    cache = pool["cache"]
    T, STAGE = cache["k"].shape[2], cache["k_stage"].shape[2]
    B2 = cache["k"].shape[1]
    base = torch.cat([pool["flush_base"], pool["flush_base"]]).clamp(0, T - STAGE)
    dev = base.device
    rows = torch.arange(B2, device=dev)[:, None]
    idx = base[:, None] + torch.arange(STAGE, device=dev)[None, :]
    for name in ("k", "v"):
        stage = cache[name + "_stage"]
        if name + "_scale" in cache:
            q, scale = quantize_rows(stage, cache[name + "_scale"].shape[-1])
            cache[name][:, rows, idx] = q
            cache[name + "_scale"][:, rows, idx] = scale
        else:
            cache[name][:, rows, idx] = stage
    pool["flush_base"].copy_(pool["pos"])
    return pool


def row_finished(pool: dict, slot: int) -> bool:
    return bool(pool["active"][slot]) and int(pool["remaining"][slot]) <= 0


def finalize_extract(model: ZonosModel, out: torch.Tensor, step: int, stop: int):
    """Trim a reverted row: ``step`` is the next write column, so the last
    written column is ``step - 1``; EOS in codebook 0 at column ``stop``
    leaves ``stop - 1`` valid frames."""
    valid = max(int(step) - 1 - model.config.num_codebooks, 0)
    if int(stop) >= 0:
        valid = min(valid, max(int(stop) - 1, 0))
    return out[:, :valid], valid


@torch.inference_mode()
def extract_row(model: ZonosModel, pool: dict, slot: int):
    """A row's codes: ``(codes [K, frames] int64 on the pool's device,
    frames)``. The caller frees the slot with :func:`release_row`."""
    out = revert_delay_pattern(pool["delayed"][slot: slot + 1])[0]
    out = torch.where(out >= model.config.codebook_size, 0, out)
    return finalize_extract(model, out, pool["step"][slot], pool["stop_offset"][slot])


@torch.inference_mode()
def release_row(pool: dict, slot: int) -> dict:
    """Mark ``slot`` free, in place; its stale cache rows are overwritten by
    the next join."""
    pool["active"][slot] = False
    return pool


def make_pool_emit(model: ZonosModel, dac_model, margin: int, vocode_win: int):
    """The per-segment streaming emit: for every pool row, the newly stable
    span ``[emitted, e)`` (``e = min(stable, emitted + emit_cap)``, ``stable``
    withholding ``margin`` frames until the row's cascade completes), vocoded
    through ``dac_model`` (a ``models/dac.DACModel``) in one fixed window of
    ``vocode_win`` frames with ``margin`` frames of context on both sides,
    returned as int16 PCM aligned to the span's first sample, with the
    counters. Returns ``emit(dac_params, pool, emitted, mnt_cap) -> dict``
    (``emitted``/``mnt_cap`` ``[S]``: frames already shipped / frame
    budget)."""
    K = model.config.num_codebooks
    hop = dac_model.config.hop_length
    emit_cap = vocode_win - 2 * margin
    if emit_cap < 8:
        raise ValueError(f"vocode_win {vocode_win} leaves fewer than 8 frames past the margins")
    cap_samples = emit_cap * hop

    @torch.inference_mode()
    def emit(dac_params: dict, pool: dict, emitted: torch.Tensor, mnt_cap: torch.Tensor) -> dict:
        step, stop = pool["step"], pool["stop_offset"]
        valid = (step - 1 - K).clamp(min=0)
        valid = torch.where(stop >= 0, torch.minimum(valid, (stop - 1).clamp(min=0)), valid)
        valid = torch.minimum(valid, mnt_cap)
        done = pool["active"] & (pool["remaining"] <= 0)
        stable = torch.where(done, valid, (valid - margin).clamp(min=0))
        e = torch.clamp(stable, emitted, emitted + emit_cap)
        c1 = torch.minimum(valid, e + margin)
        c0 = (c1 - vocode_win).clamp(min=0)

        codes = revert_delay_pattern(pool["delayed"])  # [S, K, Trev]
        codes = torch.where(codes >= model.config.codebook_size, 0, codes)
        S = codes.shape[0]
        w = torch.arange(vocode_win, device=codes.device)
        tidx = (c0[:, None, None] + w[None, None, :]).clamp(max=codes.shape[-1] - 1)
        win = torch.gather(codes, 2, tidx.expand(S, K, vocode_win))
        win = torch.where(w[None, None, :] < (c1 - c0)[:, None, None], win, 0)
        wav = dac_model.decode(dac_params, win)[:, 0, :]
        pcm = (wav.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        # Shift each row so its chunk starts at sample 0 (fixed size; the
        # host keeps take_frames * hop samples).
        pcm = torch.cat([pcm, pcm.new_zeros((S, cap_samples))], dim=1)
        sidx = ((emitted - c0) * hop)[:, None] + torch.arange(cap_samples, device=pcm.device)
        return {"active": pool["active"].clone(), "remaining": pool["remaining"].clone(),
                "valid": valid, "new_emitted": e, "pcm": torch.gather(pcm, 1, sidx)}

    return emit
