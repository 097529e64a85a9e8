"""Decode engine (the JAX package's ``engine/generate.py``): prefill, then
the single-token decode loop with the 9 heads, the CFG mix, sampling and
the EOS cascade.

The loop stops on exactly the step where JAX's ``while_loop`` stops: it runs
while ``max(remaining) > 0``, and ``remaining`` clamps to 9 when codebook 0
emits EOS. That test reads one value from the device per step. The
transformer's KV stage flushes into the cache only when it is exactly full,
so flushes sit at the same absolute positions as in JAX. The hybrid's cache
has no stage: each step writes its columns into the cache directly, and the
loop never flushes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..models.backbone import flush_kv_stage
from ..models.zonos import ZonosModel
from ..ops.attention import NEG_INF
from ..ops.delay_pattern import apply_delay_pattern, revert_delay_pattern
from ..ops.sampling import SamplingParams, sample_from_logits, sample_from_logits_dyn

UNKNOWN_TOKEN = -1


def _find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


def _masked_scatter_frame(frame: torch.Tensor, next_token: torch.Tensor) -> torch.Tensor:
    """Fill the UNKNOWN slots of ``frame [B, K]`` from ``next_token [B, K]``
    in flattened order, as ``masked_scatter_`` does (not elementwise: in the
    last K-1 delayed columns codebook k's prediction lands in slot k+1)."""
    unknown = frame == UNKNOWN_TOKEN
    src_idx = torch.cumsum(unknown.long(), dim=1) - unknown.long()
    return torch.where(unknown, torch.gather(next_token, 1, src_idx), frame)


@dataclass
class GenerateResult:
    codes: torch.Tensor  # [B, K, audio_seq_len] int64, invalid tail zero-filled
    valid_length: int  # max valid frames over the batch
    valid_lengths: torch.Tensor  # [B] per-row frame counts
    steps: int = 0  # decode steps run after the prefill
    prefill_seconds: float = 0.0  # host clock, the device synchronised
    decode_seconds: float = 0.0


@dataclass
class DecodeState:
    delayed: torch.Tensor  # [B, K, audio_seq_len + K]
    cache: dict
    offset: int  # delayed column written last
    remaining: torch.Tensor  # [B]
    stopping: torch.Tensor  # [B] bool
    stop_offset: torch.Tensor  # [B]; -1 while the row runs
    stage_base: int | None  # flushed-prefix length (absolute position); None: no stage
    rope: torch.Tensor | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prefill_state(model: ZonosModel, params: dict, prefix_conditioning: torch.Tensor,
                   audio_prefix_codes: torch.Tensor, generator: torch.Generator,
                   max_new_tokens: int, cfg_scale: float, sampling: SamplingParams | None,
                   disable_eos: bool, kv_int8: bool, knobs: dict | None = None,
                   state_bf16: bool = False) -> DecodeState:
    """Cache, delay pattern, prefill, and the first frame. As in JAX the
    first frame is sampled without the EOS bias unless ``disable_eos``.

    ``knobs`` (pool joins, ``ops/sampling.knobs_from_params``) replace
    ``cfg_scale`` and ``sampling``: the CFG mix takes the knob's scale per
    row and the first frame is drawn by the runtime-knob sampler, its Exp(1)
    noise from ``generator``."""
    cfg = model.config
    K = cfg.num_codebooks
    two_b, cond_len, _ = prefix_conditioning.shape
    batch = two_b // 2
    lp = audio_prefix_codes.shape[-1]
    audio_seq_len = lp + max_new_tokens
    seq_len = cond_len + audio_seq_len + K
    seq_len = _find_multiple(seq_len, 512 if seq_len >= 1024 else 8)
    dev = prefix_conditioning.device

    rope = model.rope_for(dev)
    cache = model.allocate_cache(two_b, seq_len, prefix_conditioning.dtype, dev, kv_int8,
                                 state_bf16)
    codes = torch.full((batch, K, audio_seq_len), UNKNOWN_TOKEN, dtype=torch.long, device=dev)
    codes[..., :lp] = audio_prefix_codes
    delayed = apply_delay_pattern(codes, cfg.masked_token_id)

    emb = model.embed_codes(params, delayed[..., : lp + 1])
    emb = torch.cat([emb, emb], dim=0)  # CFG doubling
    hidden = torch.cat([prefix_conditioning.to(emb.dtype), emb], dim=1)
    if knobs is not None:
        cfg_scale = knobs["cfg_scale"].reshape(1).expand(batch)
    logits = model.compute_logits(params, hidden, cache, 0, cfg_scale, rope)
    if disable_eos:
        logits[:, :, cfg.eos_token_id] = NEG_INF
    if knobs is not None:
        noise = torch.empty_like(logits).exponential_(generator=generator)
        next_token = sample_from_logits_dyn(logits, knobs, noise)
    else:
        next_token = sample_from_logits(generator, logits, sampling)

    offset0 = lp + 1
    delayed[..., offset0] = _masked_scatter_frame(delayed[..., offset0], next_token)
    max_steps = delayed.shape[-1] - offset0
    return DecodeState(
        delayed=delayed, cache=cache, offset=offset0,
        remaining=torch.full((batch,), max_steps, dtype=torch.long, device=dev),
        stopping=torch.zeros((batch,), dtype=torch.bool, device=dev),
        stop_offset=torch.full((batch,), -1, dtype=torch.long, device=dev),
        # Only a staged cache has a flushed prefix, ending at the prefill.
        stage_base=cond_len + lp + 1 if "k_stage" in cache else None, rope=rope,
    )


def _decode_step(model, params, s: DecodeState, cond_len, cfg_scale, sampling, logit_bias,
                 generator) -> None:
    cfg = model.config
    K, eos, mask_tok = cfg.num_codebooks, cfg.eos_token_id, cfg.masked_token_id
    delayed = s.delayed
    ncol = delayed.shape[-1]
    offset = s.offset + 1
    emb = model.embed_codes(params, delayed[..., offset - 1: offset])
    emb = torch.cat([emb, emb], dim=0)
    logits = model.compute_logits(params, emb, s.cache, offset - 1 + cond_len, cfg_scale,
                                  s.rope, stage_base=s.stage_base)
    logits = logits + logit_bias

    # Window of the last w delayed frames; the start clamps into range as
    # JAX's dynamic_slice does.
    w = min(sampling.repetition_penalty_window, ncol)
    start = min(max(offset - w, 0), ncol - w)
    next_token = sample_from_logits(generator, logits, sampling, delayed[..., start: start + w])

    # EOS cascade (vector math; codebook idx = 9 - remaining emits EOS).
    eos_in_cb0 = next_token[:, 0] == eos
    remaining = torch.where(eos_in_cb0, s.remaining.clamp(max=9), s.remaining)
    s.stop_offset = torch.where(eos_in_cb0 & ~s.stopping, offset, s.stop_offset)
    s.stopping = s.stopping | eos_in_cb0
    eos_idx = (9 - remaining).clamp(0, K - 1)[:, None]
    cb = torch.arange(K, device=delayed.device)[None, :]
    cascade = torch.where(cb < eos_idx, mask_tok, torch.where(cb == eos_idx, eos, next_token))
    next_token = torch.where(s.stopping[:, None], cascade, next_token)

    # The column index clamps into range as JAX's dynamic update does (the
    # last step rewrites the already full last column, a no-op).
    col = min(offset, ncol - 1)
    delayed[..., col] = _masked_scatter_frame(delayed[..., col], next_token)
    s.remaining = remaining - 1
    s.offset = offset


def _decode_loop(model: ZonosModel, params: dict, s: DecodeState, cond_len: int,
                 cfg_scale: float, sampling: SamplingParams, disable_eos: bool,
                 generator: torch.Generator) -> int:
    """Steps until every row is done; returns the number of steps."""
    cfg = model.config
    batch = s.delayed.shape[0]
    logit_bias = torch.zeros((batch, cfg.num_codebooks, model.head_out_dim),
                             dtype=torch.float32, device=s.delayed.device)
    # EOS only from codebook 0; disable_eos forbids it everywhere.
    logit_bias[:, 0 if disable_eos else 1:, cfg.eos_token_id] = NEG_INF
    staged = s.stage_base is not None
    stage_depth = s.cache["k_stage"].shape[2] if staged else 0
    steps = 0
    while int(s.remaining.max()) > 0:
        _decode_step(model, params, s, cond_len, cfg_scale, sampling, logit_bias, generator)
        steps += 1
        if staged and s.offset + cond_len - s.stage_base == stage_depth:
            flush_kv_stage(s.cache, s.stage_base)
            s.stage_base += stage_depth
    return steps


def _finalize(model: ZonosModel, s: DecodeState):
    """Delay-pattern revert and per-row trimming."""
    cfg = model.config
    out = revert_delay_pattern(s.delayed)
    out = torch.where(out >= cfg.codebook_size, 0, out)
    valid_length = max(s.offset - cfg.num_codebooks, 0)
    # cb0's EOS at delayed column o means o - 1 valid frames for that row.
    valid_lengths = torch.where(s.stop_offset >= 0, (s.stop_offset - 1).clamp(min=0),
                                valid_length).clamp(max=valid_length)
    t = torch.arange(out.shape[-1], device=out.device)[None, None, :]
    return torch.where(t < valid_lengths[:, None, None], out, 0), valid_length, valid_lengths


class DecodeEngine:
    """User-facing generate API over a :class:`ZonosModel`.

    ``kv_int8`` (transformer) stores the flushed KV prefix as int8 with
    per-(position, kv head) scales (half the cache bytes); the stage and the
    current token stay exact. Paired with ``ops/quant.quantize_zonos_params``
    weights it is the int8 serving configuration. ``state_bf16`` (hybrid)
    stores the SSM state in bf16; the recurrence still computes in fp32."""

    def __init__(self, model: ZonosModel, kv_int8: bool = False, state_bf16: bool = False):
        self.model = model
        self.kv_int8 = kv_int8
        self.state_bf16 = state_bf16

    def generate(self, params: dict, prefix_conditioning: torch.Tensor,
                 audio_prefix_codes: torch.Tensor | None = None, *,
                 generator: torch.Generator | None = None, max_new_tokens: int = 86 * 30,
                 cfg_scale: float = 2.0, sampling_params: SamplingParams | dict | None = None,
                 disable_eos: bool = False) -> GenerateResult:
        if cfg_scale == 1.0:
            raise NotImplementedError("cfg_scale == 1 is not supported (as in the reference)")
        if sampling_params is None:
            sampling_params = SamplingParams(min_p=0.1)
        elif isinstance(sampling_params, dict):
            sampling_params = SamplingParams.from_dict(sampling_params)
        dev = prefix_conditioning.device
        K = self.model.config.num_codebooks
        if audio_prefix_codes is None:
            audio_prefix_codes = torch.zeros((prefix_conditioning.shape[0] // 2, K, 0),
                                             dtype=torch.long, device=dev)
        cond_len = prefix_conditioning.shape[1]
        with torch.inference_mode():
            t0 = time.perf_counter()
            state = _prefill_state(self.model, params, prefix_conditioning, audio_prefix_codes,
                                   generator, max_new_tokens, cfg_scale, sampling_params,
                                   disable_eos, self.kv_int8, state_bf16=self.state_bf16)
            _sync(dev)
            t1 = time.perf_counter()
            steps = _decode_loop(self.model, params, state, cond_len, cfg_scale,
                                 sampling_params, disable_eos, generator)
            _sync(dev)
            t2 = time.perf_counter()
            codes, valid, valid_rows = _finalize(self.model, state)
        return GenerateResult(codes=codes, valid_length=valid, valid_lengths=valid_rows,
                              steps=steps, prefill_seconds=t1 - t0, decode_seconds=t2 - t1)
