"""Decode engine (the JAX package's ``engine/generate.py``): prefill, then
the single-token decode loop with the 9 heads, the CFG mix, sampling and
the EOS cascade.

The step's state lives on the device: the delayed codes, ``offset``,
``remaining``, ``stopping``, ``stop_offset`` and, on the transformer's
staged cache, the ``[L, 3]`` ``(flushed_end, stage_len, layer)`` scalars
the decode-attention kernel reads. A step reads and writes only those
tensors (and the cache), in place, and no host value, so on the card one
step is captured as a CUDA graph and replayed (``engine/graphs.py``): the
counterpart of JAX compiling the loop. The host keeps an exact mirror of
``offset`` (every step advances it by one) and of the flushed-prefix
length.

JAX compiles the loop once per static signature (model, prefix length,
``max_new_tokens``, ``cfg_scale``, sampling, ``disable_eos``, ``kv_int8``,
``state_bf16``, and the shapes: batch and conditioning length). The engine
keeps one cache entry per such key, the parameter tree and the device
added (:class:`DecodeEngine`): the step's state tensors, its logit bias, its
own generator and the captured step, so a request with a key seen before
prefills into the entry's tensors in place and replays the graph it has,
capturing nothing.

The loop stops on exactly the step where JAX's ``while_loop`` stops: it
runs while ``max(remaining) > 0``, and ``remaining`` clamps to 9 when
codebook 0 emits EOS. The host reads ``max(remaining)`` only when the
steps that value guarantees are spent (:func:`_decode_segment`). The
transformer's KV stage flushes into the cache only when it is exactly
full, outside the graph, so flushes sit at the same absolute positions as
in JAX. The hybrid's cache has no stage: each step writes its columns into
the cache directly, and the loop never flushes.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

from ..models.backbone import flush_kv_stage
from ..models.zonos import ZonosModel
from ..ops.attention import NEG_INF
from ..ops.delay_pattern import apply_delay_pattern, revert_delay_pattern
from ..ops.sampling import SamplingParams, sample_from_logits, sample_from_logits_dyn
from .graphs import StepGraph

UNKNOWN_TOKEN = -1
# Steps from codebook 0's EOS to the last codebook's: ``remaining`` clamps
# to it on EOS, and codebook ``EOS_CASCADE - remaining`` emits EOS.
EOS_CASCADE = 9


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
    decode_seconds: float = 0.0  # the decode loop, a graph's capture included
    host_reads: int = 0  # reads of max(remaining) by the loop's stop test
    replays: int = 0  # steps run by replaying the captured step
    capture_seconds: float = 0.0
    step_launches: dict = field(default_factory=dict)  # kernel launches per replayed step


@dataclass
class DecodeState:
    delayed: torch.Tensor  # [B, K, audio_seq_len + K]
    cache: dict
    offset: int  # delayed column written last (the host's mirror of offset_t)
    remaining: torch.Tensor  # [B]
    stopping: torch.Tensor  # [B] bool
    stop_offset: torch.Tensor  # [B]; -1 while the row runs
    stage_base: int | None  # flushed-prefix length (absolute position); None: no stage
    rope: torch.Tensor | None
    offset_t: torch.Tensor | None = None  # [1] int64 on the device
    stage_scalars: torch.Tensor | None = None  # [L, 3] int32 (flushed_end, stage_len, layer)
    guaranteed: int = 0  # steps certain to run before the stop test must read again
    done: bool = False  # a read found max(remaining) <= 0
    host_reads: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_cache(cache: dict) -> None:
    """Return a cache to its freshly allocated contents, in place: int8
    scales at 1 (``models/backbone.allocate_kv_cache``), every other plane
    (K/V, stages, the hybrid's conv and SSM state) at 0. Nothing of the
    previous request survives for a later step to read."""
    for name, t in cache.items():
        t.fill_(1 if name.endswith("_scale") else 0)


def _fill_logit_bias(bias: torch.Tensor, eos: int, disable_eos: bool) -> None:
    """EOS only from codebook 0; ``disable_eos`` forbids it everywhere."""
    bias.zero_()
    bias[:, 0 if disable_eos else 1:, eos] = NEG_INF


def _prefill_state(model: ZonosModel, params: dict, prefix_conditioning: torch.Tensor,
                   audio_prefix_codes: torch.Tensor, generator: torch.Generator,
                   max_new_tokens: int, cfg_scale: float, sampling: SamplingParams | None,
                   disable_eos: bool, kv_int8: bool, knobs: dict | None = None,
                   state_bf16: bool = False, into: DecodeState | None = None) -> DecodeState:
    """Cache, delay pattern, prefill, and the first frame. As in JAX the
    first frame is sampled without the EOS bias unless ``disable_eos``.

    ``knobs`` (pool joins, ``ops/sampling.knobs_from_params``) replace
    ``cfg_scale`` and ``sampling``: the CFG mix takes the knob's scale per
    row and the first frame is drawn by the runtime-knob sampler, its Exp(1)
    noise from ``generator``.

    ``into`` (a cache entry's state, of the same shapes) receives the
    result in place: its cache is reset to fresh contents and prefilled,
    its device tensors overwritten, its host fields reset; every tensor
    keeps its storage, so a graph captured over them stays valid."""
    cfg = model.config
    K = cfg.num_codebooks
    two_b, cond_len, _ = prefix_conditioning.shape
    batch = two_b // 2
    lp = audio_prefix_codes.shape[-1]
    audio_seq_len = lp + max_new_tokens
    seq_len = cond_len + audio_seq_len + K
    seq_len = _find_multiple(seq_len, 512 if seq_len >= 1024 else 8)
    dev = prefix_conditioning.device

    if into is None:
        rope = model.rope_for(dev)
        cache = model.allocate_cache(two_b, seq_len, prefix_conditioning.dtype, dev, kv_int8,
                                     state_bf16)
    else:
        rope, cache = into.rope, into.cache
        _reset_cache(cache)
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
    # Only a staged cache has a flushed prefix, ending at the prefill.
    stage_base = cond_len + lp + 1 if "k_stage" in cache else None
    stage_scalars = None
    if stage_base is not None:
        stage_scalars = torch.tensor([[stage_base, 0, l] for l in range(cache["k_stage"].shape[0])],
                                     dtype=torch.int32, device=dev)
    fresh = DecodeState(
        delayed=delayed, cache=cache, offset=offset0,
        remaining=torch.full((batch,), max_steps, dtype=torch.long, device=dev),
        stopping=torch.zeros((batch,), dtype=torch.bool, device=dev),
        stop_offset=torch.full((batch,), -1, dtype=torch.long, device=dev),
        stage_base=stage_base, rope=rope,
        offset_t=torch.full((1,), offset0, dtype=torch.long, device=dev),
        stage_scalars=stage_scalars,
    )
    if into is None:
        return fresh
    for name in _STATE_TENSORS:
        dst = getattr(into, name)
        if dst is not None:
            dst.copy_(getattr(fresh, name))
    into.offset, into.stage_base = offset0, stage_base
    into.guaranteed, into.done, into.host_reads = 0, False, 0
    return into


# The device tensors of a DecodeState besides its cache: what a step reads
# and writes at a fixed address.
_STATE_TENSORS = ("delayed", "remaining", "stopping", "stop_offset", "offset_t", "stage_scalars")


def _decode_step(model, params, s: DecodeState, cond_len, cfg_scale, sampling, logit_bias,
                 generator) -> None:
    """One decode step on the device state, in place. It reads no host
    value and changes no host field, so a CUDA graph can capture it."""
    cfg = model.config
    K, eos, mask_tok = cfg.num_codebooks, cfg.eos_token_id, cfg.masked_token_id
    delayed = s.delayed
    ncol = delayed.shape[-1]
    dev = delayed.device
    prev = s.offset_t  # the column written last: this step's input
    offset = prev + 1
    emb = model.embed_codes(params, delayed.index_select(2, prev))
    emb = torch.cat([emb, emb], dim=0)
    logits = model.compute_logits(params, emb, s.cache, prev + cond_len, cfg_scale, s.rope,
                                  stage_base=s.stage_scalars)
    logits = logits + logit_bias

    # Window of the last w delayed frames, its start clamped into range
    # (JAX's dynamic_slice wraps a negative start instead, a window wider
    # than the columns so far; with the default w = 2 that never happens).
    w = min(sampling.repetition_penalty_window, ncol)
    start = (offset - w).clamp(0, ncol - w)
    window = delayed.index_select(2, start + torch.arange(w, device=dev))
    next_token = sample_from_logits(generator, logits, sampling, window)

    # EOS cascade (vector math; codebook idx = 9 - remaining emits EOS).
    eos_in_cb0 = next_token[:, 0] == eos
    remaining = torch.where(eos_in_cb0, s.remaining.clamp(max=EOS_CASCADE), s.remaining)
    s.stop_offset.copy_(torch.where(eos_in_cb0 & ~s.stopping, offset, s.stop_offset))
    s.stopping |= eos_in_cb0
    eos_idx = (EOS_CASCADE - remaining).clamp(0, K - 1)[:, None]
    cb = torch.arange(K, device=dev)[None, :]
    cascade = torch.where(cb < eos_idx, mask_tok, torch.where(cb == eos_idx, eos, next_token))
    next_token = torch.where(s.stopping[:, None], cascade, next_token)

    # The column index clamps into range as JAX's dynamic update does (the
    # last step rewrites the already full last column, a no-op).
    col = offset.clamp(max=ncol - 1)
    frame = _masked_scatter_frame(delayed.index_select(2, col)[..., 0], next_token)
    delayed.index_copy_(2, col, frame[..., None])
    s.remaining.copy_(remaining - 1)
    s.offset_t += 1
    if s.stage_scalars is not None:
        s.stage_scalars[:, 1] += 1


def _read_max_remaining(s: DecodeState) -> int:
    """The stop test's one device read."""
    s.host_reads += 1
    return int(s.remaining.max())


def _refill(s: DecodeState, disable_eos: bool) -> None:
    """Read ``R = max(remaining)`` and set the steps it guarantees.

    A step maps a row's ``r`` to ``min(r, 9) - 1`` when codebook 0 draws
    EOS and to ``r - 1`` otherwise, so after ``j`` more steps the row that
    held ``R`` holds at least ``min(R, 9) - j``: the next ``min(R, 9)``
    steps all pass JAX's test ``max(remaining) > 0``. With ``disable_eos``
    EOS has logit NEG_INF in every codebook (probability 0 after the
    softmax, never an argmax), so no row clamps and all ``R`` steps run.
    After a read of ``R < 9`` every row ends within ``R`` steps, so a run
    of ``n`` steps makes at most ``ceil(n / 9) + 1`` reads."""
    r = _read_max_remaining(s)
    s.done = r <= 0
    s.guaranteed = 0 if s.done else r if disable_eos else min(r, EOS_CASCADE)


def _decode_segment(s: DecodeState, runner: StepGraph, cond_len: int, disable_eos: bool,
                    step_limit: int | None = None) -> int:
    """JAX's ``_decode_loop``: steps until every row is done or, if given,
    ``step_limit`` steps have run; returns the number of steps. Steps run
    in runs of those the last read guarantees (:func:`_refill`), cut at the
    stage's canonical flush and at the limit, so no step runs after JAX's
    loop would have stopped. ``runner`` runs the steps (eagerly or by
    replaying a captured one)."""
    staged = s.stage_base is not None
    depth = s.cache["k_stage"].shape[2] if staged else 0
    steps = 0
    while not s.done and (step_limit is None or steps < step_limit):
        if s.guaranteed == 0:
            _refill(s, disable_eos)
            continue
        n = s.guaranteed
        if step_limit is not None:
            n = min(n, step_limit - steps)
        if staged:
            n = min(n, depth - (s.offset + cond_len - s.stage_base))
        runner.run(n)
        s.offset += n
        s.guaranteed -= n
        steps += n
        if staged and s.offset + cond_len - s.stage_base == depth:
            flush_kv_stage(s.cache, s.stage_base, s.stage_scalars)
            s.stage_base += depth
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


@dataclass(eq=False)
class _Entry:
    """One static signature's decode state at fixed addresses: the step's
    tensors, its logit bias, its own generator and its runner (with the
    captured graph, on the card). ``params`` keeps the tree alive, so its
    ``id`` in the key stays unique while the entry lives."""
    key: tuple
    state: DecodeState
    logit_bias: torch.Tensor
    generator: torch.Generator
    runner: StepGraph
    params: dict
    nbytes: int
    busy: bool = True
    captured: bool = False  # its graph's capture has been counted


def _state_bytes(s: DecodeState, *extra: torch.Tensor) -> int:
    tensors = [*s.cache.values(), *(getattr(s, n) for n in _STATE_TENSORS), *extra]
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _default_generator(dev: torch.device) -> torch.Generator:
    if dev.type == "cuda":
        return torch.cuda.default_generators[
            dev.index if dev.index is not None else torch.cuda.current_device()]
    return torch.default_generator


class DecodeEngine:
    """User-facing generate API over a :class:`ZonosModel`.

    ``kv_int8`` (transformer) stores the flushed KV prefix as int8 with
    per-(position, kv head) scales (half the cache bytes); the stage and the
    current token stay exact. Paired with ``ops/quant.quantize_zonos_params``
    weights it is the int8 serving configuration. ``state_bf16`` (hybrid)
    stores the SSM state in bf16; the recurrence still computes in fp32.

    ``cuda_graphs`` (default: on for inputs on the card, off on the CPU)
    captures one decode step per cache entry, after the prefill and one
    eager step, and replays it; ``False`` runs the same step eagerly, for
    comparisons. Asking for graphs with inputs on the CPU raises.

    The cache (module docstring): a ``generate`` or a ``generate_stream``
    iterator checks out a free entry of its key, or makes one, and gives it
    back when it ends (a stream also when it is closed or dropped). Two
    runs at once never share an entry. The entry's generator takes the
    caller's generator state before the prefill and hands its state back
    after the run, so the codes and the caller's generator end as an
    uncached run's would. Free entries are evicted, least recently used
    first, while the entries hold more than ``cache_bytes``; :meth:`clear`
    drops them all. Without graphs an entry still keeps its tensors.
    ``captures``, ``hits``, ``misses`` and ``resident_bytes`` count the
    graphs captured, the runs that reused an entry, the entries made and
    the bytes of state held."""

    # The bound on the bytes of state the entries hold, kept by evicting free
    # entries: an entry of the flagship at CFG batch 16 and the 2580-frame
    # bucket holds ~2.6 GB of bf16 KV.
    cache_bytes = 16 << 30

    def __init__(self, model: ZonosModel, kv_int8: bool = False, state_bf16: bool = False,
                 cuda_graphs: bool | None = None):
        self.model = model
        self.kv_int8 = kv_int8
        self.state_bf16 = state_bf16
        self.cuda_graphs = cuda_graphs
        self.captures = 0
        self.hits = 0
        self.misses = 0
        self.resident_bytes = 0
        self._entries: list[_Entry] = []  # least recently used first
        self._lock = threading.Lock()

    def clear(self) -> None:
        """Drop every entry (and with it the parameter trees they keep);
        entries in use are dropped when their runs give them back."""
        with self._lock:
            self._entries.clear()
            self.resident_bytes = 0

    def _evict(self) -> None:
        for e in [e for e in self._entries if not e.busy]:
            if self.resident_bytes <= self.cache_bytes:
                break
            self._entries.remove(e)
            self.resident_bytes -= e.nbytes

    def _start(self, params, prefix_conditioning, audio_prefix_codes, generator,
               max_new_tokens, cfg_scale, sampling_params,
               disable_eos) -> tuple[_Entry, torch.Generator]:
        """Checks, then the prefill into a checked-out entry; returns the
        entry and the caller's generator."""
        if cfg_scale == 1.0:
            raise NotImplementedError("cfg_scale == 1 is not supported (as in the reference)")
        if sampling_params is None:
            sampling_params = SamplingParams(min_p=0.1)
        elif isinstance(sampling_params, dict):
            sampling_params = SamplingParams.from_dict(sampling_params)
        dev = prefix_conditioning.device
        graphs = dev.type == "cuda" if self.cuda_graphs is None else self.cuda_graphs
        if graphs and dev.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs inputs on a CUDA device, got {dev}")
        cfg = self.model.config
        two_b, cond_len = prefix_conditioning.shape[:2]
        if audio_prefix_codes is None:
            audio_prefix_codes = torch.zeros((two_b // 2, cfg.num_codebooks, 0),
                                             dtype=torch.long, device=dev)
        caller = generator if generator is not None else _default_generator(dev)
        # JAX's statics (generate.py:356-362) and shapes, the tree and the device.
        key = (id(params), audio_prefix_codes.shape[-1], int(max_new_tokens), float(cfg_scale),
               sampling_params, bool(disable_eos), self.kv_int8, self.state_bf16, two_b,
               cond_len, prefix_conditioning.dtype, dev, graphs)
        with self._lock:
            entry = next((e for e in reversed(self._entries) if not e.busy and e.key == key),
                         None)
            if entry is not None:
                entry.busy = True
                self._entries.remove(entry)
                self._entries.append(entry)
                self.hits += 1
                self._evict()
        if entry is not None:
            try:
                entry.generator.set_state(caller.get_state())
                _prefill_state(self.model, params, prefix_conditioning, audio_prefix_codes,
                               entry.generator, max_new_tokens, cfg_scale, sampling_params,
                               disable_eos, self.kv_int8, state_bf16=self.state_bf16,
                               into=entry.state)
                _fill_logit_bias(entry.logit_bias, cfg.eos_token_id, disable_eos)
            except BaseException:
                self._finish(entry, None)
                raise
            entry.runner.replays, entry.runner.capture_seconds = 0, 0.0
            return entry, caller
        # A miss: a fresh state, its own generator (on the card the graph
        # registers it) and a step over them. Outside a capture
        # ``set_state`` writes the seed and offset into the generator's
        # state object, the one a graph registered, where
        # ``graphsafe_set_state`` would swap that object out.
        gen = torch.Generator(dev)
        gen.set_state(caller.get_state())
        s = _prefill_state(self.model, params, prefix_conditioning, audio_prefix_codes, gen,
                           max_new_tokens, cfg_scale, sampling_params, disable_eos,
                           self.kv_int8, state_bf16=self.state_bf16)
        logit_bias = torch.empty((s.delayed.shape[0], cfg.num_codebooks, self.model.head_out_dim),
                                 dtype=torch.float32, device=dev)
        _fill_logit_bias(logit_bias, cfg.eos_token_id, disable_eos)
        step = functools.partial(_decode_step, self.model, params, s, cond_len, cfg_scale,
                                 sampling_params, logit_bias, gen)
        entry = _Entry(key, s, logit_bias, gen, StepGraph(step, dev, graphs, gen), params,
                       _state_bytes(s, logit_bias))
        with self._lock:
            self._entries.append(entry)
            self.misses += 1
            self.resident_bytes += entry.nbytes
            self._evict()
        return entry, caller

    def _finish(self, entry: _Entry, caller: torch.Generator | None) -> None:
        """Hand the generator state back to the caller and the entry back
        to the cache."""
        if caller is not None:
            caller.set_state(entry.generator.get_state())
        with self._lock:
            if entry.runner.graph is not None and not entry.captured:
                entry.captured = True
                self.captures += 1
            entry.busy = False
            if entry in self._entries:
                self._evict()

    def _result(self, s: DecodeState, runner: StepGraph, steps: int, prefill_s: float,
                decode_s: float) -> GenerateResult:
        codes, valid, valid_rows = _finalize(self.model, s)
        return GenerateResult(codes=codes, valid_length=valid, valid_lengths=valid_rows,
                              steps=steps, prefill_seconds=prefill_s, decode_seconds=decode_s,
                              host_reads=s.host_reads, replays=runner.replays,
                              capture_seconds=runner.capture_seconds,
                              step_launches=dict(runner.step_launches))

    def generate(self, params: dict, prefix_conditioning: torch.Tensor,
                 audio_prefix_codes: torch.Tensor | None = None, *,
                 generator: torch.Generator | None = None, max_new_tokens: int = 86 * 30,
                 cfg_scale: float = 2.0, sampling_params: SamplingParams | dict | None = None,
                 disable_eos: bool = False) -> GenerateResult:
        dev = prefix_conditioning.device
        with torch.inference_mode():
            t0 = time.perf_counter()
            entry, caller = self._start(params, prefix_conditioning, audio_prefix_codes,
                                        generator, max_new_tokens, cfg_scale, sampling_params,
                                        disable_eos)
            try:
                _sync(dev)
                t1 = time.perf_counter()
                s, runner = entry.state, entry.runner
                steps = _decode_segment(s, runner, prefix_conditioning.shape[1], disable_eos)
                _sync(dev)
                return self._result(s, runner, steps, t1 - t0, time.perf_counter() - t1)
            finally:
                self._finish(entry, caller)

    def generate_stream(self, params: dict, prefix_conditioning: torch.Tensor,
                        audio_prefix_codes: torch.Tensor | None = None, *,
                        generator: torch.Generator | None = None,
                        max_new_tokens: int = 86 * 30, cfg_scale: float = 2.0,
                        sampling_params: SamplingParams | dict | None = None,
                        disable_eos: bool = False,
                        chunk_steps: int = 43) -> Iterator[GenerateResult]:
        """Yield a cumulative :class:`GenerateResult` every ``chunk_steps``
        decode steps (~0.5 s of audio at 43). The codes equal
        :meth:`generate`'s for the same generator state; stop consuming the
        iterator to abort (nothing runs after the last yield consumed). The
        iterator holds its cache entry from its first ``next`` until it
        ends, is closed or is dropped."""
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
        dev = prefix_conditioning.device
        cond_len = prefix_conditioning.shape[1]
        with torch.inference_mode():
            t0 = time.perf_counter()
            entry, caller = self._start(params, prefix_conditioning, audio_prefix_codes,
                                        generator, max_new_tokens, cfg_scale, sampling_params,
                                        disable_eos)
        s, runner = entry.state, entry.runner
        try:
            with torch.inference_mode():
                _sync(dev)
            prefill_s, steps, decode_s = time.perf_counter() - t0, 0, 0.0
            while True:
                with torch.inference_mode():
                    t0 = time.perf_counter()
                    steps += _decode_segment(s, runner, cond_len, disable_eos, chunk_steps)
                    _sync(dev)
                    decode_s += time.perf_counter() - t0
                    result = self._result(s, runner, steps, prefill_s, decode_s)
                yield result
                with torch.inference_mode():
                    if not s.done and s.guaranteed == 0:
                        _refill(s, disable_eos)
                if s.done:
                    return
        finally:
            with torch.inference_mode():
                self._finish(entry, caller)
