"""HTTP TTS server (the JAX package's ``serve/server.py``): the reference
Flask app's ``POST /tts`` contract (JSON ``{text, speaker_audio_path,
speaking_rate, language?}`` -> ``audio/wav``) on the standard library, with:

* **one owner of the model**: HTTP threads only enqueue and send bytes; one
  worker thread parses requests (speaker embeddings and audio prefixes are
  computed there), runs every generate on the card and encodes the WAVs. A
  CUDA graph capture is global to the process, so no other thread may
  touch the card while the worker captures;
* **batching**: the worker drains up to ``max_batch`` queued requests and
  decodes compatible ones together, conditioning left-padded to a length
  bucket and ``max_new_tokens`` rounded up to one, so requests reuse the
  decode engine's captured graphs (``engine/generate.DecodeEngine``'s cache,
  keyed like JAX's compile cache) instead of capturing their own;
* **segment interleaving**: up to ``max_active_jobs`` jobs advance one
  ``segment_steps`` decode segment at a time in round robin, so a short
  request is not held behind a long one;
* **streaming** (``"stream": true``): chunked HTTP/1.1 PCM after a WAV
  header, each chunk vocoded with a withheld margin;
* **the continuous-batching pool** (``pooled=True``, ``engine/pool.py``):
  staggered requests join a shared pool, whose streaming rows are vocoded
  by ``make_pool_emit`` on the card;
* ``warmup``: captures the graphs of representative request shapes before
  serving;
* ``/healthz``, ``/metrics`` (counters, RTF, queue depth, and the
  ``utils/tracing`` phases and counters), ``/model-info`` and the web UI
  at ``/``;
* spans (``utils/tracing``, recorded while switched on): a ``request``
  span per request (``rid``: the payload's ``request_id`` or a server
  counter; ``path``: ``pool``, ``stream_job`` or ``decode_job``;
  ``reason``: why a pooled server's request took the job path), the
  pool's ``admit`` and ``pool_segment`` (with a ``chunk`` record per
  streaming row), the ``stream_segment`` and ``decode_segment`` of jobs,
  and ``worker_wait`` while the worker has nothing to do.

Seeds: a request's generator (on the pipeline's device) is seeded from its
seed (the server's, 420 as in the reference, unless the payload sets one)
and a request counter, ``(seed * 1000003 + counter) % 2**31``: the pool's
row-seed formula. JAX folds the same pair into a ``jax.random`` key; the
draws differ from JAX's by design.

    python -m zonos_vibes_tpu_torch.serve.server --port 5000 [--pooled] [--warmup]
"""

from __future__ import annotations

import base64
import hashlib
import io
import itertools
import json
import queue
import struct
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from ..ops.sampling import SamplingParams
from ..utils import tracing
from .sample import read_wav, wav_bytes

DEFAULT_SEED = 420  # the reference server's torch.manual_seed(420)
DEFAULT_UNCONDITIONAL = [
    "emotion", "vqscore_8", "fmax", "pitch_std", "dnsmos_ovrl", "speaker_noised",
]
DEFAULT_SAMPLING = SamplingParams(linear=0.5, conf=0.4)

def wav_stream_header(sample_rate: int) -> bytes:
    """WAV header for a stream of unknown length (RIFF and data sizes at
    their maximum, the usual convention for live PCM)."""
    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


def request_seed(seed: int, counter: int) -> int:
    """A request's generator seed from its seed and the request counter."""
    return (seed * 1000003 + counter) % (2 ** 31)


def _error(status: int, message: str, **extra) -> tuple[int, str, bytes]:
    return status, "application/json", json.dumps({"error": message, **extra}).encode()


@dataclass
class _Request:
    payload: dict
    done: threading.Event = field(default_factory=threading.Event)
    response: tuple[int, str, bytes] | None = None  # (status, content type, body)
    enqueued_at: float = field(default_factory=time.monotonic)
    retries: int = 0
    # A streaming request gets a chunk queue instead of one response: PCM
    # bytes, ("error", response), or None at the end.
    stream_q: "queue.Queue | None" = None
    # Set by the HTTP thread when the client goes away; the worker stops
    # generating at the next segment.
    cancelled: threading.Event = field(default_factory=threading.Event)
    rid: Any = None  # the payload's request_id, else a server-assigned id
    span: Any = tracing.NOOP  # the request's span (utils/tracing)


class Metrics:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        self.batched_requests = 0
        self.replayed_requests = 0
        self.audio_seconds_total = 0.0
        self.compute_seconds_total = 0.0
        self.queue_depth = 0
        self.pooled_requests = 0  # rows that finished in a pool
        self.pool_admitted = 0  # rows that joined a pool (aborted streams too)
        self.pool_admit_failures = 0  # admits that raised and fell to the job path

    def snapshot(self) -> dict:
        with self.lock:
            rtf = (self.audio_seconds_total / self.compute_seconds_total
                   if self.compute_seconds_total > 0 else 0.0)
            return {
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "audio_seconds_total": round(self.audio_seconds_total, 3),
                "compute_seconds_total": round(self.compute_seconds_total, 3),
                "rtf": round(rtf, 3),
                "batched_requests": self.batched_requests,
                "replayed_requests": self.replayed_requests,
                "queue_depth": self.queue_depth,
                "pooled_requests": self.pooled_requests,
                "pool_admitted": self.pool_admitted,
                "pool_admit_failures": self.pool_admit_failures,
            }


class TTSServer:
    def __init__(
        self,
        pipeline,
        host: str = "0.0.0.0",
        port: int = 5000,
        max_batch: int = 8,
        batch_window_s: float = 0.05,
        request_timeout_s: float = 120.0,
        seed: int = DEFAULT_SEED,
        monitor=None,  # parallel.multihost.HeartbeatMonitor, or any object with ``healthy``
        max_retries: int = 1,
        extra_pipelines: dict | None = None,
        max_active_jobs: int = 4,
        segment_steps: int = 43,  # ~0.5 s of audio per scheduling slice, the stream's chunk
        pooled: bool = False,
        pool_slots: int = 4,
        pool_kv_int8: bool = False,
        pool_state_bf16: bool = False,
        stream_margin: int = 32,  # withheld code frames of a stream's right edge: must
        # cover the DAC decoder's half receptive field (~9 frames at 44.1 kHz)
    ):
        self.pipeline = pipeline
        # Named pipelines share the queue; a request picks one by "model".
        self.pipelines = {"default": pipeline}
        if extra_pipelines:
            self.pipelines.update(extra_pipelines)
        self.host, self.port = host, port
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.request_timeout_s = request_timeout_s
        self.seed = seed
        self.monitor = monitor
        self.max_retries = max_retries
        self.max_active_jobs = max_active_jobs
        self.segment_steps = segment_steps
        self.pooled = pooled
        self.pool_slots = pool_slots
        self.pool_kv_int8 = pool_kv_int8  # transformer pools only
        self.pool_state_bf16 = pool_state_bf16  # hybrid pools only
        self.stream_margin = int(stream_margin)
        if pooled:
            # The pooled vocoder's fixed window must emit at least 8 frames
            # past both margins, or a streaming row never advances and the
            # worker spins.
            emit_cap = _PoolJob.VOCODE_WIN - 2 * self.stream_margin
            if self.stream_margin <= 0 or emit_cap < 8:
                raise ValueError(
                    f"stream_margin={self.stream_margin} breaks pooled streaming: need "
                    f"0 < margin <= {(_PoolJob.VOCODE_WIN - 8) // 2} so each "
                    f"{_PoolJob.VOCODE_WIN}-frame vocoder window emits >= 8 frames "
                    f"(emit_cap={emit_cap})")
        self._pool_jobs: dict = {}  # model name -> _PoolJob
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.metrics = Metrics()
        self._spk_cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self._spk_lock = threading.Lock()
        self._req_counter = 0
        self._rids = itertools.count(1)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)

    # -- speaker and prefix caches ------------------------------------------

    SPK_CACHE_MAX = 256  # one [1, 1, 128] embedding per entry
    PREFIX_CACHE_MAX = 64  # one [1, 9, Lp] code tensor per entry

    def _cached(self, key: tuple, compute, kind: str):
        """One LRU for speaker embeddings and prefix codes, under one bound;
        counts ``<kind>_cache_hits`` and ``<kind>_cache_misses``."""
        with self._spk_lock:
            if key in self._spk_cache:
                self._spk_cache.move_to_end(key)
                tracing.count(f"{kind}_cache_hits")
                return self._spk_cache[key]
        tracing.count(f"{kind}_cache_misses")
        val = compute()
        with self._spk_lock:
            self._spk_cache[key] = val
            while len(self._spk_cache) > self.SPK_CACHE_MAX + self.PREFIX_CACHE_MAX:
                self._spk_cache.popitem(last=False)
        return val

    def _speaker_embedding(self, src, model: str = "default"):
        """``src``: a server-side path or uploaded WAV ``bytes`` (cached by
        their digest)."""
        if isinstance(src, bytes):
            key = (model, "spk-b64", hashlib.sha1(src).hexdigest())
            load = lambda: read_wav(io.BytesIO(src))  # noqa: E731
        else:
            key = (model, src)
            load = lambda: read_wav(src)  # noqa: E731

        def compute():
            pipe = self.pipelines[model]
            with tracing.span("speaker_embed", device=pipe.device):
                wav, sr = load()
                return pipe.make_speaker_embedding(wav, sr)

        return self._cached(key, compute, "speaker")

    def _prefix_codes(self, src, model: str = "default"):
        """DAC codes of an audio prefix (path or WAV bytes), for
        continuation; cached like the speaker embeddings."""
        if isinstance(src, bytes):
            key = ("prefix", model, "b64", hashlib.sha1(src).hexdigest())
            load = lambda: read_wav(io.BytesIO(src))  # noqa: E731
        else:
            key = ("prefix", model, src)
            load = lambda: read_wav(src)  # noqa: E731

        def compute():
            wav, sr = load()
            return self.pipelines[model].encode_audio(wav, sr)

        return self._cached(key, compute, "prefix")

    # -- request processing (the worker thread) -----------------------------

    def _parse(self, p: dict):
        """Payload -> parsed request dict, or an error response tuple."""
        text = p.get("text")
        if not text:
            return _error(400, "Missing required field: text")
        model = p.get("model", "default")
        if model not in self.pipelines:
            return _error(400, f"Unknown model: {model}", available=sorted(self.pipelines))
        speaker_path = p.get("speaker_audio_path")
        speaker_b64 = p.get("speaker_audio")  # base64 WAV upload
        speaker = None
        if speaker_path:
            try:
                speaker = self._speaker_embedding(speaker_path, model)
            except FileNotFoundError:
                return _error(404, f"Speaker audio not found: {speaker_path}")
        elif speaker_b64:
            try:
                raw = base64.b64decode(speaker_b64, validate=True)
                speaker = self._speaker_embedding(raw, model)
                speaker_path = "b64:" + hashlib.sha1(raw).hexdigest()
            except Exception:
                return _error(400, "Invalid speaker_audio (expect base64 WAV)")
        elif not p.get("allow_unconditional_speaker", bool(p.get("ui")) or "emotion" in p):
            # A bare reference-contract request needs a speaker; the web UI's
            # payloads ("ui", or "emotion") may use the learned uncond one.
            return _error(400, "Missing required field: speaker_audio_path")

        prefix_path = p.get("prefix_audio_path")
        prefix_b64 = p.get("prefix_audio")  # base64 WAV upload
        prefix_codes = None
        if prefix_path:
            try:
                prefix_codes = self._prefix_codes(prefix_path, model)
            except FileNotFoundError:
                return _error(404, f"Prefix audio not found: {prefix_path}")
        elif prefix_b64:
            try:
                raw = base64.b64decode(prefix_b64, validate=True)
                prefix_codes = self._prefix_codes(raw, model)
                prefix_path = "b64:" + hashlib.sha1(raw).hexdigest()
            except Exception:
                return _error(400, "Invalid prefix_audio (expect base64 WAV)")

        uncond = tuple(sorted(p.get("unconditional_keys", DEFAULT_UNCONDITIONAL)))
        cond_kwargs: dict = {
            "text": text,
            "language": p.get("language", "en-us"),
            "speaker": speaker,
            "speaking_rate": float(p.get("speaking_rate", 15.0)),
            "unconditional_keys": uncond,
        }
        for k in ("emotion", "vqscore_8"):
            if p.get(k) is not None:
                cond_kwargs[k] = [float(x) for x in p[k]]
        for k in ("fmax", "pitch_std", "dnsmos_ovrl", "ctc_loss"):
            if p.get(k) is not None:
                cond_kwargs[k] = float(p[k])
        if p.get("speaker_noised") is not None:
            cond_kwargs["speaker_noised"] = bool(p["speaker_noised"])

        sampling = DEFAULT_SAMPLING
        if isinstance(p.get("sampling"), dict):
            int_knobs = ("top_k", "repetition_penalty_window")
            sampling = SamplingParams.from_dict(
                {k: (int(v) if k in int_knobs else float(v)) for k, v in p["sampling"].items()})
        cfg_scale = float(p.get("cfg_scale", 2.0))
        return {
            "cond_kwargs": cond_kwargs,
            "sampling": sampling,
            "cfg_scale": cfg_scale,
            "max_new_tokens": int(p.get("max_new_tokens", 86 * 30)),
            "stream": bool(p.get("stream", False)),
            "model": model,
            "seed": int(p.get("seed", self.seed)),
            "prefix_codes": prefix_codes,
            # Requests in one decode share the model, the uncond keys,
            # speaker presence, sampling and CFG. An explicit seed isolates
            # the group (the batch shares one generator), and so does a
            # prefix (the rows share its length).
            "group": (model, uncond, speaker is not None, sampling, cfg_scale,
                      int(p["seed"]) if "seed" in p else None, prefix_path or None),
        }

    @staticmethod
    def _bucket(n: int, buckets=(215, 430, 860, 1290, 2580)) -> int:
        """``max_new_tokens`` bucket: one cache entry (one graph) per bucket."""
        for b in buckets:
            if n <= b:
                return b
        return n

    @staticmethod
    def _cond_bucket(n: int, buckets=(32, 64, 128, 256, 512)) -> int:
        """Phoneme-length bucket. The decode step is captured per
        conditioning length; left-padding with PAD to the bucket is the
        reference's own batching (pads are attended to)."""
        for b in buckets:
            if n <= b:
                return b
        return n

    def _generator(self, pipe, seed: int) -> torch.Generator:
        self._req_counter += 1
        return torch.Generator(pipe.device).manual_seed(request_seed(seed, self._req_counter))

    def _start_decode_job(self, reqs: list[_Request], parsed: list[dict]):
        """A non-streaming group as a job advanced one segment at a time."""
        pipe = self.pipelines[parsed[0]["model"]]
        conds = [pipe.make_cond_dict(**r["cond_kwargs"]) for r in parsed]
        pad_len = self._cond_bucket(max(int(c["espeak"].shape[1]) for c in conds))
        cond = pipe.merge_cond_dicts(conds, pad_len=pad_len)
        mnt = self._bucket(max(r["max_new_tokens"] for r in parsed))
        gen = self._generator(pipe, parsed[0]["seed"])
        prefix = parsed[0]["prefix_codes"]
        if prefix is not None and len(reqs) > 1:
            prefix = prefix.repeat(len(reqs), 1, 1)
        t0 = time.monotonic()
        with tracing.phase("conditioning"):
            prefix_cond = pipe.prepare_conditioning(cond)
        it = pipe.engine.generate_stream(
            pipe.params, prefix_cond, prefix, generator=gen, max_new_tokens=mnt,
            cfg_scale=parsed[0]["cfg_scale"], sampling_params=parsed[0]["sampling"],
            chunk_steps=self.segment_steps)
        return _DecodeJob(self, reqs, parsed, pipe, it, prefix, time.monotonic() - t0)

    def _finish_decode_job(self, job: "_DecodeJob") -> None:
        """Vocode the finished group and answer each row, trimmed to its own
        frames (the prefix's included)."""
        pipe, reqs, parsed = job.pipe, job.reqs, job.parsed
        t0 = time.monotonic()
        result = job.result
        wavs = pipe.decode_audio(result)  # [B, samples]
        job.compute_s += time.monotonic() - t0
        valid_rows = [int(v) for v in result.valid_lengths]
        sr, hop = pipe.dac.sampling_rate, pipe.dac.hop
        audio_total = 0.0
        delivered = []
        prefix_frames = int(job.prefix.shape[-1]) if job.prefix is not None else 0
        for i, (req, r) in enumerate(zip(reqs, parsed)):
            frames = min(valid_rows[i], r["max_new_tokens"] + prefix_frames)
            delivered.append(frames)
            wav = wavs[i, : frames * hop]
            audio_total += wav.shape[-1] / sr
            req.response = (200, "audio/wav", wav_bytes(wav, sr))
            req.done.set()
        with self.metrics.lock:
            self.metrics.audio_seconds_total += audio_total
            self.metrics.compute_seconds_total += job.compute_s
            self.metrics.batched_requests += len(reqs) - 1
        tracing.log_event("tts_group_done", batch=len(reqs), frames=delivered,
                          compute_s=round(job.compute_s, 3), audio_s=round(audio_total, 3))

    def warmup(self, combos: list[tuple] | None = None) -> int:
        """Capture the decode graphs of representative request shapes
        before serving, so the first such request replays instead of
        capturing (what the reference's CUDA-graph warmup does). Each combo
        ``(batch, cond_bucket, mnt_bucket, with_speaker)`` runs one generate
        on dummy conditioning through the segment path the scheduler runs;
        the engine keeps its cache entry. Returns the number of combos run."""
        if combos is None:
            # The default request: mnt 86 * 30 (bucket 2580), a sentence (cond
            # bucket 64), with and without a speaker.
            combos = [(1, 64, self._bucket(86 * 30), True),
                      (1, 64, self._bucket(86 * 30), False)]
        with tracing.phase("warmup"):
            return self._warm(combos, tuple(sorted(DEFAULT_UNCONDITIONAL)))

    def _warm(self, combos: list[tuple], uncond: tuple) -> int:
        n = 0
        for pipe in self.pipelines.values():
            has_speaker = any(sp.name == "speaker" for sp in pipe.model.prefix_conditioner.specs)
            for batch, cond_len, mnt, with_speaker in combos:
                if with_speaker and not has_speaker:
                    continue
                speaker = (torch.zeros(pipe.speaker_shape(), dtype=torch.bfloat16,
                                       device=pipe.device) if with_speaker else None)
                conds = [pipe.make_cond_dict(text="warm", speaker=speaker,
                                             unconditional_keys=uncond) for _ in range(batch)]
                cond = pipe.merge_cond_dicts(conds, pad_len=cond_len)
                pipe.generate(cond, generator=torch.Generator(pipe.device).manual_seed(0),
                              cfg_scale=2.0, max_new_tokens=mnt, sampling_params=DEFAULT_SAMPLING,
                              callback=lambda *a: True, callback_interval=self.segment_steps)
                n += 1
        return n

    def _start_stream_job(self, req: _Request, r: dict) -> "_StreamJob":
        """A streaming request as a job: each slice ships one vocoded chunk."""
        assert req.stream_q is not None
        pipe = self.pipelines[r["model"]]
        conds = [pipe.make_cond_dict(**r["cond_kwargs"])]
        pad_len = self._cond_bucket(int(conds[0]["espeak"].shape[1]))
        cond = pipe.merge_cond_dicts(conds, pad_len=pad_len)
        mnt = self._bucket(r["max_new_tokens"])
        gen = self._generator(pipe, r["seed"])
        prefix = r["prefix_codes"]
        prefix_frames = int(prefix.shape[-1]) if prefix is not None else 0
        budget = (r["max_new_tokens"] + prefix_frames) * pipe.dac.hop
        stream = pipe.generate_stream(
            cond, prefix, generator=gen, cfg_scale=r["cfg_scale"], max_new_tokens=mnt,
            sampling_params=r["sampling"], chunk_frames=self.segment_steps,
            margin_frames=self.stream_margin)
        return _StreamJob(self, req, pipe, stream, budget)

    def _drain_batch(self, block: bool = True) -> list[_Request]:
        """Up to ``max_batch`` queued requests. Idle (``block``): wait for
        one, then hold the batching window; with jobs active: poll."""
        try:
            first = self.queue.get(timeout=0.2 if block else 0.0)
        except queue.Empty:
            return []
        batch = [first]
        if not block:
            while len(batch) < self.max_batch:
                try:
                    batch.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            return batch
        deadline = time.monotonic() + self.batch_window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    @staticmethod
    def _answer(req: _Request, response: tuple) -> None:
        if req.stream_q is not None:
            req.stream_q.put(("error", response))
            req.stream_q.put(None)
        else:
            req.response = response
            req.done.set()

    def _try_pool(self, req: _Request, r: dict, jobs: list) -> bool:
        """Admit into the request's model's pool; False (the job path)
        when the pool is full, the request ineligible or the admit raised
        (the request span's ``reason``)."""
        if not self.pooled:
            return False
        if not self._pool_eligible(r):
            req.span.set(reason="ineligible")
            return False
        try:
            return self._pool_admit(req, r, jobs)
        except Exception as e:  # noqa: BLE001 (boundary: the job path serves it)
            req.span.set(reason="admit_failed")
            tracing.log_event("pool_admit_failed", error=repr(e)[:120])
            with self.metrics.lock:
                self.metrics.pool_admit_failures += 1
            return False

    def _admit(self, jobs: list) -> None:
        """Parse and group queued requests into new jobs, at most
        ``max_active_jobs``."""
        with self.metrics.lock:
            self.metrics.queue_depth = self.queue.qsize()
        if len(jobs) >= self.max_active_jobs:
            return
        if jobs:
            batch = self._drain_batch(block=False)
        else:
            with tracing.span("worker_wait") as sp:
                batch = self._drain_batch(block=True)
                sp.set(taken=len(batch))
        if not batch:
            return

        live: list[_Request] = []
        parsed: list[dict] = []
        for req in batch:
            if time.monotonic() - req.enqueued_at > self.request_timeout_s:
                self._answer(req, _error(503, "Request timed out in queue"))
                continue
            try:
                out = self._parse(req.payload)
            except Exception as e:  # noqa: BLE001 (boundary)
                out = _error(500, f"Bad request: {e}")
            if isinstance(out, tuple):
                self._answer(req, out)
            elif req.stream_q is not None:
                # Streams join the pool too (each row emits its own chunks);
                # a full pool or an ineligible request takes a stream job.
                if self._try_pool(req, out, jobs):
                    continue
                req.span.set(path="stream_job")
                try:
                    jobs.append(self._start_stream_job(req, out))
                except Exception as e:  # noqa: BLE001 (boundary)
                    self._answer(req, _error(500, f"TTS stream failed: {e}"))
            elif not self._try_pool(req, out, jobs):
                req.span.set(path="decode_job")
                live.append(req)
                parsed.append(out)

        groups: dict[tuple, list[int]] = {}
        for i, r in enumerate(parsed):
            groups.setdefault(r["group"], []).append(i)
        for idxs in groups.values():
            reqs_g = [live[i] for i in idxs]
            if len(jobs) >= self.max_active_jobs:
                # More groups than job slots: back to the queue (their
                # enqueue times, and so their timeouts, stay).
                for req in reqs_g:
                    self.queue.put(req)
                continue
            try:
                jobs.append(self._start_decode_job(reqs_g, [parsed[i] for i in idxs]))
            except Exception as e:  # noqa: BLE001 (boundary)
                self._replay_or_fail(reqs_g, e)

    def _replay_or_fail(self, reqs: list[_Request], e: Exception) -> None:
        """Re-enqueue a failed group for a fresh decode up to
        ``max_retries`` times, then answer 500."""
        for req in reqs:
            if req.retries < self.max_retries:
                req.retries += 1
                with self.metrics.lock:
                    self.metrics.replayed_requests += 1
                self.queue.put(req)
            else:
                with self.metrics.lock:
                    self.metrics.errors_total += 1
                req.response = _error(500, f"TTS generation failed: {e}")
                req.done.set()

    def _worker_loop(self):
        """Admit queued requests as jobs, then advance one job by one
        segment, round robin."""
        jobs: list = []
        while not self._stop.is_set():
            self._admit(jobs)
            if not jobs:
                continue
            job = jobs.pop(0)
            try:
                done = job.advance()
            except Exception as e:  # noqa: BLE001 (boundary: replay or 500)
                job.fail(e)
                continue
            if done:
                try:
                    job.finish()
                except Exception as e:  # noqa: BLE001 (boundary)
                    job.fail(e)
            else:
                jobs.append(job)

    # -- continuous-batching pool (engine/pool.py) --------------------------

    def _pool_eligible(self, r: dict) -> bool:
        """CFG scale and sampling are per-row runtime knobs in the pooled
        step, so any request qualifies whose repetition window fits the
        pool's bound and whose frames (prefix included) fit its ceiling."""
        from ..engine.pool import PoolConfig

        prefix_frames = int(r["prefix_codes"].shape[-1]) if r["prefix_codes"] is not None else 0
        return (r["model"] in self.pipelines
                and r["sampling"].repetition_penalty_window <= PoolConfig.max_rep_window
                and prefix_frames + r["max_new_tokens"] <= PoolConfig.max_new_tokens)

    def _pool_admit(self, req: _Request, r: dict, jobs: list) -> bool:
        """Prefill and join a free slot of the request's model's pool;
        False when that pool is full."""
        name = r["model"]
        if name not in self._pool_jobs:
            self._pool_jobs[name] = _PoolJob(self, name)
        return self._pool_jobs[name].admit(req, r, jobs)

    # -- HTTP ---------------------------------------------------------------

    def _enqueue(self, req: _Request) -> None:
        """Name the request, open its span, enqueue it."""
        rid = req.payload.get("request_id")
        req.rid = rid if rid is not None else f"srv-{next(self._rids)}"
        req.span = tracing.begin("request", rid=req.rid, stream=req.stream_q is not None)
        with self.metrics.lock:
            self.metrics.requests_total += 1
        self.queue.put(req)

    def handle_tts(self, payload: dict) -> tuple[int, str, bytes]:
        req = _Request(payload)
        self._enqueue(req)
        if not req.done.wait(self.request_timeout_s + 5):
            req.span.end(status=504)
            return _error(504, "Deadline exceeded")
        req.span.end(status=req.response[0])
        return req.response

    def handle_tts_stream(self, payload: dict) -> _Request:
        """The request, enqueued; its span ends once the HTTP handler has
        sent the stream."""
        req = _Request(payload, stream_q=queue.Queue())
        self._enqueue(req)
        return req

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            # Chunked transfer needs HTTP/1.1 (the handler's default is 1.0).
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, status, ctype, body: bytes):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    from .webui import index_html

                    self._send(200, "text/html; charset=utf-8", index_html())
                elif self.path == "/model-info":
                    info = {
                        "models": sorted(server_self.pipelines),
                        "conditioners": [s.name for s in
                                         server_self.pipeline.model.prefix_conditioner.specs],
                        "conditioners_by_model": {
                            name: [s.name for s in p.model.prefix_conditioner.specs]
                            for name, p in server_self.pipelines.items()},
                    }
                    self._send(200, "application/json", json.dumps(info).encode())
                elif self.path == "/healthz":
                    mon = server_self.monitor
                    if mon is not None and not mon.healthy:
                        self._send(503, "application/json",
                                   b'{"status":"unhealthy","reason":"heartbeat failed"}')
                    else:
                        self._send(200, "application/json", b'{"status":"ok"}')
                elif self.path == "/metrics":
                    snap = server_self.metrics.snapshot()
                    snap["phases"] = tracing.timings_snapshot()
                    snap["counters"] = tracing.counters_snapshot()
                    self._send(200, "application/json", json.dumps(snap).encode())
                else:
                    self._send(404, "application/json", b'{"error":"not found"}')

            def _send_chunk(self, data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            def _stream(self, req):
                """Chunked WAV stream; a client that hangs up cancels the
                request, and the worker stops at its next segment."""
                timeout = server_self.request_timeout_s + 5
                try:
                    first = req.stream_q.get(timeout=timeout)
                except queue.Empty:
                    req.cancelled.set()
                    self._send(504, "application/json", b'{"error":"Deadline exceeded"}')
                    return
                if isinstance(first, tuple) and first and first[0] == "error":
                    self._send(*first[1])
                    return
                if first is None:
                    self._send(500, "application/json", b'{"error":"empty stream"}')
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                sr = server_self.pipeline.dac.sampling_rate
                try:
                    self._send_chunk(wav_stream_header(sr))
                    item = first
                    while item is not None:
                        if isinstance(item, bytes):
                            self._send_chunk(item)
                        item = req.stream_q.get(timeout=timeout)
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError, queue.Empty):
                    req.cancelled.set()

            def do_POST(self):
                if self.path != "/tts":
                    self._send(404, "application/json", b'{"error":"not found"}')
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._send(400, "application/json", b'{"error":"invalid JSON"}')
                    return
                if payload.get("stream"):
                    req = server_self.handle_tts_stream(payload)
                    try:
                        self._stream(req)
                    finally:
                        req.span.end(cancelled=req.cancelled.is_set())
                    return
                self._send(*server_self.handle_tts(payload))

        return Handler

    def _bind(self) -> ThreadingHTTPServer:
        httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        self._httpd = httpd
        self.port = httpd.server_address[1]  # the bound port (port 0 picks a free one)
        return httpd

    def serve_forever(self):
        httpd = self._bind()
        self._worker.start()
        httpd.serve_forever()

    def start_background(self):
        httpd = self._bind()
        self._worker.start()
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self, join_timeout_s: float = 120.0):
        self._stop.set()
        if hasattr(self, "_httpd"):
            self._httpd.shutdown()
            self._httpd.server_close()  # release the listening socket
        # Join the worker, which polls the queue at <= 0.2 s, so nothing is
        # left running on the card when this returns.
        if self._worker.is_alive():
            self._worker.join(timeout=join_timeout_s)


class _DecodeJob:
    """A non-streaming group: one engine segment per advance; vocoded and
    answered at finish."""

    def __init__(self, srv, reqs, parsed, pipe, it, prefix, setup_s):
        self.srv, self.reqs, self.parsed = srv, reqs, parsed
        self.pipe, self.it, self.prefix = pipe, it, prefix
        self.result = None
        self.compute_s = setup_s

    def advance(self) -> bool:
        t0 = time.monotonic()
        try:
            with tracing.phase("decode_segment", rids=[r.rid for r in self.reqs]):
                self.result = next(self.it)
            return False
        except StopIteration:
            return True
        finally:
            self.compute_s += time.monotonic() - t0

    def finish(self) -> None:
        self.srv._finish_decode_job(self)

    def fail(self, e: Exception) -> None:
        self.it.close()
        self.srv._replay_or_fail(self.reqs, e)


class _StreamJob:
    """A streaming request: one vocoded chunk per advance onto the HTTP
    thread's queue, cut at the request's budget; None ends it."""

    def __init__(self, srv, req, pipe, stream, budget):
        self.srv, self.req, self.pipe = srv, req, pipe
        self.stream, self.budget, self.sent = stream, budget, 0

    def advance(self) -> bool:
        if self.req.cancelled.is_set():
            return True  # the client went away: stop decoding
        with tracing.span("stream_segment", rid=self.req.rid, parent=self.req.span) as seg:
            t0 = time.monotonic()
            try:
                chunk = next(self.stream)
            except StopIteration:
                return True
            finally:
                with self.srv.metrics.lock:
                    self.srv.metrics.compute_seconds_total += time.monotonic() - t0
            pcm = chunk[0]
            take = min(self.budget - self.sent, pcm.shape[-1])
            if take <= 0:
                return True
            data = (np.clip(pcm[:take], -1.0, 1.0) * 32767.0).astype(np.int16)
            self.req.stream_q.put(data.tobytes())
            self.sent += take
            seg.set(frames=take // self.pipe.dac.hop)
        return False

    def finish(self) -> None:
        self.stream.close()  # an early end gives the engine's cache entry back
        with self.srv.metrics.lock:
            self.srv.metrics.audio_seconds_total += self.sent / self.pipe.dac.sampling_rate
        self.req.stream_q.put(None)

    def fail(self, e: Exception) -> None:
        self.stream.close()
        with self.srv.metrics.lock:
            self.srv.metrics.errors_total += 1
        self.req.stream_q.put(("error", _error(500, f"TTS stream failed: {e}")))
        self.req.stream_q.put(None)


class _PoolJob:
    """The continuous-batching pool as a scheduler job: admitted requests
    prefill alone and join a slot; each advance steps the pool one segment
    and answers the rows whose EOS cascade ended. It stays in the job list
    while a row is active."""

    # Streaming rows are vocoded in one fixed window of code frames with
    # ``stream_margin`` frames of context on both sides
    # (``engine/pool.make_pool_emit``), so chunks concatenate to the one-shot
    # vocode of the same codes away from the final margin.
    VOCODE_WIN = 128

    def __init__(self, srv: TTSServer, model_name: str = "default"):
        from ..engine import pool as plib

        self.srv = srv
        self.plib = plib
        self.pipe = srv.pipelines[model_name]
        self.pc = plib.PoolConfig(slots=srv.pool_slots)
        hybrid = self.pipe.model.config.backbone.is_hybrid
        self.kv_int8 = bool(srv.pool_kv_int8 and not hybrid)  # transformer caches only
        self.state_bf16 = bool(srv.pool_state_bf16 and hybrid)  # hybrid state only
        self.pool = self._fresh_pool()
        self.rows: dict[int, dict] = {}  # slot -> row
        self.scheduled = False
        self._emit_fn = None

    def _fresh_pool(self):
        # The cache takes the activations' dtype, from the never-quantized
        # prefix conditioner (a quantized tree holds fp32 scales too).
        return self.plib.make_pool(self.pipe.model, self.pc,
                                   _first_tensor(self.pipe.params["prefix_conditioner"]).dtype,
                                   kv_int8=self.kv_int8,
                                   state_bf16=self.state_bf16, device=self.pipe.device)

    def admit(self, req: _Request, r: dict, jobs: list) -> bool:
        slot = next((i for i in range(self.pc.slots) if i not in self.rows), None)
        if slot is None:
            req.span.set(reason="pool_full")
            tracing.count("pool_full_fallbacks")
            return False
        t0 = time.monotonic()
        pipe = self.pipe
        dev = pipe.device
        with tracing.span("admit", rid=req.rid, parent=req.span, slot=slot):
            cd = pipe.make_cond_dict(**r["cond_kwargs"])
            pad_len = self.srv._cond_bucket(int(cd["espeak"].shape[1]))
            if pad_len > self.pc.max_cond_len:
                req.span.set(reason="ineligible")
                return False  # longer than the pool's geometry: the job path
            cond = pipe.merge_cond_dicts([cd], pad_len=pad_len)
            with tracing.span("conditioning", device=dev):
                prefix_cond = pipe.prepare_conditioning(cond)
            gen = self.srv._generator(pipe, r["seed"])
            prefix = r["prefix_codes"]
            prefix_frames = int(prefix.shape[-1]) if prefix is not None else 0
            # The request's own (bucketed) budget, so a short request frees
            # its slot early.
            mnt = min(self.srv._bucket(r["max_new_tokens"]),
                      self.pc.max_new_tokens - prefix_frames)
            with tracing.span("prefill", device=dev):
                req_state, knobs = self.plib.prefill_request(
                    pipe.model, pipe.params, prefix_cond, gen, mnt, r["cfg_scale"],
                    r["sampling"], kv_int8=self.kv_int8, state_bf16=self.state_bf16,
                    audio_prefix_codes=prefix)
            row_seed = request_seed(r["seed"], self.srv._req_counter)
            with tracing.span("join", device=dev):
                self.plib.join(self.pool, req_state, slot, prefix_cond.shape[1], row_seed,
                               knobs)
        req.span.set(path="pool")
        self.rows[slot] = {"req": req, "r": r, "t0": t0, "emitted": 0, "sent": 0,
                           "prefix_frames": prefix_frames}
        with self.srv.metrics.lock:
            self.srv.metrics.pool_admitted += 1
        tracing.log_event("pool_admit", slot=slot,
                          queue_wait_ms=round((t0 - req.enqueued_at) * 1000, 1),
                          admit_ms=round((time.monotonic() - t0) * 1000, 1))
        if not self.scheduled:
            jobs.append(self)
            self.scheduled = True
        return True

    @property
    def _margin(self) -> int:
        return self.srv.stream_margin

    def _vocode_span(self, codes, start: int, end: int, avail: int) -> np.ndarray:
        """Vocode code frames ``[start, end)`` with ``margin`` frames of
        context on both sides, in fixed windows of ``VOCODE_WIN`` frames
        (zero codes past ``avail``); a span longer than one window's emit
        capacity takes several."""
        hop, m, W = self.pipe.dac.hop, self._margin, self.VOCODE_WIN
        emit_cap = W - 2 * m
        out = []
        s = start
        while s < end:
            e = min(end, s + emit_cap)
            c1 = min(avail, e + m)
            c0 = max(0, c1 - W)
            win = torch.zeros((1, codes.shape[0], W), dtype=torch.long, device=self.pipe.device)
            win[0, :, : c1 - c0] = codes[:, c0:c1]
            with tracing.span("vocode", device=self.pipe.device), torch.inference_mode():
                wav = self.pipe.dac.decode(self.pipe.dac_params, win)[0, 0]
            with tracing.span("read"):
                wav = wav.float().cpu().numpy()
            off = (s - c0) * hop
            out.append(wav[off: off + (e - s) * hop])
            s = e
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _stream_progress(self, slot: int, final: bool, pre=None) -> None:
        """Ship a streaming row's newly stable frames as one PCM chunk (the
        tail at its end; the emit program covers the steady state)."""
        row = self.rows[slot]
        codes, valid = pre if pre is not None else self.plib.extract_row(
            self.pipe.model, self.pool, slot)
        valid = min(valid, row["r"]["max_new_tokens"] + row["prefix_frames"])
        stable = valid if final else max(0, valid - self._margin)
        if stable > row["emitted"]:
            if codes is None:  # the caller knew only the counter
                codes, _ = self.plib.extract_row(self.pipe.model, self.pool, slot)
            pcm = self._vocode_span(codes, row["emitted"], stable, valid)
            data = (np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16)
            row["req"].stream_q.put(data.tobytes())
            row["emitted"] = stable
            row["sent"] += pcm.shape[-1]

    @property
    def _emit(self):
        """The fused emit (``engine/pool.make_pool_emit``), made once."""
        if self._emit_fn is None:
            self._emit_fn = self.plib.make_pool_emit(self.pipe.model, self.pipe.dac.model,
                                                     self._margin, self.VOCODE_WIN)
        return self._emit_fn

    def advance(self) -> bool:
        with tracing.phase("pool_segment") as seg:
            return self._advance(seg)

    def _advance(self, seg) -> bool:
        t0 = time.monotonic()
        dev = self.pipe.device
        with tracing.span("steps") as sp:
            n = self.plib.pool_steps(self.pipe.model, self.pipe.params, self.pool, self.srv.seed,
                                     self.srv.segment_steps)
            sp.set(n=n)
        t_steps = time.monotonic() - t0
        # A cancelled stream frees its slot before the read (never decode
        # for a client that went away).
        stream_slots = []
        for slot, row in list(self.rows.items()):
            if row["req"].stream_q is None:
                continue
            if row["req"].cancelled.is_set():
                self.rows.pop(slot)
                self.plib.release_row(self.pool, slot)
            else:
                stream_slots.append(slot)
        # One read of the card per segment: with streaming rows the emit
        # program vocodes every row's newly stable span to int16 PCM on the
        # card, and the chunks come back with the counters.
        t1 = time.monotonic()
        out = None
        if stream_slots:
            S = self.pc.slots
            emitted = torch.zeros((S,), dtype=torch.long)
            mnt_cap = torch.full((S,), self.pc.max_new_tokens, dtype=torch.long)
            for slot, row in self.rows.items():
                emitted[slot] = row["emitted"]
                mnt_cap[slot] = row["r"]["max_new_tokens"] + row["prefix_frames"]
            with tracing.span("emit", device=dev):
                emit = self._emit(self.pipe.dac_params, self.pool, emitted.to(dev),
                                  mnt_cap.to(dev))
            with tracing.span("read"):
                out = {k: v.cpu().numpy() for k, v in emit.items()}
            active, remaining = out["active"], out["remaining"]
        else:
            with tracing.span("read"):
                active, remaining = (t.numpy() for t in torch.stack(
                    [self.pool["active"].long(), self.pool["remaining"]]).cpu())
        t_read = time.monotonic() - t1
        with self.srv.metrics.lock:
            self.srv.metrics.compute_seconds_total += time.monotonic() - t0

        hop = self.pipe.dac.hop
        shipped = {}  # streaming slot -> (its row, frames shipped before this segment)
        for slot in stream_slots:
            row = self.rows[slot]
            shipped[slot] = (row, row["emitted"])
            take = int(out["new_emitted"][slot]) - row["emitted"]
            if take > 0:
                row["req"].stream_q.put(out["pcm"][slot, : take * hop].tobytes())
                row["emitted"] += take
                row["sent"] += take * hop

        done_slots = [s for s in list(self.rows) if active[s] and remaining[s] <= 0]
        for slot in done_slots:
            streaming = self.rows[slot]["req"].stream_q is not None
            pre = None
            if out is not None and streaming and self.rows[slot]["emitted"] >= int(out["valid"][slot]):
                pre = (None, int(out["valid"][slot]))  # every frame already shipped
            self._finish_row(slot, pre=pre)
        # One record per streaming row: the frames it got this segment (the
        # tail of a row that finished included).
        for slot, (row, before) in shipped.items():
            tracing.mark("chunk", rid=row["req"].rid, slot=slot, frames=row["emitted"] - before,
                         valid=int(out["valid"][slot]), emitted=row["emitted"],
                         final=slot in done_slots)

        seg.set(rows=len(self.rows), streams=len(stream_slots), finished=len(done_slots),
                steps=n)
        tracing.log_event("pool_segment", steps_ms=round(t_steps * 1000, 1),
                          read_ms=round(t_read * 1000, 1), streams=len(stream_slots),
                          finished=len(done_slots), rows=len(self.rows))
        if not self.rows:
            self.scheduled = False
            return True  # leaves the job list until the next admit
        return False

    def _finish_row(self, slot: int, pre=None) -> None:
        # The row stays in self.rows until it is answered, so a failure
        # while vocoding still replays it through fail().
        row = self.rows[slot]
        req, r, t0 = row["req"], row["r"], row["t0"]
        sr = self.pipe.dac.sampling_rate
        if req.stream_q is not None:
            self._stream_progress(slot, final=True, pre=pre)  # the withheld tail
            with self.srv.metrics.lock:
                self.srv.metrics.audio_seconds_total += row["sent"] / sr
                self.srv.metrics.pooled_requests += 1
            req.stream_q.put(None)
            self.rows.pop(slot)
            self.plib.release_row(self.pool, slot)
            tracing.log_event("tts_pool_stream_done", slot=slot, frames=row["emitted"],
                              wall_s=round(time.monotonic() - t0, 3))
            return
        codes, valid = self.plib.extract_row(self.pipe.model, self.pool, slot)
        frames = min(valid, r["max_new_tokens"] + row["prefix_frames"])
        if frames > 0:
            # Vocoded at the bucketed length and trimmed, as in JAX (the
            # decoder is non-causal: the tail's samples see the zero pad).
            padded = torch.zeros((1, codes.shape[0], self.srv._bucket(frames)), dtype=torch.long,
                                 device=self.pipe.device)
            padded[0, :, :frames] = codes[:, :frames]
            wav = self.pipe.decode_audio(padded)[0][: frames * self.pipe.dac.hop]
        else:
            wav = np.zeros((self.pipe.dac.hop,), np.float32)
        # Metrics before done.set(): the client may read /metrics at once.
        with self.srv.metrics.lock:
            self.srv.metrics.audio_seconds_total += wav.shape[-1] / sr
            self.srv.metrics.pooled_requests += 1
        req.response = (200, "audio/wav", wav_bytes(wav, sr))
        req.done.set()
        self.rows.pop(slot)
        self.plib.release_row(self.pool, slot)
        tracing.log_event("tts_pool_row_done", slot=slot, frames=frames,
                          wall_s=round(time.monotonic() - t0, 3))

    def fail(self, e: Exception) -> None:
        rows = list(self.rows.values())
        self.rows.clear()
        self.scheduled = False
        self.pool = self._fresh_pool()
        # A stream cannot replay (chunks went out): it gets the error; the
        # other rows replay.
        err = _error(500, f"TTS stream failed: {e}")
        solo = []
        for row in rows:
            req = row["req"]
            if req.stream_q is not None:
                with self.srv.metrics.lock:
                    self.srv.metrics.errors_total += 1
                req.stream_q.put(("error", err))
                req.stream_q.put(None)
            else:
                solo.append(req)
        if solo:
            self.srv._replay_or_fail(solo, e)

    def finish(self) -> None:
        pass  # rows are answered inside advance()


def _first_tensor(tree):
    """The first tensor of a parameter tree, in insertion order."""
    if isinstance(tree, torch.Tensor):
        return tree
    for v in (tree.values() if isinstance(tree, dict) else tree):
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def main(argv: list[str] | None = None) -> None:
    """Server entry point. Without a checkpoint the flagship transformer's
    shapes get random weights (and the DAC random ones), so the whole
    serving stack runs anywhere; on the card unless ``--device cpu``."""
    import argparse

    ap = argparse.ArgumentParser(description="zonos TTS server (PyTorch port)")
    ap.add_argument("--config", default=None, help="checkpoint config.json")
    ap.add_argument("--weights", default=None, help="model.safetensors")
    ap.add_argument("--hybrid-config", default=None,
                    help="optional second checkpoint served as model=hybrid")
    ap.add_argument("--hybrid-weights", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=50.0)
    ap.add_argument("--warmup", action="store_true",
                    help="capture the default request shapes' decode graphs before serving")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only backbone and heads (either backbone)")
    ap.add_argument("--int4-mlp", action="store_true",
                    help="MLP weights as packed int4 in 128-row groups, the rest int8 "
                         "(every pipeline; takes precedence over --int8)")
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="accepted for the JAX server's command line and ignored: the port "
                         "compiles no programs (CUDA graphs are captured in the process, "
                         "its kernels built once under build/)")
    ap.add_argument("--heartbeat-interval-s", type=float, default=0.0,
                    help="heartbeat monitor over the process group (a one-rank group without "
                         "one): /healthz answers 503 once a probe fails (0 = off)")
    ap.add_argument("--pooled", action="store_true",
                    help="continuous batching: staggered requests share one decode pool")
    ap.add_argument("--pool-slots", type=int, default=4)
    ap.add_argument("--pool-kv-int8", action="store_true",
                    help="pooled KV prefixes as int8 with per-token scales (transformer pools)")
    ap.add_argument("--pool-state-bf16", action="store_true",
                    help="pooled Mamba SSM state stored in bf16, fp32 compute (hybrid pools)")
    args = ap.parse_args(argv)

    from ..pipeline import ZonosPipeline

    def load(config, weights, seed):
        pipe = ZonosPipeline.from_local(config, weights, device=args.device)
        tracing.log_event("server_random_dac", reason="no DAC checkpoint is loaded")
        pipe.dac_params = pipe.dac.init(torch.Generator(pipe.device).manual_seed(seed),
                                        pipe.device)
        return pipe

    if args.config and args.weights:
        pipeline = load(args.config, args.weights, 0)
    else:
        from ..config import ZONOS_V01_TRANSFORMER

        tracing.log_event("server_random_init", reason="no checkpoint given")
        pipeline = ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER, device=args.device)
    extra = None
    if args.hybrid_config and args.hybrid_weights:
        extra = {"hybrid": load(args.hybrid_config, args.hybrid_weights, 1)}
    for p in [pipeline, *(extra or {}).values()]:
        if args.int4_mlp:
            p.quantize_int4(mixed=True)
        elif args.int8:
            p.quantize_int8()

    monitor = None
    if args.heartbeat_interval_s > 0:
        from ..parallel.multihost import Heartbeat, HeartbeatMonitor

        monitor = HeartbeatMonitor(
            Heartbeat().probe, interval_s=args.heartbeat_interval_s,
            on_failure=lambda r: tracing.log_event("heartbeat_failure", reason=r)).start()

    srv = TTSServer(
        pipeline, host=args.host, port=args.port, max_batch=args.max_batch,
        batch_window_s=args.batch_window_ms / 1000.0, monitor=monitor, extra_pipelines=extra,
        pooled=args.pooled, pool_slots=args.pool_slots, pool_kv_int8=args.pool_kv_int8,
        pool_state_bf16=args.pool_state_bf16)
    if args.warmup:
        tracing.log_event("warmup_start")
        n = srv.warmup()
        tracing.log_event("warmup_done", combos=n)
    tracing.log_event("server_listening", host=args.host, port=args.port)
    srv.serve_forever()


if __name__ == "__main__":
    main()
