"""The port's HTTP server (``zonos_vibes_tpu_torch/serve/server.py``) on the
CPU: tests/test_pipeline_server.py's cases where they apply to the port,
streaming, the graph cache under the server, the command line, and one
greedy request answered by JAX's server and the port's on the same weights.

Tiny fp32 pipelines (two layers of width 64, the tiny DAC and speaker
encoder of tests/test_pipeline_server.py), their weights carried over from
JAX (``params_from_jax``, ``speaker_params_from_jax``). Every server binds
port 0 and reads the port it got.
"""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.request
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_generate import _random_tree
from tests.test_torch_hybrid import _tiny_models
from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.models.autoencoder import DACAutoencoder as JDACAutoencoder
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.speaker import SpeakerEncoder as JSpeakerEncoder
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.pipeline import ZonosPipeline as JPipeline
from zonos_vibes_tpu.serve.server import TTSServer as JTTSServer
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine import pool as plib
from zonos_vibes_tpu_torch.models.autoencoder import DACAutoencoder
from zonos_vibes_tpu_torch.models.dac import DACConfig
from zonos_vibes_tpu_torch.models.speaker import SpeakerEncoder
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.serve import server as tserver
from zonos_vibes_tpu_torch.serve.server import TTSServer, _PoolJob, read_wav, wav_bytes
from zonos_vibes_tpu_torch.utils import tracing
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax, speaker_params_from_jax

DAC = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
           n_codebooks=9, codebook_size=1024, codebook_dim=4)
BB = dict(d_model=64, n_layer=2, attn_mlp_d_intermediate=128)
HEADS = {"num_heads": 4, "num_heads_kv": 2}
PC = {"projection": "linear",
      "conditioners": [
          {"type": "EspeakPhonemeConditioner", "name": "espeak"},
          {"type": "PassthroughConditioner", "name": "speaker", "cond_dim": 16,
           "projection": "linear", "uncond_type": "learned"},
          {"type": "FourierConditioner", "name": "speaking_rate", "min_val": 0, "max_val": 40,
           "uncond_type": "learned"},
          {"type": "IntegerConditioner", "name": "language_id", "min_val": -1, "max_val": 126,
           "uncond_type": "learned"}]}
JCFG = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                   prefix_conditioner=PrefixConditionerConfig.from_dict(PC))
TCFG = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                        prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
SPK = dict(in_planes=4, embd_dim=24, lda_dim=16, depths=(1, 1, 1, 1))
EMO = [0.3, 0.03, 0.03, 0.03, 0.03, 0.03, 0.25, 0.3]
HOP = 8  # the tiny DAC's samples per frame


@pytest.fixture(scope="module")
def weights():
    """numpy weights drawn on the JAX side: ``(model, DAC, speaker)``."""
    np_params = jax.device_get(JModel(JCFG).init(jax.random.key(0), jnp.float32))
    np_dac = _random_tree(jax.eval_shape(
        lambda: JDACAutoencoder(JDACConfig(**DAC)).init(jax.random.key(8))), 8)
    np_spk = _random_tree(jax.eval_shape(
        lambda: JSpeakerEncoder(**SPK).init(jax.random.key(9))), 9)
    return np_params, np_dac, np_spk


def _port_pipe(weights, dtype=torch.float32):
    """The port's pipeline on the carried weights; in bf16, its own init's
    (the JAX pipeline's bf16 layout: conditioner projections stay fp32)."""
    np_params, np_dac, np_spk = weights
    params = (params_from_jax(np_params) if dtype == torch.float32
              else ZonosModel(TCFG).init(torch.Generator().manual_seed(0), dtype))
    return ZonosPipeline(model=ZonosModel(TCFG), params=params, device=torch.device("cpu"),
                         dac=DACAutoencoder(DACConfig(**DAC)), dac_params=params_from_jax(np_dac),
                         speaker_encoder=SpeakerEncoder(**SPK),
                         speaker_params=speaker_params_from_jax(np_spk))


@pytest.fixture(scope="module")
def pipe(weights):
    return _port_pipe(weights)


@pytest.fixture(scope="module")
def hybrid(weights):
    jmodel, tmodel = _tiny_models()
    np_params = jax.device_get(jmodel.init(jax.random.key(5), jnp.float32))
    return ZonosPipeline(model=tmodel, params=params_from_jax(np_params),
                         device=torch.device("cpu"), dac=DACAutoencoder(DACConfig(**DAC)),
                         dac_params=params_from_jax(weights[1]))


def _start(pipe, **kw):
    srv = TTSServer(pipe, host="127.0.0.1", port=0, request_timeout_s=300, **kw)
    srv.start_background()
    return srv


@pytest.fixture(scope="module")
def server(pipe):
    srv = _start(pipe)
    yield srv
    srv.shutdown()


def _url(srv, path="/tts"):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(url, payload, timeout=240):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return r.status, r.read()


def _frames(body: bytes) -> int:
    with wave_mod.open(io.BytesIO(body)) as w:
        assert w.getnchannels() == 1 and w.getframerate() == 44100
        return w.getnframes()


def _write_wav(path, seconds=1.0, sr=16000, f=880):
    wav = (0.1 * np.sin(np.linspace(0, f * np.pi * seconds, int(sr * seconds)))).astype(
        np.float32)
    with open(path, "wb") as fh:
        fh.write(wav_bytes(wav, sr))
    return str(path)


# -- the pipeline's serving helpers ------------------------------------------

def test_pipeline_end_to_end(pipe):
    cond = pipe.make_cond_dict(text="Hi there!", language="en-us", speaking_rate=14.0)
    assert cond["espeak"].dtype == torch.long
    res = pipe.generate(cond, generator=torch.Generator().manual_seed(2), max_new_tokens=6)
    wav = pipe.decode_audio(res)
    assert wav.shape == (1, res.valid_length * HOP) and np.abs(wav).max() <= 1.0


def test_audio_prefix_roundtrip(pipe):
    sr = pipe.dac.sampling_rate
    audio = np.sin(np.linspace(0, 100, sr // 100)).astype(np.float32)
    codes = pipe.encode_audio(audio, sr)
    assert codes.shape[:2] == (1, 9)
    res = pipe.generate(pipe.make_cond_dict(text="continue"), codes,
                        generator=torch.Generator().manual_seed(3), max_new_tokens=4)
    assert torch.equal(res.codes[..., : codes.shape[-1]], codes)


def test_merge_cond_dicts(pipe):
    c1 = pipe.make_cond_dict(text="Hi!", speaking_rate=14.0)
    c2 = pipe.make_cond_dict(text="A much longer sentence here.", speaking_rate=12.0)
    merged = ZonosPipeline.merge_cond_dicts([c1, c2])
    longest = max(c1["espeak"].shape[1], c2["espeak"].shape[1])
    assert merged["espeak"].shape == (2, longest)
    short = c1["espeak"][0]
    assert torch.equal(merged["espeak"][0, -short.shape[0]:], short)  # LEFT-padded
    assert (merged["espeak"][0, : longest - short.shape[0]] == 0).all()
    assert merged["speaking_rate"].shape[0] == 2
    assert ZonosPipeline.merge_cond_dicts([c1], pad_len=64)["espeak"].shape == (1, 64)
    c3 = dict(c1)
    c3.pop("speaking_rate")
    with pytest.raises(ValueError):
        ZonosPipeline.merge_cond_dicts([c1, c3])


def test_merge_and_batch_cond_dicts_equal_jax(pipe, weights):
    """``merge_cond_dicts`` (with a bucket) and ``make_batch_cond_dict``
    against the JAX pipeline's: the same ids, padding and entries."""
    jpipe = JPipeline(model=JModel(JCFG), params=None)
    texts, langs = ["Hi!", "A much longer sentence here."], ["en-us", "de"]
    merged = ZonosPipeline.merge_cond_dicts([pipe.make_cond_dict(text=t) for t in texts], 64)
    jmerged = JPipeline.merge_cond_dicts([jpipe.make_cond_dict(text=t) for t in texts], 64)
    batch = pipe.make_batch_cond_dict(texts, langs, speaking_rate=12.0)
    jbatch = jpipe.make_batch_cond_dict(texts, langs, speaking_rate=12.0)
    for got, want in ((merged, jmerged), (batch, jbatch)):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert batch["language_id"].shape == (2, 1, 1)
    with pytest.raises(ValueError):
        pipe.make_batch_cond_dict(texts, ["en-us"])


def test_generate_callback_aborts_and_returns_what_exists(pipe):
    """The abort hook: called every ``callback_interval`` steps; False stops
    the run, whose codes are the first frames of the full run's."""
    cond = pipe.make_cond_dict(text="Abort me.")
    kw = dict(max_new_tokens=40, sampling_params=SamplingParams(temperature=0.0),
              disable_eos=True)
    full = pipe.generate(cond, generator=torch.Generator().manual_seed(1), **kw)
    calls = []

    def cb(frames, step, max_steps):
        calls.append((frames, step, max_steps))
        return len(calls) < 2

    part = pipe.generate(cond, generator=torch.Generator().manual_seed(1), callback=cb,
                         callback_interval=8, **kw)
    assert [c[1:] for c in calls] == [(8, 40), (16, 40)]
    assert part.steps == 16 and part.valid_length == calls[-1][0] == 16 - 8
    assert torch.equal(part.codes[..., : part.valid_length],
                       full.codes[..., : part.valid_length])
    assert not any(e.busy for e in pipe.engine._entries)  # the aborted run gave its entry back


def test_cond_bucketing_stabilizes_shapes(pipe):
    c1 = pipe.make_cond_dict(text="Two sentences in the same bucket.")
    c2 = pipe.make_cond_dict(text="A rather different and longer text.")
    b = TTSServer._cond_bucket
    assert b(int(c1["espeak"].shape[1])) == b(int(c2["espeak"].shape[1])) == 64
    assert int(c1["espeak"].shape[1]) != int(c2["espeak"].shape[1])
    p1 = pipe.prepare_conditioning(ZonosPipeline.merge_cond_dicts([c1], pad_len=64))
    p2 = pipe.prepare_conditioning(ZonosPipeline.merge_cond_dicts([c2], pad_len=64))
    assert p1.shape == p2.shape
    assert [TTSServer._bucket(n) for n in (1, 215, 216, 2580, 3000)] == [215, 215, 430, 2580,
                                                                        3000]


def test_language_case_insensitive(pipe):
    assert "espeak" in pipe.make_cond_dict(text="Hi", language="EN-US")
    with pytest.raises(ValueError):
        pipe.make_cond_dict(text="Hi", language="xx-zz")


def test_short_speaker_audio(pipe):
    for n in (50, 300, 1000):
        wav = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        emb = pipe.make_speaker_embedding(wav, 16000)
        assert emb.shape == (1, 1, 16) and torch.isfinite(emb.float()).all()


def test_wav_roundtrip(tmp_path):
    sr = 8000
    wav = (0.5 * np.sin(np.linspace(0, 100, 800))).astype(np.float32)
    path = str(tmp_path / "x.wav")
    with open(path, "wb") as f:
        f.write(wav_bytes(wav, sr))
    back, sr2 = read_wav(path)
    assert sr2 == sr and back.shape == (1, 800)
    np.testing.assert_allclose(back[0], wav, atol=1e-3)


def test_tracing_phases_counters_and_trace(tmp_path):
    tracing.reset()
    with tracing.phase("a"):
        with tracing.phase("b", annotate_trace=False):
            pass
    tracing.add_counter("audio_seconds", 2.0)
    snap = tracing.timings_snapshot()
    assert snap["a"]["count"] == snap["b"]["count"] == 1
    assert tracing.counters_snapshot() == {"audio_seconds": 2.0}
    assert tracing.rtf_report()["audio_seconds"] == 2.0
    tracing.start_trace(str(tmp_path))
    with tracing.phase("traced"):
        torch.ones(8).sum()
    path = tracing.stop_trace()
    assert "traced" in open(path).read()
    tracing.reset()
    assert tracing.timings_snapshot() == {}


# -- the server: contract, errors, surface -----------------------------------

def test_server_tts_contract(server, tmp_path):
    spk_path = _write_wav(tmp_path / "spk.wav")
    status, ctype, body = _post(_url(server), {"text": "Hello from the test.",
                                               "speaker_audio_path": spk_path,
                                               "speaking_rate": 14.0, "max_new_tokens": 6})
    assert status == 200, body[:200]
    assert ctype == "audio/wav" and 0 < _frames(body) <= 6 * HOP
    status2, _, _ = _post(_url(server), {"text": "Second request.",
                                         "speaker_audio_path": spk_path, "max_new_tokens": 6})
    assert status2 == 200
    assert ("default", spk_path) in server._spk_cache


def test_server_errors(server):
    status, _, body = _post(_url(server), {"text": ""})
    assert status == 400 and b"text" in body
    status, _, _ = _post(_url(server), {"text": "x", "speaker_audio_path": "/does/not/exist.wav"})
    assert status == 404
    status, _, body = _post(_url(server), {"text": "x"})  # no speaker, not a UI payload
    assert status == 400 and b"speaker_audio_path" in body
    req = urllib.request.Request(_url(server), data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert e.value.code == 404


def test_server_health_metrics(server):
    _post(_url(server), {"text": "Count me.", "emotion": EMO, "max_new_tokens": 6})
    assert json.loads(_get(server, "/healthz")[1])["status"] == "ok"
    m = json.loads(_get(server, "/metrics")[1])
    assert m["requests_total"] >= 1 and "rtf" in m and "generate" in m["phases"]


def test_model_info_endpoint(server):
    info = json.loads(_get(server, "/model-info")[1])
    assert info["models"] == ["default"]
    assert "espeak" in info["conditioners"] and "speaker" in info["conditioners"]
    assert "dnsmos_ovrl" not in info["conditioners"]


def test_webui_served(server):
    body = _get(server, "/")[1].decode()
    assert "zonos-tpu" in body and "speaking_rate" in body and "en-us" in body


def test_extended_ui_payload(server):
    status, ctype, body = _post(_url(server), {
        "text": "Full controls.", "language": "en-us", "emotion": EMO,
        "vqscore_8": [0.78] * 8, "fmax": 22050, "pitch_std": 30, "speaking_rate": 14,
        "dnsmos_ovrl": 4.0, "speaker_noised": False, "cfg_scale": 2.0, "seed": 123,
        "sampling": {"linear": 0.5, "conf": 0.4, "quad": 0.0, "top_p": 0, "top_k": 0,
                     "min_p": 0},
        "max_new_tokens": 6, "unconditional_keys": ["vqscore_8", "dnsmos_ovrl"]})
    assert status == 200 and ctype == "audio/wav", body[:300]


def test_explicit_seed_isolates_batch_group(pipe):
    srv = TTSServer(pipe, host="127.0.0.1", port=0)  # never started
    base = {"text": "x", "emotion": [0.3] * 8, "max_new_tokens": 6}
    g_none_a = srv._parse(dict(base))["group"]
    g_none_b = srv._parse(dict(base))["group"]
    g_s1 = srv._parse({**base, "seed": 1})["group"]
    g_s2 = srv._parse({**base, "seed": 2})["group"]
    assert g_none_a == g_none_b
    assert g_s1 != g_s2 != g_none_a
    assert tserver.request_seed(420, 1) == (420 * 1000003 + 1) % 2 ** 31


def test_server_prefix_audio_continuation(server, tmp_path):
    pre_path = _write_wav(tmp_path / "prefix.wav", seconds=0.2, sr=44100, f=440)
    status, ctype, body = _post(_url(server), {"text": "Continue the sound.", "emotion": EMO,
                                               "prefix_audio_path": pre_path,
                                               "max_new_tokens": 6})
    assert status == 200 and ctype == "audio/wav", body[:200]
    assert _frames(body) > 6 * HOP  # the prefix's frames and the continuation's
    assert ("prefix", "default", pre_path) in server._spk_cache
    status, _, _ = _post(_url(server), {"text": "x", "emotion": EMO,
                                        "prefix_audio_path": "/nonexistent/prefix.wav"})
    assert status == 404


def test_server_base64_audio_upload(server):
    sr = 16000
    wav = (0.1 * np.sin(np.linspace(0, 880 * np.pi, sr))).astype(np.float32)
    b64 = base64.b64encode(wav_bytes(wav, sr)).decode()
    status, ctype, body = _post(_url(server), {"text": "Uploaded speaker.",
                                               "speaker_audio": b64, "max_new_tokens": 6})
    assert status == 200 and ctype == "audio/wav" and len(body) > 44, body[:200]
    status2, _, _ = _post(_url(server), {"text": "Again.", "speaker_audio": b64,
                                         "max_new_tokens": 6})
    assert status2 == 200
    assert len([k for k in server._spk_cache if "spk-b64" in k]) == 1
    status3, _, body3 = _post(_url(server), {"text": "Continue this.", "prefix_audio": b64,
                                             "emotion": EMO, "max_new_tokens": 6})
    assert status3 == 200, body3[:200]
    status4, _, body4 = _post(_url(server), {"text": "x", "speaker_audio": "!!!not-base64!!!"})
    assert status4 == 400 and b"speaker_audio" in body4


def test_server_streaming(server):
    """A streaming request: a WAV header, then PCM chunks whose samples
    equal the one-shot response's for the same explicit seed (the first
    request's counter differs from the second's, so each runs on its own
    seed: greedy sampling makes them comparable)."""
    payload = {"text": "Stream this one.", "emotion": EMO, "max_new_tokens": 60, "seed": 7,
               "sampling": {"temperature": 0}}
    status, ctype, body = _post(_url(server), {**payload, "stream": True})
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF" and body[40:44] == b"\xff\xff\xff\xff"
    streamed = np.frombuffer(body[44:], np.int16)
    status, _, one = _post(_url(server), payload)
    assert status == 200
    with wave_mod.open(io.BytesIO(one)) as w:
        want = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert streamed.shape == want.shape == (60 * HOP,)
    assert np.abs(streamed.astype(np.int32) - want).max() <= 1


def test_warmup_captures_once_and_requests_hit_the_cache(pipe):
    """``warmup`` runs the segment path at the combo's shapes; a request in
    the same buckets then reuses that cache entry (no new entry: on the
    card, no capture) and answers 200."""
    srv = TTSServer(pipe, host="127.0.0.1", port=0, request_timeout_s=300)
    assert srv.warmup([(1, 32, 6, True), (2, 32, 6, False)]) == 2
    assert pipe.speaker_shape() == (1, 1, 16)
    engine = pipe.engine
    misses, hits = engine.misses, engine.hits
    srv.warmup([(1, 32, 6, True)])
    assert (engine.misses, engine.hits) == (misses, hits + 1)
    srv.start_background()
    try:
        text = "Short text."  # fits the 32 bucket
        assert TTSServer._cond_bucket(pipe.make_cond_dict(text=text)["espeak"].shape[1]) == 32
        # The warmup's combo (1, 32, 215, with a speaker) is the bucketed
        # shape of this request: max_new_tokens 6 -> 215.
        srv.warmup([(1, 32, 215, True)])
        misses = engine.misses
        spk = torch.zeros(pipe.speaker_shape(), dtype=torch.bfloat16)
        srv._spk_cache[("default", "/warm/speaker.wav")] = spk
        status, _, _ = _post(_url(srv), {"text": text, "speaker_audio_path": "/warm/speaker.wav",
                                         "max_new_tokens": 6})
        assert status == 200
        assert engine.misses == misses
    finally:
        srv.shutdown()


# -- batching, load, scheduling ----------------------------------------------

def test_server_request_batching(pipe):
    srv = _start(pipe, max_batch=4, batch_window_s=2.0)
    try:
        results = {}

        def post(name, text):
            results[name] = _post(_url(srv), {"text": text, "max_new_tokens": 6, "emotion": EMO})

        threads = [threading.Thread(target=post, args=("a", "Short one.")),
                   threading.Thread(target=post,
                                    args=("b", "This is a somewhat longer request text."))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        for name in ("a", "b"):
            status, ctype, body = results[name]
            assert status == 200 and ctype == "audio/wav" and len(body) > 44, body[:200]
        assert srv.metrics.snapshot()["batched_requests"] >= 1
    finally:
        srv.shutdown()


class _Monitor:
    healthy = True


def test_server_replay_and_healthz(pipe):
    """A failed decode group is enqueued again once; an unhealthy monitor
    turns /healthz to 503."""
    mon = _Monitor()
    srv = TTSServer(pipe, host="127.0.0.1", port=0, request_timeout_s=300, monitor=mon,
                    max_retries=1)
    real_stream = pipe.engine.generate_stream
    calls = {"n": 0}

    def flaky_stream(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device failure")
        return real_stream(*a, **kw)

    srv.pipeline = _FlakyPipeline(pipe, flaky_stream)
    srv.pipelines["default"] = srv.pipeline
    srv.start_background()
    try:
        status, _, body = _post(_url(srv), {"text": "Replay me.", "max_new_tokens": 6,
                                            "emotion": EMO})
        assert status == 200, body[:200]
        assert calls["n"] == 2
        assert srv.metrics.snapshot()["replayed_requests"] == 1
        assert _get(srv, "/healthz")[0] == 200
        mon.healthy = False
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(srv, "/healthz"), timeout=10)
        assert e.value.code == 503
    finally:
        srv.shutdown()


class _FlakyEngine:
    def __init__(self, inner, stream):
        self._inner, self._stream = inner, stream

    def generate_stream(self, *a, **kw):
        return self._stream(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _FlakyPipeline:
    def __init__(self, inner, stream):
        self._inner = inner
        self.engine = _FlakyEngine(inner.engine, stream)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_server_concurrent_load(pipe):
    """Mixed valid and invalid concurrent requests: each gets exactly one
    answer and the metrics stay consistent."""
    srv = _start(pipe, max_batch=4, batch_window_s=0.2)
    try:
        results = {}

        def post(i):
            payload = ({"text": ""} if i % 3 == 2 else
                       {"text": f"Concurrent request number {i}.", "max_new_tokens": 6,
                        "emotion": EMO})
            results[i] = _post(_url(srv), payload)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert len(results) == 9
        for i, (status, ctype, body) in results.items():
            if i % 3 == 2:
                assert status == 400, (i, body[:100])
            else:
                assert status == 200 and ctype == "audio/wav" and len(body) > 44, (i, body[:200])
        m = srv.metrics.snapshot()
        assert m["requests_total"] == 9 and m["errors_total"] == 0
        assert m["batched_requests"] >= 1
    finally:
        srv.shutdown()


def test_server_multi_model(pipe, hybrid):
    srv = _start(pipe, extra_pipelines={"hybrid": hybrid})
    try:
        info = json.loads(_get(srv, "/model-info")[1])
        assert info["models"] == ["default", "hybrid"]
        assert "espeak" in info["conditioners_by_model"]["hybrid"]
        status, ctype, body = _post(_url(srv), {"text": "Hybrid please.", "model": "hybrid",
                                                "max_new_tokens": 6, "emotion": EMO})
        assert status == 200 and ctype == "audio/wav", body[:200]
        status, _, body = _post(_url(srv), {"text": "x", "model": "nope"})
        assert status == 400 and b"Unknown model" in body
    finally:
        srv.shutdown()


def test_segment_interleaving_no_head_of_line_blocking(pipe):
    """A short request posted while a long one decodes finishes first: jobs
    advance one segment at a time, round robin."""
    srv = _start(pipe, segment_steps=8)
    done_at = {}

    def post(name, mnt):
        status, _, _ = _post(_url(srv), {"text": f"{name} request.", "max_new_tokens": mnt,
                                         "emotion": EMO, "seed": 1 if name == "long" else 2})
        done_at[name] = time.monotonic()
        assert status == 200

    try:
        post("long", 256)  # both shapes' cache entries exist before the race
        post("short", 8)
        done_at.clear()
        t_long = threading.Thread(target=post, args=("long", 256))
        t_long.start()
        time.sleep(0.3)
        t_short = threading.Thread(target=post, args=("short", 8))
        t_short.start()
        t_short.join(timeout=240)
        t_long.join(timeout=240)
        assert done_at["short"] < done_at["long"]
    finally:
        srv.shutdown()


# -- the pool ------------------------------------------------------------------

def test_pooled_server_staggered_requests(pipe):
    srv = _start(pipe, pooled=True, pool_slots=2, segment_steps=6)
    results = {}

    def post(name, text):
        status, ctype, body = _post(_url(srv), {"text": text, "max_new_tokens": 10,
                                                "emotion": EMO})
        results[name] = (status, ctype, len(body))

    try:
        t1 = threading.Thread(target=post, args=("a", "First pooled request."))
        t1.start()
        time.sleep(0.5)
        t2 = threading.Thread(target=post, args=("b", "Second pooled one."))
        t2.start()
        t1.join(timeout=240)
        t2.join(timeout=240)
        assert results["a"][:2] == results["b"][:2] == (200, "audio/wav")
        assert srv.metrics.snapshot()["pooled_requests"] == 2
        # Custom knobs are per-row runtime values: this request pools too.
        status, _, _ = _post(_url(srv), {"text": "Custom knobs request.", "max_new_tokens": 6,
                                         "sampling": {"min_p": 0.2}, "cfg_scale": 3.0,
                                         "emotion": EMO})
        assert status == 200 and srv.metrics.snapshot()["pooled_requests"] == 3
        # A repetition window past the pool's bound takes the job path.
        status, _, _ = _post(_url(srv), {"text": "Job path request.", "max_new_tokens": 6,
                                         "sampling": {"repetition_penalty_window": 64},
                                         "emotion": EMO})
        assert status == 200 and srv.metrics.snapshot()["pooled_requests"] == 3
        assert srv.metrics.snapshot()["pool_admit_failures"] == 0
    finally:
        srv.shutdown()


def test_pooled_server_hybrid_requests_and_streams(pipe, hybrid):
    """Per-model pools: staggered hybrid rows in the hybrid pool, a default
    row in the transformer's. Then streaming rows in both pools, their
    chunks vocoded by ``make_pool_emit``: each stream, beside a greedy
    request with the same seed in the same pool, concatenates to that
    request's answer (fp32 convolutions over windows of other lengths, of
    samples near full scale: within 4 of 32767)."""
    srv = _start(pipe, extra_pipelines={"hybrid": hybrid}, pooled=True, pool_slots=2,
                 segment_steps=6)
    results = {}

    def post(name, payload):
        results[name] = _post(_url(srv), {"emotion": EMO, **payload})

    def run(jobs, stagger=0.0):
        threads = [threading.Thread(target=post, args=job) for job in jobs]
        for t in threads:
            t.start()
            time.sleep(stagger)
        for t in threads:
            t.join(timeout=240)

    try:
        run([("a", {"text": "First hybrid pooled.", "model": "hybrid", "max_new_tokens": 10}),
             ("b", {"text": "Second hybrid pooled.", "model": "hybrid", "max_new_tokens": 10}),
             ("c", {"text": "Transformer pooled.", "max_new_tokens": 10})], stagger=0.3)
        for name in "abc":
            assert results[name][:2] == (200, "audio/wav"), (name, results[name][2][:200])
        assert srv.metrics.snapshot()["pooled_requests"] == 3
        greedy = {"text": "Pooled stream.", "max_new_tokens": 60, "seed": 5,
                  "sampling": {"temperature": 0}}
        run([(f"{model}_{kind}", {**greedy, "model": model, "stream": kind == "stream"})
             for model in ("hybrid", "default") for kind in ("stream", "one")])
        for model in ("hybrid", "default"):
            status, _, body = results[f"{model}_stream"]
            assert status == 200 and body.startswith(b"RIFF"), body[:200]
            streamed = np.frombuffer(body[44:], np.int16)
            status, _, one = results[f"{model}_one"]
            assert status == 200
            with wave_mod.open(io.BytesIO(one)) as w:
                want = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            assert streamed.shape == want.shape == (60 * HOP,)
            assert np.abs(streamed.astype(np.int32) - want).max() <= 4, model
        m = srv.metrics.snapshot()
        assert m["pooled_requests"] == 7 and m["pool_admit_failures"] == 0
        assert m["errors_total"] == 0
    finally:
        srv.shutdown()


def test_pooled_server_kv_int8(pipe, hybrid):
    srv = _start(pipe, extra_pipelines={"hybrid": hybrid}, pooled=True, pool_slots=2,
                 segment_steps=6, pool_kv_int8=True)
    try:
        status, ctype, body = _post(_url(srv), {"text": "Quantized pool request.",
                                                "max_new_tokens": 10, "emotion": EMO})
        assert status == 200 and ctype == "audio/wav" and len(body) > 44
        job = srv._pool_jobs["default"]
        assert job.kv_int8 and job.pool["cache"]["k"].dtype == torch.int8
        assert "k_scale" in job.pool["cache"]
        status, _, _ = _post(_url(srv), {"text": "Hybrid exact pool.", "model": "hybrid",
                                         "max_new_tokens": 10, "emotion": EMO})
        assert status == 200
        hjob = srv._pool_jobs["hybrid"]
        assert not hjob.kv_int8 and "k_scale" not in hjob.pool["cache"]
        assert srv.metrics.snapshot()["pooled_requests"] == 2
    finally:
        srv.shutdown()


def test_pooled_server_state_bf16(pipe, hybrid):
    srv = _start(pipe, extra_pipelines={"hybrid": hybrid}, pooled=True, pool_slots=2,
                 segment_steps=6, pool_state_bf16=True)
    try:
        status, ctype, body = _post(_url(srv), {"text": "Compact state pool.",
                                                "model": "hybrid", "max_new_tokens": 10,
                                                "emotion": EMO})
        assert status == 200 and ctype == "audio/wav" and len(body) > 44
        hjob = srv._pool_jobs["hybrid"]
        assert hjob.state_bf16 and hjob.pool["cache"]["ssm"].dtype == torch.bfloat16
        status, _, _ = _post(_url(srv), {"text": "Transformer ignores the flag.",
                                         "max_new_tokens": 10, "emotion": EMO})
        assert status == 200
        job = srv._pool_jobs["default"]
        assert not job.state_bf16 and job.pool["cache"]["k"].dtype == torch.float32
    finally:
        srv.shutdown()


def test_pooled_server_quantized_bf16_pipeline_admits(weights):
    """On an int8 pipeline with bf16 activations the tree also holds fp32
    scales; the pool's cache takes the activations' dtype, so a bf16
    request's cache rows join it and a pooled segment steps."""
    p = _port_pipe(weights, torch.bfloat16).quantize_int8()
    srv = TTSServer(p, host="127.0.0.1", port=0, pooled=True, pool_slots=2, segment_steps=6)
    job = _PoolJob(srv, "default")
    assert job.pool["cache"]["k"].dtype == torch.bfloat16
    cd = p.make_cond_dict(text="Quantized bf16 pooled request.")
    cond = p.prepare_conditioning(p.merge_cond_dicts([cd], pad_len=32))
    state, knobs = plib.prefill_request(p.model, p.params, cond, torch.Generator(), 8, 2.0,
                                        SamplingParams())
    plib.join(job.pool, state, 0, cond.shape[1], 7, knobs)
    assert plib.pool_steps(p.model, p.params, job.pool, 1, 6) == 6
    assert int(job.pool["step"][0]) == state.offset + 1 + 6


def test_stream_margin_validation(pipe):
    for bad in (0, -3, _PoolJob.VOCODE_WIN // 2, _PoolJob.VOCODE_WIN):
        with pytest.raises(ValueError, match="stream_margin"):
            TTSServer(pipe, port=0, pooled=True, stream_margin=bad)
    TTSServer(pipe, port=0, pooled=True, stream_margin=12)
    TTSServer(pipe, port=0, pooled=False, stream_margin=200)


# -- the command line -------------------------------------------------------

def test_compilation_cache_flag_is_documented_as_ignored(capsys):
    """The JAX server's persistent compilation cache has no counterpart on
    the card; the flag is accepted and its help says so."""
    with pytest.raises(SystemExit):
        tserver.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "--compilation-cache DIR" in out and "ignored" in out
    assert "compiles no programs" in out


@pytest.mark.parametrize("argv,item", [
    pytest.param(["--int4-mlp"], "int4", id="argv0-item 5"),
    pytest.param(["--heartbeat-interval-s", "5"], "item 6", id="argv1-item 6")])
def test_unported_flags_raise(monkeypatch, pipe, hybrid, argv, item):
    """Flags of the JAX server that later slices ported: ``--int4-mlp``
    quantizes every pipeline, as JAX's server does; ``--heartbeat-interval-s``
    (queue 1 item 6, the parallel layer) starts a heartbeat monitor over a
    one-rank group, healthy. The server answers on both."""
    srv = _main_pipelines(monkeypatch, pipe, hybrid, argv)
    if item == "item 6":
        from zonos_vibes_tpu_torch.parallel.multihost import HeartbeatMonitor

        try:
            assert isinstance(srv.monitor, HeartbeatMonitor)
            assert srv.monitor.healthy and srv.monitor.probes_total >= 1
            assert srv.monitor.interval_s == 5.0
        finally:
            srv.monitor.stop()
        return
    for p in srv.pipelines.values():
        layers = p.params["backbone"].get("layers", p.params["backbone"].get("attn"))
        assert "weight_int4" in layers["fc1"] and "weight_int4" in layers["fc2"]
        assert "weight_int8" in layers["in_proj"] and "weight_int8" in p.params["heads"]


def _main_pipelines(monkeypatch, pipe, hybrid, flags):
    """``main`` with a transformer checkpoint and a hybrid one (stand-ins for
    ``from_local``) and ``flags``; the server it builds answers a request
    for each model. Returns the server (shut down)."""
    from zonos_vibes_tpu_torch import pipeline as tpipeline

    built = []
    monkeypatch.setattr(tpipeline.ZonosPipeline, "from_local", classmethod(
        lambda cls, config, *a, **k: dataclasses.replace(hybrid if config == "h.json" else pipe)))
    monkeypatch.setattr(tserver.TTSServer, "serve_forever", lambda self: built.append(self))
    tserver.main(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--config", "c.json",
                  "--weights", "w.safetensors", "--hybrid-config", "h.json", "--hybrid-weights",
                  "h.safetensors", *flags])
    (srv,) = built
    srv.request_timeout_s = 300
    srv.start_background()
    try:
        for model in ("default", "hybrid"):
            status, ctype, body = _post(_url(srv), {"text": "Quantized.", "model": model,
                                                    "max_new_tokens": 6, "emotion": EMO})
            assert status == 200 and ctype == "audio/wav", body[:200]
            assert _frames(body) > 0
    finally:
        srv.shutdown()
    return srv


def test_int8_on_a_hybrid_pipeline_raises(monkeypatch, pipe, hybrid):
    """``--int8`` quantizes the hybrid pipeline too (its Mamba and attention
    projections and heads to int8), and the server answers on it."""
    pipes = _main_pipelines(monkeypatch, pipe, hybrid, ["--int8"]).pipelines
    bb = pipes["hybrid"].params["backbone"]
    for kind in ("mamba", "attn"):
        assert "weight_int8" in bb[kind]["in_proj"] and "weight_int8" in bb[kind]["out_proj"]
    assert "weight_int8" in pipes["default"].params["backbone"]["layers"]["fc2"]


# -- parity with the JAX server ------------------------------------------------

def test_greedy_wav_equals_the_jax_server(weights):
    """The same greedy request (explicit seed, ``max_new_tokens`` 8) to
    JAX's server and the port's on the same fp32 weights: WAVs of the same
    length, samples within 1e-4."""
    np_params, np_dac, np_spk = weights
    jpipe = JPipeline(model=JModel(JCFG), params=jax.tree_util.tree_map(jnp.asarray, np_params),
                      dac=JDACAutoencoder(JDACConfig(**DAC)),
                      dac_params=jax.tree_util.tree_map(jnp.asarray, np_dac),
                      speaker_encoder=JSpeakerEncoder(**SPK),
                      speaker_params=jax.tree_util.tree_map(jnp.asarray, np_spk))
    payload = {"text": "The same request to both.", "emotion": EMO, "seed": 11,
               "max_new_tokens": 8, "sampling": {"temperature": 0}}
    out = {}
    for name, srv in (("jax", JTTSServer(jpipe, host="127.0.0.1", port=0,
                                         request_timeout_s=300)),
                      ("port", TTSServer(_port_pipe(weights), host="127.0.0.1", port=0,
                                         request_timeout_s=300))):
        srv.start_background()
        try:
            port = srv._httpd.server_address[1]
            status, ctype, body = _post(f"http://127.0.0.1:{port}/tts", payload)
            assert status == 200 and ctype == "audio/wav", (name, body[:200])
            out[name] = read_wav(io.BytesIO(body))
        finally:
            srv.shutdown()
    (jwav, jsr), (twav, tsr) = out["jax"], out["port"]
    assert jsr == tsr == 44100
    assert twav.shape == jwav.shape == (1, 8 * HOP)
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=1e-4)


def test_dev_server_and_chip_smoke_import_nothing_of_jax():
    """The port's dev server and the card's smoke script load neither jax
    nor the JAX package (a fresh interpreter)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import dev_server_torch, chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'zonos_vibes_tpu' or k.startswith('zonos_vibes_tpu.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
