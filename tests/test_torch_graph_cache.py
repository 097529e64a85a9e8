"""The decode engine's cache (``engine/generate.DecodeEngine``), keyed like
JAX's ``_STATICS``, on the CPU: without CUDA graphs an entry still keeps
its tensors, so the key logic, the in-place prefill, the check-out rules
and the generator hand-over all run here.

The tiny transformer of tests/test_torch_generate.py and the tiny hybrid of
tests/test_torch_hybrid.py, fp32, with JAX's weights (``params_from_jax``).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_generate import JTINY, PHONEMES, TTINY, _weights
from tests.test_torch_hybrid import _tiny_models
from zonos_vibes_tpu.engine import generate as jgen
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu_torch.engine import generate as tgen
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

GREEDY = SamplingParams(temperature=0.0)
KW = dict(max_new_tokens=12, sampling_params=GREEDY, disable_eos=True)


@pytest.fixture(scope="module")
def tiny():
    """``(model, params, cond)``: the prepared conditioning of PHONEMES."""
    model = ZonosModel(TTINY)
    params = params_from_jax(_weights(False))
    return model, params, model.prepare_conditioning(params, {"espeak": torch.tensor(PHONEMES)})


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


def _entry_tensors(entry) -> dict:
    s = entry.state
    out = {f"cache.{k}": v for k, v in s.cache.items()}
    out.update({n: getattr(s, n) for n in tgen._STATE_TENSORS if getattr(s, n) is not None})
    out["logit_bias"] = entry.logit_bias
    return out


def test_hit_reuses_the_entry_tensors(tiny):
    """A second generate with the same key checks out the same entry: every
    tensor keeps its storage (a graph captured over them stays valid), the
    counters say one miss and one hit, and the codes are the same."""
    model, params, cond = tiny
    engine = tgen.DecodeEngine(model)
    first = engine.generate(params, cond, generator=_gen(), **KW)
    (entry,) = engine._entries
    ptrs = {k: v.data_ptr() for k, v in _entry_tensors(entry).items()}
    second = engine.generate(params, cond, generator=_gen(), **KW)
    assert engine._entries == [entry] and not entry.busy
    assert {k: v.data_ptr() for k, v in _entry_tensors(entry).items()} == ptrs
    assert (engine.misses, engine.hits, engine.captures) == (1, 1, 0)  # no graphs on the CPU
    assert engine.resident_bytes == entry.nbytes == sum(
        t.numel() * t.element_size() for t in _entry_tensors(entry).values())
    assert torch.equal(first.codes, second.codes) and first.steps == second.steps == 12 + 8
    assert second.capture_seconds == 0.0 and second.replays == 0


def _variants(model, params, cond):
    """Calls differing from the base call in one key field each: JAX's
    statics (prefix length, max_new_tokens, cfg_scale, sampling,
    disable_eos), the batch, the conditioning bucket and the tree."""
    pad = torch.cat([cond[:, :1], cond], dim=1)  # one position longer
    two = torch.cat([cond[:1], cond[:1], cond[1:], cond[1:]])  # batch 2
    return {
        "prefix_len": dict(audio_prefix_codes=torch.full((1, 9, 3), 7)),
        "max_new_tokens": dict(max_new_tokens=13),
        "cfg_scale": dict(cfg_scale=3.0),
        "sampling": dict(sampling_params=SamplingParams(temperature=0.0,
                                                        repetition_penalty_window=3)),
        "disable_eos": dict(disable_eos=False),
        "batch": dict(prefix_conditioning=two),
        "cond_len": dict(prefix_conditioning=pad),
        "params": dict(params=dict(params)),
    }


@pytest.mark.parametrize("field", ["prefix_len", "max_new_tokens", "cfg_scale", "sampling",
                                   "disable_eos", "batch", "cond_len", "params"])
def test_each_static_makes_a_new_entry(tiny, field):
    model, params, cond = tiny
    engine = tgen.DecodeEngine(model)
    base = dict(params=params, prefix_conditioning=cond, **KW)
    engine.generate(generator=_gen(), **base)
    call = {**base, **_variants(model, params, cond)[field]}
    res = engine.generate(generator=_gen(), **call)
    assert (engine.misses, engine.hits) == (2, 0)
    engine.generate(generator=_gen(), **call)
    engine.generate(generator=_gen(), **base)
    assert (engine.misses, engine.hits) == (2, 2)
    assert len(engine._entries) == 2
    assert res.codes.shape[0] == call["prefix_conditioning"].shape[0] // 2


def test_kv_int8_and_state_bf16_key_the_entry():
    """``kv_int8`` and ``state_bf16`` are engine settings, but a part of the
    key too: the same engine with the setting flipped makes a new entry."""
    model = ZonosModel(TTINY)
    params = quantize_zonos_params(params_from_jax(_weights(False)))
    cond = model.prepare_conditioning(params, {"espeak": torch.tensor(PHONEMES)})
    engine = tgen.DecodeEngine(model)
    engine.generate(params, cond, generator=_gen(), **KW)
    engine.kv_int8 = True
    engine.generate(params, cond, generator=_gen(), **KW)
    assert engine.misses == 2 and engine._entries[-1].state.cache["k"].dtype == torch.int8

    _, hmodel = _tiny_models()
    hparams = hmodel.init(torch.Generator().manual_seed(3), torch.float32)
    hcond = hmodel.prepare_conditioning(hparams, {"espeak": torch.tensor(PHONEMES)})
    engine = tgen.DecodeEngine(hmodel)
    engine.generate(hparams, hcond, generator=_gen(), **KW)
    engine.state_bf16 = True
    engine.generate(hparams, hcond, generator=_gen(), **KW)
    assert engine.misses == 2 and engine._entries[-1].state.cache["ssm"].dtype == torch.bfloat16


def test_two_checked_out_runs_never_share_an_entry(tiny):
    """A stream holds its entry between yields: a generate with the same key
    meanwhile gets an entry of its own; both give the same codes; once the
    stream ends, the next generate hits one of the two."""
    model, params, cond = tiny
    engine = tgen.DecodeEngine(model)
    it = engine.generate_stream(params, cond, generator=_gen(), chunk_steps=4, **KW)
    first = next(it)
    assert first.steps == 4 and engine._entries[0].busy
    solo = engine.generate(params, cond, generator=_gen(), **KW)
    assert (engine.misses, engine.hits) == (2, 0)
    a, b = engine._entries
    assert a.key == b.key and a.state.delayed.data_ptr() != b.state.delayed.data_ptr()
    chunks = [first, *it]
    assert torch.equal(chunks[-1].codes, solo.codes)
    assert not any(e.busy for e in engine._entries)
    engine.generate(params, cond, generator=_gen(), **KW)
    assert (engine.misses, engine.hits) == (2, 1)


@pytest.mark.parametrize("how", ["close", "drop"])
def test_abandoned_stream_gives_its_entry_back(tiny, how):
    """A stream closed (the client hung up) or dropped after its first chunk
    frees its entry, and the caller's generator takes the entry's state."""
    model, params, cond = tiny
    engine = tgen.DecodeEngine(model)
    caller = _gen()
    it = engine.generate_stream(params, cond, generator=caller, chunk_steps=4, **KW)
    next(it)
    (entry,) = engine._entries
    assert entry.busy
    if how == "close":
        it.close()
    else:
        del it
        gc.collect()
    assert not entry.busy
    assert torch.equal(caller.get_state(), entry.generator.get_state())
    engine.generate(params, cond, generator=_gen(), **KW)
    assert (engine.misses, engine.hits) == (1, 1)


def test_sampled_hit_equals_a_fresh_engine_and_hands_the_generator_back(tiny):
    """The default sampler: a hit's codes equal a fresh engine's for the
    same seed, and the caller's generator ends where the fresh run left its
    own (the entry's generator takes the caller's state and gives it back)."""
    model, params, cond = tiny
    kw = dict(max_new_tokens=30, sampling_params=SamplingParams(min_p=0.1))
    engine = tgen.DecodeEngine(model)
    engine.generate(params, cond, generator=_gen(7), **kw)  # the miss
    hit_gen, fresh_gen = _gen(5), _gen(5)
    hit = engine.generate(params, cond, generator=hit_gen, **kw)
    fresh = tgen.DecodeEngine(model).generate(params, cond, generator=fresh_gen, **kw)
    assert engine.hits == 1
    assert torch.equal(hit.codes, fresh.codes) and hit.steps == fresh.steps
    assert torch.equal(hit_gen.get_state(), fresh_gen.get_state())
    assert not torch.equal(hit_gen.get_state(), _gen(5).get_state())  # it advanced


def test_default_generator_is_handed_over_too(tiny):
    """Without a generator the run draws from the device's default one, and
    leaves it where an uncached run would."""
    model, params, cond = tiny
    kw = dict(max_new_tokens=10, sampling_params=SamplingParams(min_p=0.1))
    engine = tgen.DecodeEngine(model)
    engine.generate(params, cond, **kw)
    torch.manual_seed(11)
    hit = engine.generate(params, cond, **kw)
    after_hit = torch.default_generator.get_state()
    torch.manual_seed(11)
    fresh = tgen.DecodeEngine(model).generate(params, cond, **kw)
    assert torch.equal(hit.codes, fresh.codes)
    assert torch.equal(after_hit, torch.default_generator.get_state())


@torch.inference_mode()
def _poison(entry) -> None:
    for t in _entry_tensors(entry).values():
        t.fill_(float("nan") if t.is_floating_point() else (-7 if t.dtype != torch.bool else 1))


@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_stale_buffers_change_nothing(tiny, path):
    """Every buffer of the entry (cache, stage, scales, the hybrid's conv
    and SSM state, the delayed codes, counters, device scalars and the
    logit bias) poisoned between two generates: the second's codes equal a
    fresh engine's, across a stage flush (140 steps) on the transformer."""
    if path == "hybrid":
        _, model = _tiny_models()
        params = model.init(torch.Generator().manual_seed(3), torch.float32)
        cond = model.prepare_conditioning(params, {"espeak": torch.tensor(PHONEMES)})
        kw, engine_kw = dict(KW, max_new_tokens=40), {}
    else:
        model, params, cond = tiny
        kw = dict(KW, max_new_tokens=140)
        engine_kw = {"kv_int8": path == "int8"}
    engine = tgen.DecodeEngine(model, **engine_kw)
    engine.generate(params, cond, generator=_gen(), **kw)
    _poison(engine._entries[0])
    hit = engine.generate(params, cond, generator=_gen(), **kw)
    fresh = tgen.DecodeEngine(model, **engine_kw).generate(params, cond, generator=_gen(), **kw)
    assert engine.hits == 1
    assert torch.equal(hit.codes, fresh.codes) and hit.valid_length == fresh.valid_length


@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_reset_cache_equals_a_fresh_allocation(path):
    if path == "hybrid":
        _, model = _tiny_models()
    else:
        model = ZonosModel(TTINY)
    kv_int8 = path == "int8"
    cache = model.allocate_cache(2, 40, torch.float32, "cpu", kv_int8)
    for t in cache.values():
        t.fill_(3)
    tgen._reset_cache(cache)
    fresh = model.allocate_cache(2, 40, torch.float32, "cpu", kv_int8)
    assert cache.keys() == fresh.keys()
    for k in cache:
        assert torch.equal(cache[k], fresh[k]), k


def test_free_entries_are_evicted_by_bytes_least_recently_used_first(tiny):
    model, params, cond = tiny
    engine = tgen.DecodeEngine(model)
    for mnt in (12, 13, 14):
        engine.generate(params, cond, generator=_gen(), **dict(KW, max_new_tokens=mnt))
    sizes = [e.nbytes for e in engine._entries]
    engine.generate(params, cond, generator=_gen(), **KW)  # 12 becomes the most recent
    engine.cache_bytes = sizes[0] + sizes[2] + 1  # room for two
    engine.generate(params, cond, generator=_gen(), **dict(KW, max_new_tokens=14))
    assert [e.key[2] for e in engine._entries] == [12, 14]  # 13 was the least recent
    assert engine.resident_bytes == sizes[0] + sizes[2]
    engine.cache_bytes = 0
    it = engine.generate_stream(params, cond, generator=_gen(), chunk_steps=4, **KW)
    next(it)  # a busy entry is never evicted
    assert [e.key[2] for e in engine._entries] == [12] and engine._entries[0].busy
    it.close()
    assert engine._entries == [] and engine.resident_bytes == 0


def test_quantize_int8_clears_the_cache():
    """``quantize_int8`` replaces the tree, and the engine drops its entries
    (which would keep the old tree alive); a generate then makes a new one."""
    pipe = ZonosPipeline.from_params(TTINY, params_from_jax(_weights(False)), device="cpu")
    cond = {"espeak": torch.tensor(PHONEMES)}
    pipe.generate(cond, generator=_gen(), **KW)
    old = pipe.params
    assert pipe.engine._entries[0].params is old and pipe.engine.resident_bytes > 0
    pipe.quantize_int8()
    assert pipe.engine._entries == [] and pipe.engine.resident_bytes == 0
    pipe.generate(cond, generator=_gen(), **KW)
    assert pipe.engine._entries[0].params is pipe.params and pipe.engine.misses == 2


def test_hit_greedy_codes_equal_jax_generate_jit(tiny):
    """A cache hit's greedy codes (140 steps, across a stage flush) equal a
    fresh engine's and JAX's ``generate_jit``'s on the same weights."""
    model, params, cond = tiny
    kw = dict(KW, max_new_tokens=140)
    engine = tgen.DecodeEngine(model)
    engine.generate(params, cond, generator=_gen(), **dict(kw, max_new_tokens=140))
    hit = engine.generate(params, cond, generator=_gen(2), **kw)
    assert engine.hits == 1
    fresh = tgen.DecodeEngine(model).generate(params, cond, generator=_gen(3), **kw)
    np_params = _weights(False)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jmodel = JModel(JTINY)
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(PHONEMES)})
    K = JTINY.num_codebooks
    jcodes, jvalid, _ = jgen.generate_jit(
        jmodel, jparams, jcond, jnp.zeros((1, K, 0), jnp.int32), jax.random.key(1),
        prefix_audio_len=0, max_new_tokens=140, cfg_scale=2.0,
        sampling=JSampling(temperature=0.0), disable_eos=True)
    assert torch.equal(hit.codes, fresh.codes)
    np.testing.assert_array_equal(hit.codes.numpy(), np.asarray(jcodes))
    assert hit.valid_length == int(jvalid) == 140


def test_concurrent_generates_never_share_an_entry(tiny):
    """12 threads (more than the cores) generate with one key at once, the
    interpreter switching threads every microsecond: each run checks out an
    entry no other run holds, every run's codes are the reference's, and
    every entry is free afterwards."""
    import sys
    import threading

    model, params, cond = tiny
    engine = tgen.DecodeEngine(model)
    want = engine.generate(params, cond, generator=_gen(), **KW).codes
    results, errors = [], []

    def run():
        try:
            results.append(engine.generate(params, cond, generator=_gen(), **KW).codes)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(results) == 12
    assert all(torch.equal(r, want) for r in results)
    assert engine.hits + engine.misses == 13 and engine.misses == len(engine._entries)
    assert not any(e.busy for e in engine._entries)
