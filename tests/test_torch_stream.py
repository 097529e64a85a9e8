"""The port's device-state decode loop and streaming entry points against the
JAX package on the CPU: ``DecodeEngine.generate_stream``,
``ZonosPipeline.generate_stream``, the stop test's read schedule and the
pool's in-place state.

Tiny configs (the transformer of tests/test_torch_generate.py, the 3-layer
hybrid of tests/test_torch_hybrid.py, the tiny DAC of
tests/test_pipeline_server.py), fp32, the same weights on both sides
(``params_from_jax``). Greedy codes are deterministic on both sides and
must be equal; sampled codes are held against the port's own one-shot run.
"""

import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_generate import JTINY, PHONEMES, TTINY, _weights
from tests.test_torch_hybrid import _tiny_models
from tests.test_torch_pool import Join, Side, _run
from zonos_vibes_tpu.engine import generate as jgen
from zonos_vibes_tpu.models.autoencoder import DACAutoencoder as JDACAutoencoder
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.pipeline import ZonosPipeline as JPipeline
from zonos_vibes_tpu_torch.engine import generate as tgen
from zonos_vibes_tpu_torch.engine import pool as tpool
from zonos_vibes_tpu_torch.engine.graphs import StepGraph
from zonos_vibes_tpu_torch.models.dac import DACConfig
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils import tracing
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

DAC = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
           n_codebooks=9, codebook_size=1024, codebook_dim=4)
GREEDY = dict(temperature=0.0)


def _port_engine_inputs(np_params, model=None):
    model = model or ZonosModel(TTINY)
    params = params_from_jax(np_params)
    return model, params, model.prepare_conditioning(params, {"espeak": torch.tensor(PHONEMES)})


@pytest.mark.parametrize("chunk_steps", [5, 43])
def test_stream_codes_equal_one_shot_across_a_stage_flush(chunk_steps):
    """The default sampler from one generator seed, 140 frames (148 steps,
    the 128-row stage flushing once): every yield is cumulative, the last
    equals one-shot ``generate`` bit for bit."""
    model, params, cond = _port_engine_inputs(_weights(False))
    kw = dict(max_new_tokens=140, sampling_params=SamplingParams(min_p=0.1), disable_eos=True)
    engine = tgen.DecodeEngine(model)
    one_shot = engine.generate(params, cond, generator=torch.Generator().manual_seed(3), **kw)
    chunks = list(engine.generate_stream(params, cond, generator=torch.Generator().manual_seed(3),
                                         chunk_steps=chunk_steps, **kw))
    assert one_shot.steps == 148 > 128
    assert len(chunks) == math.ceil(148 / chunk_steps)
    assert [c.steps for c in chunks] == [min(148, chunk_steps * (i + 1))
                                         for i in range(len(chunks))]
    final = chunks[-1]
    assert torch.equal(final.codes, one_shot.codes)
    assert final.valid_length == one_shot.valid_length == 140
    prev = 0
    for c in chunks:
        assert c.valid_length >= prev
        assert torch.equal(c.codes[..., :c.valid_length], final.codes[..., :c.valid_length])
        prev = c.valid_length


def _hybrid_inputs():
    jmodel, tmodel = _tiny_models()
    jparams = jmodel.init(jax.random.key(11), jnp.float32)
    return jmodel, jparams, tmodel, jax.device_get(jparams)


@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_greedy_stream_chunks_equal_jax(path):
    """Chunk by chunk (codes and ``valid_length``) against JAX's
    ``DecodeEngine.generate_stream``: the transformer with an exact and with
    an int8 KV cache (int8 weights, 140 frames across the stage flush), and
    the hybrid."""
    kv_int8 = path == "int8"
    if path == "hybrid":
        jmodel, jparams, tmodel, np_params = _hybrid_inputs()
        tparams = params_from_jax(np_params)
        tokens, mnt = [[2, 14, 25, 36, 47, 3]], 100
    else:
        np_params = _weights(False)
        jmodel, tmodel = JModel(JTINY), ZonosModel(TTINY)
        jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
        tparams = params_from_jax(np_params)
        if kv_int8:
            jparams, tparams = jquantize(jparams, heads=True), quantize_zonos_params(tparams)
        tokens, mnt = PHONEMES, 140
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(tokens)})
    tcond = tmodel.prepare_conditioning(tparams, {"espeak": torch.tensor(tokens)})
    jchunks = list(jgen.DecodeEngine(jmodel, kv_int8=kv_int8).generate_stream(
        jparams, jcond, key=jax.random.key(1), max_new_tokens=mnt,
        sampling_params=JSampling(**GREEDY), disable_eos=True, chunk_steps=43))
    tchunks = list(tgen.DecodeEngine(tmodel, kv_int8=kv_int8).generate_stream(
        tparams, tcond, generator=torch.Generator().manual_seed(1), max_new_tokens=mnt,
        sampling_params=SamplingParams(**GREEDY), disable_eos=True, chunk_steps=43))
    assert len(tchunks) == len(jchunks) == math.ceil((mnt + 8) / 43)
    for t, j in zip(tchunks, jchunks):
        assert t.valid_length == int(j.valid_length)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.valid_lengths.numpy(), np.asarray(j.valid_lengths))


def test_stream_abort_runs_nothing_more(monkeypatch):
    """After the first chunk the caller stops consuming: no further step and
    no further read of the device runs, and the iterator is finished."""
    calls = {"step": 0, "read": 0}
    step, read = tgen._decode_step, tgen._read_max_remaining

    def counted_step(*args):
        calls["step"] += 1
        step(*args)

    def counted_read(s):
        calls["read"] += 1
        return read(s)

    monkeypatch.setattr(tgen, "_decode_step", counted_step)
    monkeypatch.setattr(tgen, "_read_max_remaining", counted_read)
    model, params, cond = _port_engine_inputs(_weights(False))
    it = tgen.DecodeEngine(model).generate_stream(
        params, cond, generator=torch.Generator().manual_seed(6), max_new_tokens=20,
        sampling_params=SamplingParams(**GREEDY), disable_eos=True, chunk_steps=4)
    first = next(it)
    assert first.steps == calls["step"] == 4
    seen = dict(calls)
    it.close()
    with pytest.raises(StopIteration):
        next(it)
    assert calls == seen


def _forced_eos_weights(lead: int):
    """Codebook 0 emits EOS first at decode step ``lead + 1`` under greedy
    decoding with a repetition window of ``lead + 1`` frames: the final
    norm's output is the unit vector e_0 (tests/test_torch_generate.py's
    forced-EOS setup), codebook 0's head gives ``lead + 1`` tokens logits
    between EOS's 10 and 30, in falling order, and 0 to the rest. The first
    frame (the prefill's) takes the largest and each step the next: a used
    token, divided by the penalty 3 while it stays in the window, falls
    below EOS."""
    params = _weights(True)
    heads = np.array(params["heads"]["weight"])
    heads[0, 0, :] = 0.0
    heads[0, 0, 1024] = 10.0
    heads[0, 0, 100:101 + lead] = 29.0 - 0.1 * np.arange(lead + 1)
    params["heads"]["weight"] = heads
    return params


@pytest.mark.parametrize("lead", [0, 25, 60])
def test_read_schedule_with_eos_early_mid_late(monkeypatch, lead):
    """EOS forced at the first step, near the middle and late (the
    forced-EOS setup of test_eos_cascade_bookkeeping_matches_jax, with a
    wider repetition window): the step count and codes equal JAX's, one-shot
    and streamed, and a counted read hook shows at most ceil(steps / 9) +
    flushes + chunks + 1 reads. A 64-frame audio prefix (token 7) keeps
    every window inside the written columns: JAX's ``dynamic_slice`` wraps a
    negative start to the buffer's tail, where the port clamps it to 0."""
    np_params = _forced_eos_weights(lead)
    window = lead + 1
    prefix = np.full((1, 9, 64), 7)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jmodel = JModel(JTINY)
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(PHONEMES)})
    jres = jgen.DecodeEngine(jmodel).generate(
        jparams, jcond, jnp.asarray(prefix, jnp.int32), key=jax.random.key(1),
        max_new_tokens=80,
        sampling_params=JSampling(temperature=0.0, repetition_penalty_window=window))

    reads = [0]
    read = tgen._read_max_remaining

    def counted_read(s):
        reads[0] += 1
        return read(s)

    monkeypatch.setattr(tgen, "_read_max_remaining", counted_read)
    model, params, cond = _port_engine_inputs(np_params)
    kw = dict(max_new_tokens=80,
              sampling_params=SamplingParams(temperature=0.0, repetition_penalty_window=window))
    engine = tgen.DecodeEngine(model)
    res = engine.generate(params, cond, torch.from_numpy(prefix),
                          generator=torch.Generator().manual_seed(1), **kw)
    steps = res.steps
    assert steps == (lead + 1) + 8  # EOS at step lead + 1, then the 8 cascade steps
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(jres.codes))
    assert res.valid_length == int(jres.valid_length)
    np.testing.assert_array_equal(res.valid_lengths.numpy(), np.asarray(jres.valid_lengths))
    assert reads[0] == res.host_reads <= math.ceil(steps / 9) + 0 + 1 + 1

    reads[0] = 0
    chunks = list(engine.generate_stream(params, cond, torch.from_numpy(prefix),
                                         generator=torch.Generator().manual_seed(1),
                                         chunk_steps=5, **kw))
    assert chunks[-1].steps == steps
    assert torch.equal(chunks[-1].codes, res.codes)
    assert reads[0] <= math.ceil(steps / 9) + 0 + len(chunks) + 1


def test_graphs_on_cpu_raise():
    """Asking for CUDA graphs with inputs on the CPU raises; the default runs
    the same step eagerly there."""
    model, params, cond = _port_engine_inputs(_weights(False))
    with pytest.raises(ValueError, match="CUDA"):
        tgen.DecodeEngine(model, cuda_graphs=True).generate(
            params, cond, generator=torch.Generator().manual_seed(0), max_new_tokens=4)
    with pytest.raises(ValueError, match="CUDA"):
        tpool.make_pool(model, tpool.PoolConfig(slots=1, max_cond_len=16, max_new_tokens=8),
                        torch.float32, device="cpu", cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda: None, torch.device("cpu"), enabled=True)
    res = tgen.DecodeEngine(model).generate(params, cond,
                                            generator=torch.Generator().manual_seed(0),
                                            max_new_tokens=4)
    assert res.replays == 0 and res.step_launches == {}


@pytest.fixture(scope="module")
def pipelines():
    """The tiny pipeline on both sides, with the tiny DAC; JAX's weights
    carried to the port."""
    jmodel = JModel(JTINY)
    np_params = _weights(False)
    jdac = JDACAutoencoder(JDACConfig(**DAC))
    np_dac = jax.device_get(jdac.init(jax.random.key(2)))
    jpipe = JPipeline(model=jmodel, params=jax.tree_util.tree_map(jnp.asarray, np_params),
                      dac=jdac, dac_params=jax.tree_util.tree_map(jnp.asarray, np_dac))
    tpipe = ZonosPipeline.from_params(TTINY, params_from_jax(np_params), params_from_jax(np_dac),
                                      device="cpu", dac_config=DACConfig(**DAC))
    return jpipe, tpipe


def test_pipeline_stream_equals_one_shot_and_jax(pipelines):
    """The concatenated chunks equal one-shot ``generate`` + ``decode_audio``
    (1e-5: the same fp32 convolutions over other window lengths) and JAX's
    ``generate_stream`` (1e-4: the two frameworks' fp32 convolutions)."""
    jpipe, tpipe = pipelines
    kw = dict(max_new_tokens=72, chunk_frames=12, margin_frames=24)
    tcond = {"espeak": torch.tensor(PHONEMES)}
    ref = tpipe.decode_audio(tpipe.generate(tcond, generator=torch.Generator().manual_seed(9),
                                            max_new_tokens=72,
                                            sampling_params=SamplingParams(**GREEDY)))
    got = list(tpipe.generate_stream(tcond, generator=torch.Generator().manual_seed(9),
                                     sampling_params=SamplingParams(**GREEDY), **kw))
    assert len(got) > 1
    got = np.concatenate(got, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    want = np.concatenate(list(jpipe.generate_stream(
        {"espeak": jnp.asarray(PHONEMES)}, key=jax.random.key(9),
        sampling_params=JSampling(**GREEDY), **kw)), axis=-1)
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def _pointers(pool: dict) -> dict:
    out = {}
    for tree in (pool, pool["cache"], pool["knobs"]):
        out.update({k: v.data_ptr() for k, v in tree.items() if isinstance(v, torch.Tensor)})
    return out


def test_pool_tensors_keep_their_storage():
    """``join``, ``pool_steps`` and ``flush_pool_rings`` update every tensor
    of the pool (its cache and knobs too) in place, so a graph captured over
    them stays valid for the pool's lifetime."""
    side = Side(False, params_from_jax(_weights(False)), False)
    ptrs = _pointers(side.pool)
    side.join(Join(0, "a", 14, seed=1))
    assert _pointers(side.pool) == ptrs
    side.steps(5)
    assert _pointers(side.pool) == ptrs
    side.join(Join(1, "b", 14, seed=2, cfg=3.5))
    side.steps(5)
    tpool.flush_pool_rings(side.pool)
    assert _pointers(side.pool) == ptrs
    assert int(side.pool["flush_base"][0]) == int(side.pool["pos"][0])


def test_pool_row_with_its_whole_budget_beside_a_running_row():
    """Row A spends the pool's whole frame budget and ends while row B still
    runs: its later (masked) reads sit past its buffer. The port clamps
    them; JAX's gathers fill them (``INT_MIN``), so the two feed the ended
    row different input frames, whose columns land only at or past its
    position, which nothing reads. Counters, codes and every row's cache
    below its position equal JAX's after every operation."""
    params = _weights(False)
    weights = {"jax": jax.tree_util.tree_map(jnp.asarray, params),
               "port": params_from_jax(params)}
    sched = (Join(0, "a", 24, seed=1), 5, Join(1, "b", 24, seed=2, cfg=3.5))
    out = {name: _run(Side(name == "jax", weights[name], False), sched, (0, 1))
           for name in ("jax", "port")}
    (jstates, jcodes), (tstates, tcodes) = out["jax"], out["port"]
    assert tcodes[0][1] == jcodes[0][1] == 24  # the whole budget
    assert len(tstates) == len(jstates)
    for i, (js, ts) in enumerate(zip(jstates, tstates)):
        for n in ("pos", "step", "flush_base", "remaining", "stop_offset", "delayed", "active",
                  "stopping"):
            np.testing.assert_array_equal(ts[n], js[n], err_msg=f"{n} after op {i}")
        slots = len(ts["pos"])
        for n in ("k", "v"):
            for b, pos in enumerate(ts["pos"]):
                for row in (b, slots + b):
                    np.testing.assert_allclose(ts[n][:, row, :pos], js[n][:, row, :pos],
                                               rtol=1e-5, atol=1e-5, err_msg=f"{n} after op {i}")
    for s in (0, 1):
        np.testing.assert_array_equal(tcodes[s][0], jcodes[s][0])


def test_pool_reads_at_most_ceil_steps_over_9_plus_1():
    """A 43-step segment of rows far from their end reads the device 5
    times (a read grants min(R, 9) steps), not once per step."""
    side = Side(False, params_from_jax(_weights(False)), False)
    side.pool = tpool.make_pool(side.model, tpool.PoolConfig(slots=2, max_cond_len=16,
                                                             max_new_tokens=120),
                                torch.float32, device="cpu")
    side.join(Join(0, "a", 120, seed=1))
    t0 = time.monotonic_ns()
    tracing.enable()
    try:
        assert tpool.pool_steps(side.model, side.params, side.pool, 42, 43) == 43
    finally:
        tracing.disable()
    reads = [s for s in tracing.spans(t0) if s["name"] == "read_running"]
    assert 1 <= len(reads) <= math.ceil(43 / 9) + 1
