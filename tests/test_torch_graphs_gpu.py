"""The port's CUDA-graph decode (``engine/graphs.py``) against its eager
decode, and the decode engine's cache of captured steps, on the card.

Full widths, cut depth: the flagship transformer with 4 layers and the
hybrid with 8 (attention at layers 3 and 7), random bf16 weights from a
seed. The graph runs the same device-state step as the eager run, so codes
must be equal bit for bit: greedy by construction, sampled because the
generator is registered with the graph and each replay advances it as the
eager step does. Launch counts reconstructed from the captured step must
equal the eager run's. Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_graphs_gpu.py -q

(``--noconftest``: the repository's conftest sets up JAX, which that machine
does not need.) Without a card every test here skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zonos_vibes_tpu_torch.config import (
    ZONOS_V01_HYBRID,
    ZONOS_V01_TRANSFORMER,
    ZonosConfig,
)
from zonos_vibes_tpu_torch.engine import pool as plib
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.engine.graphs import StepGraph
from zonos_vibes_tpu_torch.models.dac import DACConfig
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.mamba_step import ssd_gate_step_layered
from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

pytestmark = pytest.mark.gpu

TEXT = "Graphs replay the decode step."
SAMPLERS = {"greedy": (SamplingParams(temperature=0.0), True),
            "default": (SamplingParams(min_p=0.1), False)}  # (sampler, disable_eos)
TINY_DAC = DACConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
                     codebook_dim=4)


def _cut(cfg: ZonosConfig, **backbone) -> ZonosConfig:
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **backbone))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def paths(dev):
    """``{path: (pipe, params, engine kwargs, launches per solo step, per
    pooled step)}``."""
    tf = ZonosPipeline.from_config(_cut(ZONOS_V01_TRANSFORMER, n_layer=4), device=dev,
                                   generator=torch.Generator(dev).manual_seed(421),
                                   dac_config=TINY_DAC)
    hy = ZonosPipeline.from_config(_cut(ZONOS_V01_HYBRID, n_layer=8, attn_layer_idx=(3, 7)),
                                   device=dev, generator=torch.Generator(dev).manual_seed(422),
                                   dac_config=TINY_DAC)
    return {
        "bf16": (tf, tf.params, {}, {"decode_attention": 4}, {"decode_attention_pooled": 4}),
        "int8": (tf, quantize_zonos_params(tf.params), {"kv_int8": True},
                 {"decode_attention_q": 4, "qmm_int8": 4 * 4 + 1},
                 {"decode_attention_pooled_q": 4, "qmm_int8": 4 * 4 + 1}),
        "hybrid": (hy, hy.params, {}, {"decode_attention_unstaged": 2, "ssd_gate_step": 6},
                   {"decode_attention_pooled": 2, "ssd_gate_step": 6}),
    }


def _generate(pipe, params, kwargs, graphs, sampler, max_new_tokens=140, seed=5):
    sampling, disable_eos = SAMPLERS[sampler]
    prefix = pipe.prepare_conditioning(pipe.make_cond_dict(text=TEXT))
    build.reset_launches()
    res = DecodeEngine(pipe.model, cuda_graphs=graphs, **kwargs).generate(
        params, prefix, generator=torch.Generator("cuda").manual_seed(seed),
        max_new_tokens=max_new_tokens, sampling_params=sampling, disable_eos=disable_eos)
    return res, dict(build.LAUNCHES)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_graph_codes_equal_eager(paths, path, sampler):
    """140 frames: the transformer's stage flushes once (at 128 steps)
    between replays."""
    pipe, params, kwargs, per_step, _ = paths[path]
    eager, eager_launches = _generate(pipe, params, kwargs, False, sampler)
    graph, graph_launches = _generate(pipe, params, kwargs, True, sampler)
    assert graph.steps == eager.steps
    assert torch.equal(graph.codes, eager.codes)
    assert graph.valid_length == eager.valid_length
    assert torch.equal(graph.valid_lengths, eager.valid_lengths)
    assert (eager.replays, graph.replays) == (0, graph.steps - 1)
    assert graph.step_launches == per_step
    assert graph_launches == eager_launches
    if sampler == "greedy":
        assert graph.steps == 140 + 9 - 1
        assert graph.host_reads == eager.host_reads == 2  # R, then 0


def test_stream_graph_codes_equal_eager(paths):
    pipe, params, kwargs, _, _ = paths["bf16"]
    eager, _ = _generate(pipe, params, kwargs, False, "default")
    prefix = pipe.prepare_conditioning(pipe.make_cond_dict(text=TEXT))
    chunks = list(DecodeEngine(pipe.model).generate_stream(
        params, prefix, generator=torch.Generator("cuda").manual_seed(5), max_new_tokens=140,
        sampling_params=SAMPLERS["default"][0], chunk_steps=43))
    assert len(chunks) == -(-eager.steps // 43)
    assert chunks[-1].steps == eager.steps
    assert torch.equal(chunks[-1].codes, eager.codes)
    assert chunks[-1].replays == eager.steps - 1


def test_pipeline_stream_audio_equals_one_shot(paths):
    """The pipeline's chunks against one-shot audio, on the tiny DAC. The
    tolerance covers cuDNN choosing other fp32 convolution algorithms for
    the shorter windows."""
    pipe = paths["bf16"][0]
    cond = pipe.make_cond_dict(text=TEXT)
    kw = dict(max_new_tokens=72, sampling_params=SamplingParams(temperature=0.0))
    ref = pipe.decode_audio(pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(9),
                                          **kw))
    chunks = list(pipe.generate_stream(cond, generator=torch.Generator("cuda").manual_seed(9),
                                       chunk_frames=12, margin_frames=24, **kw))
    assert len(chunks) > 1
    got = np.concatenate(chunks, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def _pointers(pool: dict) -> dict:
    """The storage of every tensor of the pool, its cache and its knobs."""
    out = {}
    for tree in (pool, pool["cache"], pool["knobs"]):
        out.update({k: v.data_ptr() for k, v in tree.items() if isinstance(v, torch.Tensor)})
    return out


def _pool_run(pipe, params, kwargs, graphs):
    """Three requests (greedy, the default sampler, top-k: both sampler
    variants) joining at segments 0, 1 and 2, until all finish."""
    model = pipe.model
    kv_int8 = kwargs.get("kv_int8", False)
    pc = plib.PoolConfig(slots=4, max_new_tokens=120)
    pool = plib.make_pool(model, pc, torch.bfloat16, kv_int8=kv_int8, device="cuda",
                          cuda_graphs=graphs)
    ptrs = _pointers(pool)
    samplers = [SamplingParams(temperature=0.0), SamplingParams(min_p=0.1),
                SamplingParams(top_k=50)]
    build.reset_launches()
    steps = 0
    for seg in range(12):
        if seg < len(samplers):
            prefix = pipe.prepare_conditioning(pipe.make_cond_dict(text=TEXT[: 20 + 5 * seg]))
            req, knobs = plib.prefill_request(
                model, params, prefix, torch.Generator("cuda").manual_seed(100 + seg), 120, 2.0,
                samplers[seg], kv_int8=kv_int8)
            plib.join(pool, req, seg, prefix.shape[1], 1000 + seg, knobs)
        elif all(plib.row_finished(pool, s) for s in range(len(samplers))):
            break
        steps += plib.pool_steps(model, params, pool, 7, 43)
    assert _pointers(pool) == ptrs
    state = {k: pool[k].clone() for k in ("delayed", "pos", "step", "remaining", "stopping",
                                          "stop_offset", "flush_base")}
    return state, steps, dict(build.LAUNCHES), pool["graphs"]


@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_pool_graph_rows_equal_eager(paths, path):
    pipe, params, kwargs, _, per_step = paths[path]
    eager, eager_steps, eager_launches, _ = _pool_run(pipe, params, kwargs, False)
    graph, graph_steps, graph_launches, graphs = _pool_run(pipe, params, kwargs, True)
    assert graph_steps == eager_steps
    for name, t in eager.items():
        assert torch.equal(graph[name], t), name
    assert graph_launches == eager_launches
    assert {k[0] for k in graphs} == {False, True}  # one graph per sampler variant
    for runner in graphs.values():
        assert runner.step_launches == per_step


def _pdl_chain(dev):
    """A step of ``qmm_int8`` at M = 2 twice, a copy, the fused Mamba step
    twice, a copy: both kernels launched with programmatic dependent launch,
    chained so each launch reads what the one before it wrote. Returns
    ``(start tensors, make_step)``; ``make_step(t)`` steps the tensors
    ``t``."""
    gen = torch.Generator(dev).manual_seed(3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    K = 2048
    w = [torch.randint(-127, 128, (1, K, K), generator=gen, device=dev, dtype=torch.int8)
         for _ in range(2)]
    scale = [(randn(1, 1, K).abs() + 0.5) / (96 * K ** 0.5) for _ in range(2)]
    B, N, HP, H = 2, 128, 4096, 64
    fixed = dict(dt=randn(B, H).abs() * 0.1, bm=randn(B, N), cm=randn(B, N),
                 d_skip=randn(H), norm_w=(1 + 0.1 * randn(HP)).bfloat16())
    fixed["decay"] = torch.exp(-fixed["dt"])
    start = dict(x=randn(2, K, dtype=torch.bfloat16), xs=randn(B, HP, dtype=torch.bfloat16),
                 z=randn(B, HP, dtype=torch.bfloat16), states=randn(3, B, N, HP))

    def make_step(t):
        def step():
            y = qmm_int8(qmm_int8(t["x"], w[0], scale[0])[:, 0], w[1], scale[1])[:, 0]
            t["x"].copy_(y)
            out = t["xs"]
            for _ in range(2):
                out = ssd_gate_step_layered(t["states"], 1, out, fixed["dt"], fixed["decay"],
                                            fixed["bm"], fixed["cm"], t["z"], fixed["d_skip"],
                                            fixed["norm_w"])
            t["xs"].copy_(out)
        return step

    return start, make_step


def test_captured_pdl_kernels_replay_equal_eager(dev):
    """20 replays of the captured chain equal 20 eager steps bit for bit."""
    start, make_step = _pdl_chain(dev)

    def run(graphs):
        t = {k: v.clone() for k, v in start.items()}
        runner = StepGraph(make_step(t), dev, graphs)
        runner.run(20)
        torch.cuda.synchronize()
        return t, runner

    eager, _ = run(False)
    graph, runner = run(True)
    assert runner.replays == 19 and runner.step_launches == {"qmm_int8": 2, "ssd_gate_step": 2}
    for k in start:
        assert torch.isfinite(graph[k].float()).all(), k
        assert torch.equal(graph[k], eager[k]), k


def test_captured_pdl_launches_keep_programmatic_edges(dev):
    """The captured chain's graph, read through the driver API: 4 kernel
    nodes and 2 copies, and a programmatic edge (from the kernel's
    programmatic port) into each launch made with programmatic dependent
    launch whose predecessor is a kernel: the second ``qmm_int8`` and the
    second Mamba step (the first follows a copy, which takes a full
    edge)."""
    import ctypes

    class EdgeData(ctypes.Structure):  # CUgraphEdgeData
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    start, make_step = _pdl_chain(dev)
    t = {k: v.clone() for k, v in start.items()}
    step = make_step(t)
    StepGraph(step, dev, True).run(1)  # the warm-up, as the runner does it
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        step()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    assert sorted(kinds) == [0, 0, 0, 0, 1, 1]  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY
    m = ctypes.c_size_t(0)
    assert cu.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(m)) == 0
    src, dst, data = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)(), \
        (EdgeData * m.value)()
    assert cu.cuGraphGetEdges_v2(raw, src, dst, data, ctypes.byref(m)) == 0
    edges = sorted((e.type, e.from_port) for e in data)
    # CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC = 1 from CU_GRAPH_KERNEL_NODE_PORT_PROGRAMMATIC = 1.
    assert edges == [(0, 0), (0, 0), (0, 0), (1, 1), (1, 1)]


# -- the engine's cache (one entry, one capture, per static signature) ------

def _cached_generate(engine, pipe, params, sampler, seed, text=TEXT, batch=1,
                     max_new_tokens=140):
    sampling, disable_eos = SAMPLERS[sampler]
    conds = [pipe.make_cond_dict(text=text[: len(text) - 3 * i]) for i in range(batch)]
    prefix = pipe.prepare_conditioning(pipe.merge_cond_dicts(conds, pad_len=64))
    gen = torch.Generator("cuda").manual_seed(seed)
    res = engine.generate(params, prefix, generator=gen, max_new_tokens=max_new_tokens,
                          sampling_params=sampling, disable_eos=disable_eos)
    return res, gen


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_second_generate_with_the_key_captures_nothing(paths, path, sampler):
    """A second generate with the same key replays the first's graph (no
    capture, every step replayed) and gives the codes of a fresh engine's
    run for the same seed; the caller's generator ends where that run's
    did. A third with another seed differs (sampled) and still captures
    nothing."""
    pipe, params, kwargs, per_step, _ = paths[path]
    engine = DecodeEngine(pipe.model, **kwargs)
    first, _ = _cached_generate(engine, pipe, params, sampler, 5)
    assert first.capture_seconds > 0 and first.replays == first.steps - 1
    hit, hit_gen = _cached_generate(engine, pipe, params, sampler, 6)
    fresh, fresh_gen = _cached_generate(DecodeEngine(pipe.model, **kwargs), pipe, params,
                                        sampler, 6)
    assert (engine.captures, engine.misses, engine.hits) == (1, 1, 1)
    assert hit.capture_seconds == 0 and hit.replays == hit.steps
    assert hit.step_launches == per_step
    assert torch.equal(hit.codes, fresh.codes) and hit.steps == fresh.steps
    assert torch.equal(hit_gen.get_state(), fresh_gen.get_state())
    if sampler == "default":
        assert not torch.equal(hit.codes, first.codes)


def test_second_generate_stream_with_the_key_captures_nothing(paths):
    pipe, params, kwargs, _, _ = paths["bf16"]
    engine = DecodeEngine(pipe.model)
    prefix = pipe.prepare_conditioning(pipe.make_cond_dict(text=TEXT))
    kw = dict(max_new_tokens=140, sampling_params=SAMPLERS["default"][0], chunk_steps=43)
    runs = [list(engine.generate_stream(params, prefix,
                                        generator=torch.Generator("cuda").manual_seed(5), **kw))
            for _ in range(2)]
    assert runs[0][-1].capture_seconds > 0 and runs[1][-1].capture_seconds == 0
    assert (engine.captures, engine.hits) == (1, 1)
    assert torch.equal(runs[0][-1].codes, runs[1][-1].codes)


@pytest.mark.parametrize("path", ["bf16", "int8", "hybrid"])
def test_nan_in_the_entry_between_generates_changes_nothing(paths, path):
    """Every buffer of the entry (cache, stage, scales, SSM and conv state,
    delayed codes, counters, device scalars, logit bias) set to NaN (or
    garbage for integers) between two generates: the second's codes equal
    a fresh engine's (the transformer's stage flushes once, at 128 steps)."""
    pipe, params, kwargs, _, _ = paths[path]
    engine = DecodeEngine(pipe.model, **kwargs)
    _cached_generate(engine, pipe, params, "default", 5)
    (entry,) = engine._entries
    s = entry.state
    with torch.inference_mode():
        for t in [*s.cache.values(), s.delayed, s.remaining, s.stopping, s.stop_offset,
                  s.offset_t, s.stage_scalars, entry.logit_bias]:
            if t is not None:
                t.fill_(float("nan") if t.is_floating_point()
                        else (-7 if t.dtype != torch.bool else 1))
    hit, _ = _cached_generate(engine, pipe, params, "default", 6)
    fresh, _ = _cached_generate(DecodeEngine(pipe.model, **kwargs), pipe, params, "default", 6)
    assert engine.hits == 1 and hit.capture_seconds == 0
    assert torch.equal(hit.codes, fresh.codes)


@pytest.mark.parametrize("path", ["bf16", "hybrid"])
def test_batch_4_rows_are_valid(paths, path):
    """A CFG batch of 8 rows (4 texts, left-padded to one bucket) through
    the graph: codes in range and every row's frames, and a second batch-4
    run with the key replays it to the same codes."""
    pipe, params, kwargs, _, _ = paths[path]
    engine = DecodeEngine(pipe.model, **kwargs)
    res, _ = _cached_generate(engine, pipe, params, "greedy", 5, batch=4, max_new_tokens=60)
    assert res.codes.shape == (4, 9, 60) and res.replays == res.steps - 1
    assert int(res.codes.min()) >= 0 and int(res.codes.max()) < 1024
    assert res.valid_lengths.tolist() == [60] * 4
    again, _ = _cached_generate(engine, pipe, params, "greedy", 6, batch=4, max_new_tokens=60)
    assert again.capture_seconds == 0 and torch.equal(again.codes, res.codes)


@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_rope_table_on_the_card_equals_the_cpu(dev, head_dim):
    """The frequencies and the table on the card are the CPU's bits, and
    the table is within 2e-7 of its definition."""
    from rope_oracle import rope_table_fp64  # tests/, on the path of its test modules
    from zonos_vibes_tpu_torch.ops.rope import rope_freqs, rope_table

    assert torch.equal(rope_freqs(head_dim, device=dev).cpu(), rope_freqs(head_dim))
    table = rope_table(head_dim, device=dev)
    assert table.device.type == "cuda" and torch.equal(table.cpu(), rope_table(head_dim))
    exact, _, _ = rope_table_fp64(head_dim)
    np.testing.assert_allclose(table.cpu().numpy(), exact, rtol=0, atol=2e-7)
