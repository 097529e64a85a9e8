"""The port's sequence parallelism (``zonos_vibes_tpu_torch/parallel/``) against
the JAX package, on the CPU.

Ranks are spawned gloo processes (``torch_parallel_workers``), one spawn per
world size. Ring attention, Ulysses and the time-sharded decode attention
give JAX's outputs on the same numpy inputs within 1e-5; the
sequence-parallel prefill of the whole stack gives JAX's hidden states and
decode cache within 2e-5 (the tolerance of ``tests/test_sp_prefill.py``),
over whole weights and over tensor-parallel slices gathered layer by layer;
and ``ParallelEngine(sp_prefill=...)`` takes the route for a long
continuation and gives JAX's greedy codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parallel_jax import jax_conditioning, jax_config, jax_tree, random_params
from torch_parallel_workers import Ranks, run_tasks
from zonos_vibes_tpu.config import MeshConfig as JMeshConfig
from zonos_vibes_tpu.engine.generate import DecodeEngine as JDecodeEngine
from zonos_vibes_tpu.models.backbone import allocate_kv_cache, transformer_forward
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.parallel.engine import ParallelEngine as JParallelEngine
from zonos_vibes_tpu.parallel.ring_attention import (
    ring_attention_prefill,
    sp_decode_attention,
    ulysses_prefill,
)
from zonos_vibes_tpu.parallel.sharding import make_mesh
from zonos_vibes_tpu.parallel.sp_prefill import sp_prefill_forward

ATTN_B, ATTN_S, ATTN_T, ATTN_D, SEQ_END = 2, 32, 64, 16, 40
ATTN_HEADS = (4, 2)
SP_HEADS, SP_S, SP_T = (4, 2), 32, 64  # tests/test_sp_prefill.py's backbone and shapes
# The engine route: a 24-frame audio prefix makes a 30-position prefill.
ENGINE_HEADS, PREFIX_FRAMES, MAX_NEW, THRESHOLD = (8, 4), 24, 10, 16
PHONEMES = [[2, 10, 20, 30, 3]]
# By world size: (attention degree, prefill (method, tp weights) cases, engine runs).
# Tensor-parallel slices need Hkv % n == 0: 2 ranks only at 4/2 heads.
PLAN = {4: ("ring", [("ring", False)], [((1, 4, 1, 1), "ring")]),
        2: ("ulysses", [("ulysses", False), ("ulysses", True), ("ring", True)],
            [((1, 2, 1, 1), "ulysses"), ((1, 2, 1, 1), "ring")])}


def _attention_inputs():
    rng = np.random.default_rng(0)
    B, S, T, D = ATTN_B, ATTN_S, ATTN_T, ATTN_D
    Hq, Hkv = ATTN_HEADS
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    # The time-sharded decode cache in the port's time-major layout [B, T, Hkv * D].
    kc = rng.standard_normal((B, T, Hkv * D)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hkv * D)).astype(np.float32)
    return q, k, v, kc, vc


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    sp_cfg = jax_config(2, SP_HEADS)
    sp_backbone = random_params(sp_cfg, 2)["backbone"]
    x = (np.random.default_rng(3).standard_normal((2, SP_S, 64)) * 0.3).astype(np.float32)
    eng_cfg = jax_config(2, ENGINE_HEADS)
    eng_params = random_params(eng_cfg, 4)
    cond = jax_conditioning(eng_cfg, eng_params, PHONEMES)
    prefix = np.random.default_rng(4).integers(0, 1024, (1, 9, PREFIX_FRAMES))
    attn = _attention_inputs()
    spawned = {}
    for world, (method, prefills, engine_runs) in PLAN.items():
        runs = [dict(mesh=m, sp=sp, sp_threshold=THRESHOLD, prefix=prefix,
                     max_new_tokens=MAX_NEW) for m, sp in engine_runs]
        tasks = [("sp_attention", (world, *attn, SEQ_END))]
        tasks += [("sp_prefill", (world, meth, 2, SP_HEADS, sp_backbone, x, SP_T, tp))
                  for meth, tp in prefills]
        tasks.append(("generate_runs", (2, ENGINE_HEADS, eng_params, cond, runs)))
        spawned[world] = Ranks(run_tasks, world, (tasks,), tmp_path_factory.mktemp("pg"))
    return sp_cfg, sp_backbone, x, eng_cfg, eng_params, cond, prefix, attn, spawned


@pytest.fixture(scope="module")
def refs(setup):
    """JAX: ring (degree 4) and Ulysses (degree 2) attention, the time-sharded
    decode, the SP prefill of the stack and the dense prefill, and the
    engine's greedy codes (DecodeEngine and ParallelEngine with sp_prefill)."""
    sp_cfg, sp_backbone, x, eng_cfg, eng_params, cond, prefix, attn, _ = setup
    q, k, v, kc, vc = (jnp.asarray(a) for a in attn)
    B, T, D = ATTN_B, ATTN_T, ATTN_D
    Hkv = ATTN_HEADS[1]

    def jax_cache(c):  # port [B, T, Hkv * D] -> JAX [B, Hkv, D, T]
        return c.reshape(B, T, Hkv, D).transpose(0, 2, 3, 1)

    out = {}
    for n, method in ((4, "ring"), (2, "ulysses")):
        mesh = make_mesh(JMeshConfig(data=1, model=n))
        out["ring", n] = np.asarray(ring_attention_prefill(q, k, v, mesh))
        if method == "ulysses":
            out["ulysses", n] = np.asarray(ulysses_prefill(q, k, v, mesh))
        out["decode", n] = np.asarray(sp_decode_attention(q[:, :1], jax_cache(kc), jax_cache(vc),
                                                          SEQ_END, mesh))
    params = jax_tree(sp_backbone)
    lengths = jnp.zeros((2,), jnp.int32)
    for n, method in ((4, "ring"), (2, "ulysses")):
        cache = allocate_kv_cache(sp_cfg.backbone, 2, SP_T, jnp.float32)
        h, c = sp_prefill_forward(params, sp_cfg.backbone, jnp.asarray(x), cache, lengths,
                                  make_mesh(JMeshConfig(data=1, model=n)), method=method)
        out["sp_prefill", n, method] = np.asarray(h), np.asarray(c["k"]), np.asarray(c["v"])
    cache = allocate_kv_cache(sp_cfg.backbone, 2, SP_T, jnp.float32)
    h, c = transformer_forward(params, sp_cfg.backbone, jnp.asarray(x), cache, jnp.int32(0),
                               lengths)
    out["dense"] = np.asarray(h), np.asarray(c["k"]), np.asarray(c["v"])

    model = JModel(eng_cfg)
    kw = dict(key=jax.random.key(5), max_new_tokens=MAX_NEW,
              sampling_params=JSampling(temperature=0.0))
    jparams = jax_tree(eng_params)
    out["solo"] = np.asarray(JDecodeEngine(model).generate(jparams, cond, jnp.asarray(prefix),
                                                           **kw).codes)
    for n in (4, 2):
        eng = JParallelEngine(model, JMeshConfig(data=1, model=n), jparams, sp_prefill="ring",
                              sp_threshold=THRESHOLD)
        out["jax_sp", n] = np.asarray(eng.generate(cond, jnp.asarray(prefix), **kw).codes)
    return out


@pytest.fixture(scope="module", params=sorted(PLAN), ids=lambda w: f"world{w}")
def ranks(request, setup, refs):
    return request.param, setup[-1][request.param].results()


def _port_cache(c, heads_of):
    """The port's time-major cache ``[L, B, T, h * Dh]`` -> JAX's ``[L, B, h, Dh,
    T]``."""
    L, B, T, W = c.shape
    return c.reshape(L, B, T, heads_of, W // heads_of).transpose(0, 1, 3, 4, 2)


def test_sp_attention_matches_jax(ranks, refs):
    """Ring (and, at degree 2, Ulysses) attention chunks and the time-sharded
    decode against JAX's within 1e-5."""
    world, results = ranks
    names = ["ring"] + (["ulysses"] if PLAN[world][0] == "ulysses" else [])
    for name in names:
        got = np.concatenate([r[0][name] for r in results], axis=1)
        np.testing.assert_allclose(got, refs[name, world], rtol=1e-5, atol=1e-5)
    for r in results:  # every rank holds the whole decode output
        np.testing.assert_allclose(r[0]["decode"], refs["decode", world], rtol=1e-5, atol=1e-5)


def test_sp_prefill_matches_jax(ranks, refs):
    """Hidden states and cache against JAX's dense prefill and, for its own
    method and degree, JAX's SP prefill: whole weights with every head
    cached; tensor-parallel slices with each rank caching its heads."""
    world, results = ranks
    Hkv = SP_HEADS[1]
    for i, (method, tp) in enumerate(PLAN[world][1]):
        per_rank = [r[1 + i] for r in results]
        h = np.concatenate([p["out"] for p in per_rank], axis=1)
        if tp:  # rank r holds kv heads [r Hkv / n, (r + 1) Hkv / n)
            k = np.concatenate([_port_cache(p["k"], Hkv // world) for p in per_rank], axis=2)
            v = np.concatenate([_port_cache(p["v"], Hkv // world) for p in per_rank], axis=2)
        else:
            for p in per_rank[1:]:
                np.testing.assert_array_equal(p["k"], per_rank[0]["k"])
            k, v = _port_cache(per_rank[0]["k"], Hkv), _port_cache(per_rank[0]["v"], Hkv)
        wants = [refs["dense"]]
        if method == PLAN[world][0]:
            wants.append(refs["sp_prefill", world, method])
        for want_h, want_k, want_v in wants:
            np.testing.assert_allclose(h, want_h, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(k, want_k, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(v, want_v, rtol=2e-5, atol=2e-5)


def test_sp_engine_route_codes_equal_jax(ranks, refs):
    """``ParallelEngine(sp_prefill=...)``: the 30-position first prefill takes
    the sequence-parallel route once, and the greedy codes equal JAX's
    DecodeEngine and JAX's ParallelEngine(sp_prefill="ring")."""
    world, results = ranks
    np.testing.assert_array_equal(refs["jax_sp", world], refs["solo"])
    for rank, r in enumerate(results):
        gen = r[-1]
        assert gen["sp_calls"] == [1] * len(PLAN[world][2])
        for i, codes in enumerate(gen["codes"]):
            np.testing.assert_array_equal(codes, refs["solo"], err_msg=f"run {i} rank {rank}")
