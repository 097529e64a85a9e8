"""The port's int8 serving path (``ops/quant``, the int8 matmul and int8-KV
decode-attention wrappers, the int8 model pieces and the int8 KV cache)
against the JAX package, on the CPU.

Inputs are made with numpy from seeds and handed to both sides. Everything
runs in fp32 with JAX at ``highest`` matmul precision. Tolerances: the
quantized values and scales are bit-identical (both round half to even in
fp32); products and attention agree to 1e-5 (the same fp32 arithmetic,
summed in another order), model outputs to 2e-5 as in
``tests/test_torch_model.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.models import backbone as jbb
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops import quant as jquant
from zonos_vibes_tpu.ops.pallas.decode_attention import decode_attention_pallas_layered_q
from zonos_vibes_tpu.ops.pallas.qmm import qmm_int8_pallas
from zonos_vibes_tpu.utils.checkpoint import save_params_cache
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.models import backbone as tbb
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops import quant
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.decode_attention import decode_attention_layered_q
from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8
from zonos_vibes_tpu_torch.ops.rope import rope_table
from zonos_vibes_tpu_torch.utils.checkpoint import load_params_cache, params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-5, atol=2e-5)
BB = dict(d_model=64, n_layer=2, attn_mlp_d_intermediate=128)
HEADS = {"num_heads": 4, "num_heads_kv": 2}
PC = {"projection": "linear",
      "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}
JTINY = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                    prefix_conditioner=PrefixConditionerConfig.from_dict(PC))
TTINY = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                         prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _time_major(x):
    """JAX ``[..., Hkv, D, T]`` -> port ``[..., T, Hkv*D]``."""
    x = np.asarray(x)
    *lead, h, d, t = x.shape
    return np.moveaxis(x, -1, -3).reshape(*lead, t, h * d)


# -- quantization ------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((48, 80), np.float32), ((3, 64, 96), np.float32),
                                         ((2, 3, 40, 32), "bfloat16")])
def test_quantize_weight_bit_identical(shape, dtype):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 3.0, shape[-1])
    w[..., 5] = 0.0  # an all-zero column takes scale 1
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = jquant.quantize_weight(jw, bits=8)
    got = quant.quantize_weight(params_from_jax({"w": jax.device_get(jw)})["w"])
    assert got["weight_int8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert got["scale"].shape == (*shape[:-2], 1, shape[-1])
    np.testing.assert_array_equal(got["weight_int8"].numpy(), np.asarray(want["weight_int8"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert (got["scale"][..., 5] == 1.0).all()


def test_dequantize_weight_round_trips():
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((2, 64, 48)).astype(np.float32))
    p = quant.quantize_weight(w)
    deq = quant.dequantize_weight(p, torch.float32)
    # Round to nearest: every weight within half a step of its column's scale.
    assert ((deq - w).abs() <= p["scale"] / 2 * (1 + 1e-6)).all()
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jquant.dequantize_weight(
            {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jnp.float32)))
    # Quantizing the dequantized weight gives the same int8 values back.
    again = quant.quantize_weight(deq)
    np.testing.assert_array_equal(again["weight_int8"].numpy(), p["weight_int8"].numpy())


def test_quantize_kv_matches_jax():
    """Per-(position, head) int8 over head dim; JAX time-minor, port time-major."""
    rng = np.random.default_rng(3)
    L, B, H, D, T = 2, 2, 2, 16, 24
    x = rng.standard_normal((L, B, H, D, T)).astype(np.float32) * 2.0
    x[0, 1, 1, :, 4] = 0.0
    jq, js = jquant.quantize_kv(jnp.asarray(x), dh_axis=3)  # [L,B,H,D,T], [L,B,H,T]
    port_rows = torch.from_numpy(_time_major(x))  # [L, B, T, H*D]
    q, s = quant.quantize_kv(port_rows.unflatten(-1, (H, D)), dh_axis=-1)
    np.testing.assert_array_equal(q.flatten(-2).numpy(), _time_major(jq))
    np.testing.assert_array_equal(s.numpy(), np.moveaxis(np.asarray(js), -1, -2))
    assert s[0, 1, 4, 1] == 1.0


def test_unported_modes_raise():
    """Every JAX mode is ported; what raises are the two refusals where JAX
    goes on silently: ``capture_fc2`` during decode (JAX's decode scan
    mis-shapes the K/V columns it emits), and an AWQ energy the fold would
    skip (fc2 not int4, or the hybrid backbone). Also widths JAX lacks."""
    model = ZonosModel(TTINY)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    cache = model.allocate_cache(2, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="decode"):
        model.backbone.forward(params["backbone"], torch.zeros(2, 1, 64), cache, 3,
                               model.rope_for("cpu"), 0, capture_fc2=True)
    energy = torch.ones(2, 128)
    for kw in (dict(bits=8), dict(bits=8, mlp_bits=4, fc2_bits=8), dict(bits=4, fc2_bits=8)):
        with pytest.raises(ValueError, match="fc2"):
            quant.quantize_zonos_params(params, awq_energy=energy, **kw)
    hybrid = {"mamba": {"in_proj": {"weight": torch.zeros(1, 8, 8)}}, "norm_f": {}}
    with pytest.raises(ValueError, match="hybrid"):
        quant.quantize_backbone_params(hybrid, bits=8, mlp_bits=4, awq_energy=energy)
    with pytest.raises(ValueError):
        quant.quantize_weight(torch.zeros(16, 16), bits=2)
    # The modes themselves run: int4 fc2 with the fold.
    out = quant.quantize_zonos_params(params, mlp_bits=4, awq_energy=energy)
    assert "weight_int4" in out["backbone"]["layers"]["fc2"]


# -- kernel row 4: the int8 matmul's plain version ----------------------------


@pytest.mark.parametrize("M", [1, 2, 5, 17])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("N", [1024, 160])  # divides the Pallas block of 512, and not
def test_qmm_int8_plain_matches_pallas_and_proj_matmul(M, G, N):
    rng = np.random.default_rng(M * 100 + G * 10 + N)
    K = 96
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, size=(G, K, N)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, size=(G, 1, N)).astype(np.float32)
    before = dict(build.LAUNCHES)
    got = qmm_int8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert build.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == (M, G, N) and got.dtype == torch.float32
    for g in range(G):
        want = qmm_int8_pallas(jnp.asarray(x), jnp.asarray(w[g]), jnp.asarray(scale[g]),
                               interpret=True)
        np.testing.assert_allclose(got[:, g].numpy(), np.asarray(want), **TOL)
        leaf = {"weight_int8": jnp.asarray(w[g]), "scale": jnp.asarray(scale[g])}
        np.testing.assert_allclose(
            quant.proj_matmul(torch.from_numpy(x), {k: torch.from_numpy(np.array(v))
                                                    for k, v in leaf.items()}).numpy(),
            np.asarray(jquant.proj_matmul(jnp.asarray(x), leaf)), **TOL)


@pytest.mark.parametrize("M", [16, 65])  # the tensor-core path's 16- and 64-row tile edges
@pytest.mark.parametrize("G", [1, 3])
def test_qmm_int8_plain_matches_pallas_at_tile_edges(M, G):
    """K = 320: not a multiple of the kernel's 128-row split. x holds small
    integers, so every dot is exact in fp32 whatever the summation order and
    the two sides differ only if a row, column or scale is misplaced."""
    rng = np.random.default_rng(M * 10 + G)
    K, N = 320, 160
    x = rng.integers(-8, 9, size=(M, K)).astype(np.float32)
    w = rng.integers(-127, 128, size=(G, K, N)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, size=(G, 1, N)).astype(np.float32)
    got = qmm_int8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert got.shape == (M, G, N) and got.dtype == torch.float32
    for g in range(G):
        want = qmm_int8_pallas(jnp.asarray(x), jnp.asarray(w[g]), jnp.asarray(scale[g]),
                               interpret=True)
        np.testing.assert_allclose(got[:, g].numpy(), np.asarray(want), **TOL)


def test_qmm_int8_rejects_bad_inputs():
    x = torch.zeros(2, 32)
    w = torch.zeros(1, 32, 16, dtype=torch.int8)
    s = torch.ones(1, 1, 16)
    for args in ((x, w.float(), s), (x, w, s.double()), (x, w, s[:, :, :8]),
                 (x[:, :16], w, s), (x[0], w, s), (x.long(), w, s)):
        with pytest.raises(ValueError):
            qmm_int8(*args)
    with pytest.raises(ValueError):
        qmm_int8(x, w, s, torch.int8)
    # A tensor that lies neither on the CPU nor on a card: no plain path.
    with pytest.raises(ValueError, match="CUDA"):
        qmm_int8(x.to("meta"), w.to("meta"), s.to("meta"))


# -- kernel row 5: int8-KV decode attention's plain version --------------------


@pytest.fixture(scope="module")
def q_decode_inputs():
    """As tests/test_pallas_decode.py:_rand_staged, with the prefix quantized
    by the JAX package's quantize_kv."""
    rng = np.random.default_rng(9)
    L, B, Hq, Hkv, D, T, STAGE = 2, 2, 8, 2, 64, 384, 16

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    kc, vc = f(L, B, Hkv, D, T), f(L, B, Hkv, D, T)
    qk, sk = jquant.quantize_kv(jnp.asarray(kc), dh_axis=3)
    qv, sv = jquant.quantize_kv(jnp.asarray(vc), dh_axis=3)
    jx = dict(q=f(B, 1, Hq, D), k_cache=np.asarray(qk), v_cache=np.asarray(qv),
              k_scale=np.asarray(sk), v_scale=np.asarray(sv), k_stage=f(L, B, STAGE, Hkv * D),
              v_stage=f(L, B, STAGE, Hkv * D), k_cur=f(B, Hkv, D, 1), v_cur=f(B, Hkv, D, 1))
    port = dict(q=jx["q"], k_cache=_time_major(jx["k_cache"]),
                v_cache=_time_major(jx["v_cache"]),
                k_scale=np.moveaxis(jx["k_scale"], -1, -2).copy(),
                v_scale=np.moveaxis(jx["v_scale"], -1, -2).copy(),
                k_stage=jx["k_stage"], v_stage=jx["v_stage"],
                k_cur=jx["k_cur"].reshape(B, Hkv * D), v_cur=jx["v_cur"].reshape(B, Hkv * D))
    return jx, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in port.items()}


@pytest.mark.parametrize("flushed_end", [0, 1, 127, 128, 300])
@pytest.mark.parametrize("stage_len", [0, 5, 15])
@pytest.mark.parametrize("layer", [0, 1])
def test_decode_attention_q_plain_matches_pallas(q_decode_inputs, flushed_end, stage_len,
                                                 layer):
    jx, port = q_decode_inputs
    want = decode_attention_pallas_layered_q(
        *(jnp.asarray(jx[k]) for k in ("q", "k_cache", "v_cache", "k_scale", "v_scale",
                                       "k_stage", "v_stage", "k_cur", "v_cur")),
        jnp.int32(flushed_end), jnp.int32(stage_len), jnp.int32(layer),
        block=128, interpret=True)
    # Scales at or past flushed_end are never read: poison them.
    poisoned = dict(port)
    for name in ("k_scale", "v_scale"):
        poisoned[name] = port[name].clone()
        poisoned[name][:, :, flushed_end:] = float("nan")
    scalars = torch.tensor([flushed_end, stage_len, layer], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    got = decode_attention_layered_q(**poisoned, scalars=scalars)
    assert build.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_q_rejects_bad_inputs(q_decode_inputs):
    _, x = q_decode_inputs
    sc = torch.tensor([4, 1, 0], dtype=torch.int32)
    for name, bad in (("k_cache", x["k_cache"].float()), ("k_scale", x["k_scale"].double()),
                      ("v_scale", x["v_scale"][:, :, :-1]), ("k_cur", x["k_cur"][:1])):
        with pytest.raises(ValueError):
            decode_attention_layered_q(**{**x, name: bad}, scalars=sc)
    with pytest.raises(ValueError):
        decode_attention_layered_q(**x, scalars=sc.long())
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_layered_q(**{k: v.to("meta") for k, v in x.items()},
                                   scalars=sc.to("meta"))


# -- model pieces and the backbone with int8 weights and an int8 cache --------


@pytest.fixture(scope="module")
def int8_pair():
    """Tiny fp32 weights with random norms, quantized by each package from
    the same values (heads and embeddings too)."""
    jmodel = JModel(JTINY)
    rng = np.random.default_rng(5)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32),
        jax.device_get(jmodel.init(jax.random.key(0), jnp.float32)))
    jparams = jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                                           heads=True, embeddings=True)
    tparams = quant.quantize_zonos_params(params_from_jax(np_params), heads=True,
                                          embeddings=True)
    return jmodel, jparams, ZonosModel(TTINY), tparams


def test_port_quantizes_the_model_as_jax(int8_pair):
    _, jparams, _, tparams = int8_pair
    want = dict(_leaves(params_from_jax(jax.device_get(jparams))))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    assert "/backbone/layers/fc2/weight_int8" in got and "/heads/scale" in got
    assert "/embeddings/act_dtype" in got
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name


def test_int8_embed_and_heads(int8_pair):
    jmodel, jparams, tmodel, tparams = int8_pair
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1026, size=(2, 9, 3))
    got = tmodel.embed_codes(tparams, torch.from_numpy(codes))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.embed_codes(jparams, jnp.asarray(codes))), **TOL)
    hidden = rng.standard_normal((2, 6, 64)).astype(np.float32)
    got = tmodel.apply_heads(tparams, torch.from_numpy(hidden))
    assert got.shape == (2, 9, 6, 1152) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.apply_heads(jparams, jnp.asarray(hidden))),
                               **TOL)


def test_int8_backbone_with_int8_cache(int8_pair):
    """Hidden states after a prefill and 12 staged decode steps with int8
    projections and an int8 KV cache, and the dequantized cache after the
    prefill and after the flush of an 8-row stage."""
    jmodel, jparams, tmodel, tparams = int8_pair
    cfg_j, cfg_t = jmodel.config.backbone, tmodel.config.backbone
    rng = np.random.default_rng(2)
    L, B, T, S, STAGE, H, Dh = 2, 2, 32, 5, 8, 2, 16
    jcache = jbb.allocate_kv_cache(cfg_j, B, T, jnp.float32, kv_int8=True)
    jcache["k_stage"] = jnp.zeros((L, B, STAGE, H * Dh))
    jcache["v_stage"] = jnp.zeros((L, B, STAGE, H * Dh))
    tcache = tbb.allocate_kv_cache(cfg_t, B, T, torch.float32, "cpu", kv_int8=True)
    tcache["k_stage"] = torch.zeros(L, B, STAGE, H * Dh)
    tcache["v_stage"] = torch.zeros(L, B, STAGE, H * Dh)
    assert tcache["k"].dtype == torch.int8 and (tcache["k_scale"] == 1).all()
    jfwd = jax.jit(functools.partial(jbb.transformer_forward, cfg=cfg_j))
    table = rope_table(Dh)

    def check_cache(when):
        for name in ("k", "v"):
            want = np.asarray(jcache[name], np.float32) * np.asarray(
                jcache[name + "_scale"])[:, :, :, None, :]
            got = tcache[name].float().unflatten(-1, (H, Dh)) * tcache[name + "_scale"][..., None]
            np.testing.assert_allclose(got.flatten(-2).numpy(), _time_major(want),
                                       **MODEL_TOL, err_msg=f"{name} {when}")
            np.testing.assert_allclose(tcache[name + "_stage"].numpy(),
                                       np.asarray(jcache[name + "_stage"]), **MODEL_TOL)

    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    want, jcache = jfwd(jparams["backbone"], hidden=jnp.asarray(x), cache=jcache,
                        offset=jnp.int32(0), lengths_per_sample=jnp.zeros((B,), jnp.int32))
    got = tbb.transformer_forward(tparams["backbone"], cfg_t, torch.from_numpy(x), tcache, 0,
                                  table)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    check_cache("after the prefill")

    stage_base = S
    for step in range(12):
        pos = S + step
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        want, jcache = jfwd(jparams["backbone"], hidden=jnp.asarray(x), cache=jcache,
                            offset=jnp.int32(pos), lengths_per_sample=jnp.full((B,), pos),
                            stage_base=jnp.int32(stage_base))
        got = tbb.transformer_forward(tparams["backbone"], cfg_t, torch.from_numpy(x), tcache,
                                      pos, table, stage_base=stage_base)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL,
                                   err_msg=f"step {step}")
        if pos + 1 - stage_base == STAGE:
            jcache = jbb.flush_kv_stage(jcache, jnp.int32(stage_base))
            tbb.flush_kv_stage(tcache, stage_base)
            stage_base += STAGE
            check_cache("after the flush")
    assert stage_base == S + STAGE  # one flush crossed, then read by 4 steps


def test_int8_params_cache_loads(tmp_path, int8_pair):
    """An int8 JAX tree (bf16 norms marker included) saved by
    ``save_params_cache`` loads bit-exact through ``load_params_cache``, and
    the fp32-activation tree gives JAX's logits."""
    jmodel, jparams, tmodel, _ = int8_pair
    jbf16 = jquant.quantize_zonos_params(jmodel.init(jax.random.key(1), jnp.bfloat16),
                                         heads=True, embeddings=True)
    path = tmp_path / "int8.npz"
    save_params_cache(str(path), jbf16)
    got = dict(_leaves(load_params_cache(str(path))))
    want = dict(_leaves(params_from_jax(jax.device_get(jbf16))))
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert got["/embeddings/act_dtype"].dtype == torch.bfloat16
    assert got["/embeddings/act_dtype"].shape == ()
    assert got["/backbone/layers/in_proj/weight_int8"].dtype == torch.int8

    path32 = tmp_path / "int8_f32.npz"
    save_params_cache(str(path32), jparams)
    tparams = load_params_cache(str(path32))
    hidden = np.random.default_rng(4).standard_normal((2, 6, 64)).astype(np.float32)
    want_logits, _ = jmodel.compute_logits(
        jparams, jnp.asarray(hidden), jmodel.allocate_cache(2, 16, jnp.float32, kv_int8=True),
        jnp.int32(0), jnp.zeros((2,), jnp.int32), 2.0)
    got_logits = tmodel.compute_logits(
        tparams, torch.from_numpy(hidden),
        tmodel.allocate_cache(2, 16, torch.float32, "cpu", kv_int8=True), 0, 2.0,
        rope_table(16))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-4)
