"""The port's int4 quantization (``ops/quant``: grouped scales, the clip
search, mixed widths, GPTQ, the AWQ fold), the packed-int4 matmul's plain
version, ``capture_fc2``, int4 checkpoints and the quality gate's measures,
against the JAX package on the CPU.

Inputs are made with numpy from seeds and handed to both sides; everything
runs in fp32 with JAX at ``highest`` matmul precision. Tolerances: quantized
values and scales bit-identical (both round half to even in fp32; the clip
search's errors are summed in another order, so a column whose two best
candidates' errors lie within 1e-6 relative could pick another clip: such
columns are counted, and there are none at these seeds); products 1e-5
relative; GPTQ (torch against numpy, fp32 sweeps in another order) at least
99.5% of the values equal, scales within 1e-5 relative and the
reconstruction error within 1%; model outputs 1e-5.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.engine import generate as jgen
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops import quant as jquant
from zonos_vibes_tpu.ops.delay_pattern import apply_delay_pattern as japply_delay
from zonos_vibes_tpu.ops.rope import expand_rope_table, rope_table as jrope_table
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.utils import checkpoint as jckpt
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine import generate as tgen
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops import quant
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.qmm import pack_int4, qmm_int4, unpack_int4
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils.checkpoint import (
    load_params_cache,
    params_from_jax,
    save_params_cache,
)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
# fc1 128 -> 512 and fc2 256 -> 128: fc2 has two 128-row groups.
BB = dict(d_model=128, n_layer=2, attn_mlp_d_intermediate=256)
HEADS = {"num_heads": 4, "num_heads_kv": 2}
PC = {"projection": "linear",
      "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}
JTINY = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                    prefix_conditioner=PrefixConditionerConfig.from_dict(PC))
TTINY = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                         prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
PHONEMES = [[2, 10, 20, 30, 40, 3]]
# The quality gate's modes as quantize_zonos_params keywords.
MODES = {"int8": dict(bits=8), "int4": dict(bits=8, mlp_bits=4),
         "int4full": dict(bits=4, mlp_bits=4), "int4fc1": dict(bits=8, mlp_bits=4, fc2_bits=8),
         "int4fc2": dict(bits=8, mlp_bits=8, fc2_bits=4),
         "int4g64": dict(bits=8, mlp_bits=4, int4_group=64)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def _jax_int4(leaf):
    """A JAX int4 leaf's values as int8 numpy."""
    return np.asarray(jnp.asarray(leaf["weight_int4"]).astype(jnp.int8))


@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(JModel(JTINY).init(jax.random.key(0), jnp.float32))


# -- quantize_weight -----------------------------------------------------------

def _clip_near_ties(w32, qmax, group, clip_search):
    """Scale columns whose two best clip candidates' errors lie within 1e-6
    relative (numpy, JAX's arithmetic)."""
    if not clip_search:
        return 0
    if group:
        w32 = w32.reshape(*w32.shape[:-2], -1, group, w32.shape[-1])
    absmax = np.max(np.abs(w32), axis=-2, keepdims=True)
    errs = []
    for c in quant.CLIPS:
        s = np.where(absmax > 0, absmax * c / qmax, 1.0).astype(np.float32)
        q = np.clip(np.round(w32 / s), -qmax, qmax)
        errs.append(((q * s - w32) ** 2).sum(axis=-2))
    errs = np.sort(np.stack(errs), axis=0)
    tied = errs[1] - errs[0] <= 1e-6 * errs[0]
    return int((tied & (absmax[..., 0, :] > 0)).sum())  # a zero column has scale 1 whatever c


@pytest.mark.parametrize("shape,group,clip", [
    ((48, 80), None, False), ((48, 80), None, True),
    ((3, 256, 96), 128, False), ((3, 256, 96), 128, True), ((3, 256, 96), 64, True),
    ((3, 256, 96), 32, True), ((3, 256, 96), 32, False)])
def test_quantize_weight_int4_matches_jax(shape, group, clip):
    rng = np.random.default_rng(shape[-1] + (group or 0) + clip)
    w = (rng.standard_normal(shape) * rng.uniform(0.05, 2.0, shape[-1])).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column takes scale 1
    assert _clip_near_ties(w, 7.0, group, clip) == 0
    want = jquant.quantize_weight(jnp.asarray(w), bits=4, group_size=group, clip_search=clip)
    got = quant.quantize_weight(torch.from_numpy(w), bits=4, group_size=group, clip_search=clip)
    assert got["weight_int4"].dtype == torch.uint8 and got["scale"].dtype == torch.float32
    assert got["weight_int4"].shape == (*shape[:-1], shape[-1] // 2)
    G = shape[-2] // group if group else 1
    assert got["scale"].shape == (*shape[:-2], G, 1, shape[-1])
    np.testing.assert_array_equal(unpack_int4(got["weight_int4"]).numpy(),
                                  _jax_int4(want).reshape(shape))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]).reshape(got["scale"].shape))
    assert (got["scale"][..., 3] == 1.0).all()
    # The fake leaf: JAX's dequantized weight in the weight's dtype.
    fake = quant.quantize_weight(torch.from_numpy(w), bits=4, group_size=group, clip_search=clip,
                                 fake=True)
    jfake = jquant.quantize_weight(jnp.asarray(w), bits=4, group_size=group, clip_search=clip,
                                   fake=True)
    np.testing.assert_array_equal(fake["weight"].numpy(), np.asarray(jfake["weight"]))
    np.testing.assert_array_equal(
        quant.dequantize_weight(got, torch.float32).numpy(), np.asarray(jfake["weight"]))


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-7, 8, size=(3, 40, 64)).astype(np.int8))
    q[0, 0, :15] = torch.arange(-7, 8, dtype=torch.int8)
    packed = pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 40, 32)
    assert torch.equal(unpack_int4(packed), q)
    assert int(packed[0, 0, 0]) == ((-6 & 0xF) << 4) | (-7 & 0xF)  # low nibble: even column
    assert torch.equal(unpack_int4(packed[1]), q[1])  # a layer slice of the stack
    with pytest.raises(ValueError):
        pack_int4(q[..., :63])


# -- the packed-int4 matmul's plain version --------------------------------------

@pytest.mark.parametrize("M", [1, 2, 5, 17])
@pytest.mark.parametrize("group", [None, 64])
def test_qmm_int4_plain_matches_jax_proj_matmul(M, group):
    rng = np.random.default_rng(M * 10 + (group or 0))
    K, N = 256, 96
    w = rng.standard_normal((K, N)).astype(np.float32) / K ** 0.5
    x = rng.standard_normal((M, K)).astype(np.float32)
    jleaf = jquant.quantize_weight(jnp.asarray(w), bits=4, group_size=group, clip_search=True)
    tleaf = quant.quantize_weight(torch.from_numpy(w), bits=4, group_size=group,
                                  clip_search=True)
    want = np.asarray(jquant.proj_matmul(jnp.asarray(x), jleaf))
    before = dict(build.LAUNCHES)
    got = quant.proj_matmul(torch.from_numpy(x), tleaf)
    assert build.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    direct = qmm_int4(torch.from_numpy(x), tleaf["weight_int4"], tleaf["scale"])
    np.testing.assert_array_equal(direct.numpy(), got.numpy())
    # bf16 out: one rounding of the fp32 result, within one bf16 step of it.
    got16 = qmm_int4(torch.from_numpy(x).bfloat16(), tleaf["weight_int4"], tleaf["scale"])
    ref16 = qmm_int4(torch.from_numpy(x).bfloat16().float(), tleaf["weight_int4"],
                     tleaf["scale"])
    ulp = 2.0 ** (torch.floor(torch.log2(ref16.abs().clamp_min(1e-30))) - 7)
    assert got16.dtype == torch.bfloat16
    assert ((got16.float() - ref16).abs() <= ulp).all()


def test_int4_plan():
    """The kernel's launch plan from the shapes and the SM count: row tiles
    of 8 (x as mma's n8 operand), 16 or 64 rows fitted to M, tiles of
    64/128/256 columns, whole 64-row stages, K covered, no rank without rows;
    the flagship's decode and prefill shapes as swept on the card."""
    from zonos_vibes_tpu_torch.ops.cuda import qmm as qmm_mod

    for K, N in ((2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 8512),
                 (4096, 2048), (200, 96)):
        for M in (1, 2, 3, 4, 8, 16, 17, 176, 320):
            bm, tn, cs, rows = qmm_mod.int4_plan(M, K, N)
            assert bm == (8 if M <= qmm_mod.INT4_XB_M else 16 if M <= 16 else 64)
            assert tn in qmm_mod.INT4_TILES
            assert 1 <= cs <= 8 and rows % qmm_mod.INT4_BK == 0
            assert cs * rows >= K and (cs - 1) * rows < K
    assert qmm_mod.int4_plan(2, 2048, 16384) == (8, 128, 2, 1024)
    assert qmm_mod.int4_plan(2, 8192, 2048) == (8, 64, 8, 1024)
    assert qmm_mod.int4_plan(16, 8192, 2048) == (16, 64, 8, 1024)
    assert qmm_mod.int4_plan(16, 2048, 3072) == (16, 128, 8, 256)
    assert qmm_mod.int4_plan(176, 2048, 16384) == (64, 128, 1, 2048)
    assert qmm_mod.int4_plan(16, 2048, 3072, sms=16) == (16, 128, 1, 2048)  # the card's count
    with pytest.raises(ValueError):
        qmm_mod.int4_plan(0, 64, 64)


def test_qmm_int4_rejects_bad_shapes():
    x = torch.zeros(2, 64)
    w = torch.zeros(64, 16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        qmm_int4(x, w, torch.ones(3, 1, 32))  # 3 groups do not divide 64 rows
    with pytest.raises(ValueError):
        qmm_int4(x, w.view(torch.int8), torch.ones(1, 1, 32))
    with pytest.raises(ValueError):
        qmm_int4(x, w, torch.ones(1, 32))


# -- mixed widths on the transformer -----------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_zonos_params_matches_jax(np_params, mode):
    want = params_from_jax(jax.device_get(
        jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                                     **MODES[mode])))
    got = quant.quantize_zonos_params(params_from_jax(np_params), **MODES[mode])
    _assert_trees_equal(got, want)
    layers = got["backbone"]["layers"]
    w_fc2 = MODES[mode].get("fc2_bits") or MODES[mode].get("mlp_bits") or MODES[mode]["bits"]
    assert ("weight_int4" in layers["fc2"]) == (w_fc2 == 4)
    assert "weight_int8" in got["heads"]  # heads never below int8
    if mode == "int4":  # fc2's 256 rows in two 128-row groups; fc1 (128 rows) ungrouped
        assert layers["fc2"]["scale"].shape == (2, 2, 1, 128)
        assert layers["fc1"]["scale"].shape == (2, 1, 1, 512)


def test_fake_modes_match_jax(np_params):
    kw = dict(bits=8, mlp_bits=4, fake=True)
    want = params_from_jax(jax.device_get(
        jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params), **kw)))
    _assert_trees_equal(quant.quantize_zonos_params(params_from_jax(np_params), **kw), want)


# -- GPTQ and the AWQ fold ---------------------------------------------------------

def test_fc2_hessian_and_gptq_match_jax():
    rng = np.random.default_rng(11)
    D, F, N, group = 64, 256, 64, 64
    w1 = (rng.standard_normal((D, 2 * F)) / D ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((F, N)) / F ** 0.5).astype(np.float32)
    h_np = jquant.fc2_hessian_mc(w1, n_samples=1024)
    h_t = quant.fc2_hessian_mc(torch.from_numpy(w1), n_samples=1024)
    np.testing.assert_allclose(h_t.numpy(), h_np, rtol=1e-4, atol=1e-5)
    q_np, s_np = jquant._gptq_compensate(w2, h_np, 7.0, group, True)
    q_t, s_t = quant._gptq_compensate(torch.from_numpy(w2), torch.from_numpy(h_np), 7.0, group,
                                      True)
    assert (q_t.numpy() == q_np).mean() >= 0.995
    np.testing.assert_allclose(s_t.numpy(), s_np, rtol=1e-5)

    def recon(q, s):  # the output error against the Hessian: tr(E^T H E)
        e = (q.astype(np.float64).reshape(-1, group, N) * s[:, None]).reshape(F, N) - w2
        return float(np.einsum("in,ij,jn->", e, h_np.astype(np.float64), e))

    r_np, r_t = recon(q_np, s_np), recon(q_t.numpy(), s_t.numpy())
    assert abs(r_t - r_np) <= 0.01 * r_np
    # And it beats plain round-to-nearest with the clip search on that error.
    q_r, s_r = jquant._rtn_groupquant(w2, 7.0, group, True)
    assert r_t < recon(q_r.reshape(F, N), s_r[:, 0])


def test_gptq_mode_matches_jax_on_the_stack(np_params):
    kw = dict(bits=8, mlp_bits=4, gptq=True, int4_group=64)
    want = params_from_jax(jax.device_get(
        jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params), **kw)))
    got = quant.quantize_zonos_params(params_from_jax(np_params), **kw)
    g, w = got["backbone"]["layers"]["fc2"], want["backbone"]["layers"]["fc2"]
    assert (unpack_int4(g["weight_int4"]) == unpack_int4(w["weight_int4"])).float().mean() >= 0.995
    np.testing.assert_allclose(g["scale"].numpy(), w["scale"].numpy(), rtol=1e-5)
    _assert_trees_equal(got["backbone"]["layers"]["fc1"], want["backbone"]["layers"]["fc1"])


def test_awq_fold_matches_jax(np_params):
    rng = np.random.default_rng(5)
    L, F = 2, BB["attn_mlp_d_intermediate"]
    energy = rng.uniform(0.01, 50.0, size=(L, F)) ** 2
    layers = np_params["backbone"]["layers"]
    want = jquant.awq_fold(jax.tree_util.tree_map(jnp.asarray, layers), energy)
    got = quant.awq_fold(params_from_jax(layers), torch.from_numpy(energy))
    for k in ("fc1", "fc2"):
        np.testing.assert_allclose(got[k]["weight"].numpy(), np.asarray(want[k]["weight"]),
                                   rtol=1e-6, atol=1e-7)
    # The fold changed something (a non-zero alpha won), yet the MLP is the same function.
    assert not np.allclose(got["fc2"]["weight"].numpy(), layers["fc2"]["weight"])
    x = torch.from_numpy(rng.standard_normal((3, BB["d_model"])).astype(np.float32))

    def mlp(w1, w2):
        y, g = (x @ w1).chunk(2, dim=-1)
        return (y * torch.nn.functional.silu(g)) @ w2

    for l in range(L):
        torch.testing.assert_close(
            mlp(got["fc1"]["weight"][l], got["fc2"]["weight"][l]),
            mlp(torch.from_numpy(layers["fc1"]["weight"][l]),
                torch.from_numpy(layers["fc2"]["weight"][l])), rtol=1e-4, atol=1e-5)


def test_awq_mode_matches_jax(np_params):
    rng = np.random.default_rng(6)
    energy = rng.uniform(0.01, 50.0, size=(2, BB["attn_mlp_d_intermediate"])) ** 2
    kw = dict(bits=8, mlp_bits=4, fake=True)
    want = params_from_jax(jax.device_get(jquant.quantize_zonos_params(
        jax.tree_util.tree_map(jnp.asarray, np_params), awq_energy=energy, **kw)))
    got = quant.quantize_zonos_params(params_from_jax(np_params),
                                      awq_energy=torch.from_numpy(energy), **kw)
    for k in ("fc1", "fc2"):
        np.testing.assert_allclose(got["backbone"]["layers"][k]["weight"].numpy(),
                                   want["backbone"]["layers"][k]["weight"].numpy(),
                                   rtol=1e-6, atol=1e-7)


# -- capture_fc2 ---------------------------------------------------------------

def test_capture_fc2_energies_match_jax(np_params):
    rng = np.random.default_rng(2)
    S = 12
    hidden = rng.standard_normal((2, S, BB["d_model"])).astype(np.float32)
    jmodel = JModel(JTINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    rope = expand_rope_table(jrope_table(jmodel.config.backbone.head_dim))
    jcache = jmodel.allocate_cache(2, 16, jnp.float32)
    jout, _, je = jmodel.backbone_forward(jparams, jnp.asarray(hidden), jcache, jnp.int32(0),
                                          jnp.zeros((2,), jnp.int32), rope, capture_fc2=True)
    model = ZonosModel(TTINY)
    params = params_from_jax(np_params)
    cache = model.allocate_cache(2, 16, torch.float32, "cpu")
    out, e = model.backbone_forward(params, torch.from_numpy(hidden), cache, 0,
                                    model.rope_for("cpu"), capture_fc2=True)
    assert e.shape == (2, BB["attn_mlp_d_intermediate"]) and e.dtype == torch.float32
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


# -- greedy codes on int4 trees ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["int4", "int4full", "int4fc1"])
def test_int4_greedy_codes_equal_jax(np_params, mode):
    steps = 16
    jparams = jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                                           **MODES[mode])
    jmodel = JModel(JTINY)
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(PHONEMES)})
    jres = jgen.DecodeEngine(jmodel).generate(
        jparams, jcond, key=jax.random.key(1), max_new_tokens=steps,
        sampling_params=JSampling(temperature=0.0), disable_eos=True)
    pipe = ZonosPipeline.from_params(TTINY, params_from_jax(np_params), device="cpu")
    if mode == "int4":
        assert pipe.quantize_int4() is pipe
    elif mode == "int4full":
        pipe.quantize_int4(mixed=False)
    else:
        pipe.params = quant.quantize_zonos_params(pipe.params, **MODES[mode])
    _assert_trees_equal(pipe.params, params_from_jax(jax.device_get(jparams)))
    cond = pipe.prepare_conditioning({"espeak": torch.tensor(PHONEMES)})
    tres = tgen.DecodeEngine(pipe.model).generate(
        pipe.params, cond, generator=torch.Generator().manual_seed(1), max_new_tokens=steps,
        sampling_params=SamplingParams(temperature=0.0), disable_eos=True)
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))


# -- checkpoints -------------------------------------------------------------

def test_int4_params_cache_both_ways(np_params, tmp_path):
    jq = jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                                      bits=4, mlp_bits=4)
    path = tmp_path / "jax_int4.npz"
    jckpt.save_params_cache(str(path), jq)
    with np.load(path) as data:
        assert any(k.endswith("@s4") for k in data.files)
    loaded = load_params_cache(str(path))
    _assert_trees_equal(loaded, params_from_jax(jax.device_get(jq)))
    # Read by the port, each int4 weight equals JAX's dequantized one.
    for name in ("in_proj", "fc1", "fc2"):
        jleaf = jq["backbone"]["layers"][name]
        grouped = jleaf["weight_int4"].ndim == 4
        want = jquant.dequantize_weight(jleaf, jnp.float32, grouped=grouped)
        np.testing.assert_array_equal(
            quant.dequantize_weight(loaded["backbone"]["layers"][name], torch.float32).numpy(),
            np.asarray(want))
    # Written by the port, read by JAX: JAX's tree again.
    out = tmp_path / "port_int4.npz"
    save_params_cache(str(out), loaded)
    back = jckpt.load_params_cache(str(out))
    want_leaves, got_leaves = dict(_leaves(jq)), dict(_leaves(back))
    assert want_leaves.keys() == got_leaves.keys()
    for k, v in want_leaves.items():
        assert got_leaves[k].dtype == v.dtype and got_leaves[k].shape == v.shape, k
        np.testing.assert_array_equal(np.asarray(got_leaves[k].astype(jnp.float32)),
                                      np.asarray(v.astype(jnp.float32)), err_msg=k)
    # And the port's round trip.
    _assert_trees_equal(load_params_cache(str(out)), loaded)


# -- the quality gate ----------------------------------------------------------

def _gate_tool():
    spec = importlib.util.spec_from_file_location("quality_quant_torch",
                                                  REPO / "tools" / "quality_quant_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_probs_along(model, params, cond, delayed):
    """The JAX tool's teacher-forced pass (``tools/quality_quant.py``)."""
    rope = expand_rope_table(jrope_table(model.config.backbone.head_dim))
    emb = model.embed_codes(params, delayed)
    emb = jnp.concatenate([emb, emb], axis=0)
    hidden = jnp.concatenate([cond.astype(emb.dtype), emb], axis=1)
    T = hidden.shape[1]
    cache = model.allocate_cache(2, ((T + 7) // 8) * 8, cond.dtype)
    out, _ = model.backbone_forward(params, hidden, cache, jnp.int32(0),
                                    jnp.zeros((2,), jnp.int32), rope)
    logits = model.apply_heads(params, out[:, cond.shape[1]:, :])
    c, u = jnp.split(logits, 2, axis=0)
    logits = u + (c - u) * 2.0
    mask = jnp.arange(logits.shape[-1])[None, None, None, :] >= model.config.head_vocab_size
    return np.asarray(jax.nn.softmax(jnp.where(mask, -1e30, logits)[0], axis=-1))


def _jax_measures(p_ref, p_q):
    """The JAX tool's measures, unrounded."""
    tv = 0.5 * np.abs(p_ref - p_q).sum(-1)
    top_ref = np.argsort(-p_ref, axis=-1)[..., :8]
    top_q = np.argsort(-p_q, axis=-1)[..., :8]
    overlap = np.array([[len(np.intersect1d(top_ref[k, t], top_q[k, t])) / 8
                         for t in range(top_ref.shape[1])] for k in range(top_ref.shape[0])])
    ordered = -np.sort(-p_ref, axis=-1)
    margin = ordered[..., 0] - ordered[..., 1]
    return {"topk_overlap_margin_weighted": float((overlap * margin).sum() / margin.sum()),
            "tv_distance_mean": float(tv.mean()),
            "tv_distance_p95": float(np.quantile(tv, 0.95)),
            "tv_distance_max": float(tv.max())}


def test_quality_gate_matches_jax(np_params):
    tool = _gate_tool()
    steps = 12
    jmodel = JModel(JTINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(PHONEMES)})
    codes = jgen.DecodeEngine(jmodel).generate(
        jparams, jcond, key=jax.random.key(1), max_new_tokens=steps,
        sampling_params=JSampling(temperature=0.0), disable_eos=True).codes
    delayed = japply_delay(codes, jmodel.config.masked_token_id)
    j_ref = _jax_probs_along(jmodel, jparams, jcond, delayed)

    model = ZonosModel(TTINY)
    params = params_from_jax(np_params)
    cond = model.prepare_conditioning(params, {"espeak": torch.tensor(PHONEMES)})
    tcodes = tool.greedy_codes(model, params, cond, steps)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    results = {r["mode"]: r for r in tool.run(model, params, cond, ["int8", "int4"], steps)}
    for mode, kw in (("int8", MODES["int8"]), ("int4", MODES["int4"])):
        jq = jquant.quantize_zonos_params(jparams, fake=True, **kw)
        want = _jax_measures(j_ref, _jax_probs_along(jmodel, jq, jcond, delayed))
        for k, v in want.items():
            assert abs(results[mode][k] - v) <= 1e-4, (mode, k, results[mode][k], v)
    assert results["int4"]["tv_distance_mean"] > results["int8"]["tv_distance_mean"] > 0
    assert tool.parse_mode("int4fc1g64gptqreal") == (
        dict(bits=8, mlp_bits=4, fc2_bits=8, int4_group=64, gptq=True, fake=False), False)
    with pytest.raises(ValueError):
        tool.parse_mode("int3")


def test_gate_tool_runs_without_jax():
    """``tools/quality_quant_torch.py`` end to end on the CPU (flagship widths
    cut to one layer, 2 frames) in a fresh interpreter: one JSON line, and
    neither jax nor the JAX package loaded."""
    import json
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import quality_quant_torch as q\n"
        "q.main(['--device', 'cpu', '--layers', '1', '2', 'int4real'])\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'zonos_vibes_tpu' or k.startswith('zonos_vibes_tpu.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    (line,) = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert line["mode"] == "int4real" and line["layers"] == 1 and line["device"] == "cpu"
    assert 0 < line["tv_distance_mean"] < 0.5 and 0 < line["topk_overlap_margin_weighted"] <= 1
