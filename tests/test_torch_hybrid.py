"""The port's hybrid (Mamba-2 + attention) backbone against the JAX package's
``models/mamba_backbone.py``, with the same weights carried across by
``params_from_jax``, on the CPU in fp32.

Two tiny configs: tests/test_hybrid.py's ``HYBRID_BB`` (3 layers, attention
at 1) and a 5-layer one with attention at 1 and 3 (a stacked attention cache
of 2, Mamba layers on both sides of each attention layer). Every leaf of the
JAX parameters is perturbed (JAX's init leaves norms at 1, A_log and dt_bias
at 0, D at 1, which would hide layout mistakes). Hidden states and caches
are held to 1e-5 (the same fp32 math summed in another order); greedy codes
must be equal, to JAX's engine and to the fp64 numpy oracle of
tests/test_hybrid_e2e_oracle.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hybrid_e2e_oracle import STEPS, oracle_greedy_decode
from tests.test_parallel import TINY_HYBRID as JTINY_HYBRID
from zonos_vibes_tpu.config import ZONOS_V01_HYBRID as JZONOS_V01_HYBRID
from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.engine.generate import DecodeEngine as JEngine
from zonos_vibes_tpu.models.conditioners import PrefixConditioner as JPrefix
from zonos_vibes_tpu.models.mamba_backbone import HybridBackbone as JHybrid
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.utils.checkpoint import save_params_cache
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.models.conditioners import PrefixConditioner
from zonos_vibes_tpu_torch.models.mamba_backbone import HybridBackbone
from zonos_vibes_tpu_torch.models.registry import backbone_for_config
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.utils.checkpoint import load_params_cache, params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
SSM = {"layer": "Mamba2", "d_state": 16, "headdim": 16, "chunk_size": 8}
ATTN = {"num_heads": 4, "num_heads_kv": 2, "rotary_emb_dim": 8}
BB3 = dict(d_model=64, n_layer=3, d_intermediate=0, attn_mlp_d_intermediate=96,
           attn_layer_idx=(1,), rms_norm=True, residual_in_fp32=True)
BB5 = dict(BB3, n_layer=5, attn_layer_idx=(1, 3))
PC = {"projection": "linear",
      "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}


def _configs(bb: dict):
    """The same backbone config from each package's config module."""
    j = BackboneConfig(**bb, ssm_cfg=_freeze(SSM), attn_cfg=_freeze(ATTN))
    t = tcfg.BackboneConfig(**bb, ssm_cfg=tcfg._freeze(SSM), attn_cfg=tcfg._freeze(ATTN))
    return j, t


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32),
        tree)


def _backbones(bb: dict, seed: int):
    jcfg, tcfg_ = _configs(bb)
    jbb, tbb = JHybrid(jcfg), HybridBackbone(tcfg_)
    np_params = _perturb(jax.device_get(jbb.init(jax.random.key(seed), jnp.float32)), seed)
    return jbb, jax.tree_util.tree_map(jnp.asarray, np_params), tbb, params_from_jax(np_params)


def _port_cache(jbb, jcache) -> dict:
    """The JAX hybrid cache (per-layer dicts, time-minor KV) in the port's
    stacked layout."""
    attn = [jcache["attn"][str(i)] for i in sorted(jbb.attn_idx)]
    mamba = [jcache["solo"][str(i)] for i in range(jbb.cfg.n_layer) if i not in jbb.attn_idx]

    def kv(x):  # [B, Hkv, Dh, T] -> [B, T, Hkv*Dh]
        x = np.asarray(x)
        B, H, D, T = x.shape
        return np.moveaxis(x, -1, 1).reshape(B, T, H * D)

    out = {n: np.stack([kv(a[n]) for a in attn]) for n in ("k", "v")}
    out.update({n: np.stack([np.asarray(m[n], np.float32) for m in mamba])
                for n in ("conv", "ssm")})
    for n in ("k_stage", "v_stage"):
        if attn and n in attn[0]:
            out[n] = np.stack([np.asarray(a[n]) for a in attn])
    return out


def _assert_cache_close(tcache, jbb, jcache, msg=""):
    want = _port_cache(jbb, jcache)
    for n, w in want.items():
        np.testing.assert_allclose(tcache[n].float().numpy(), w, **TOL, err_msg=f"{n} {msg}")


@pytest.mark.parametrize("bb", [BB3, BB5], ids=["3-layer", "5-layer"])
def test_prefill_then_decode_matches_jax(bb):
    """Hidden states after a 9-position prefill and 5 solo decode steps, and
    the cache (KV, conv, SSM) after each."""
    jbb, jparams, tbb, tparams = _backbones(bb, 0)
    B, T = 2, 24
    rng = np.random.default_rng(1)
    jfwd = jax.jit(jbb.forward, static_argnames=("pooled",))
    jcache = jbb.allocate_cache(B, T, jnp.float32)
    tcache = tbb.allocate_cache(B, T, torch.float32, "cpu")
    x = rng.standard_normal((B, 9, 64)).astype(np.float32) * 0.3
    want, jcache = jfwd(jparams, jnp.asarray(x), jcache, jnp.int32(0), jnp.zeros((B,), jnp.int32))
    got = tbb.forward(tparams, torch.from_numpy(x), tcache, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(tcache, jbb, jcache, "after prefill")
    for step in range(5):
        pos = 9 + step
        x = rng.standard_normal((B, 1, 64)).astype(np.float32) * 0.3
        want, jcache = jfwd(jparams, jnp.asarray(x), jcache, jnp.int32(pos),
                            jnp.full((B,), pos, jnp.int32))
        got = tbb.forward(tparams, torch.from_numpy(x), tcache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {step}")
    _assert_cache_close(tcache, jbb, jcache, "after decode")


@pytest.mark.parametrize("bb", [BB3, BB5], ids=["3-layer", "5-layer"])
def test_stage_less_pooled_decode_matches_jax(bb):
    """``forward`` with per-row positions and no ring (JAX's
    ``forward(pooled=True)`` without ``pool_base``): three rows at their own
    positions over a shared prefill, 4 steps; hidden states and the cache,
    whose columns land at each row's position."""
    jbb, jparams, tbb, tparams = _backbones(bb, 2)
    B, T = 3, 24
    rng = np.random.default_rng(3)
    jfwd = jax.jit(jbb.forward, static_argnames=("pooled",))
    jcache = jbb.allocate_cache(B, T, jnp.float32)
    tcache = tbb.allocate_cache(B, T, torch.float32, "cpu")
    x = rng.standard_normal((B, 10, 64)).astype(np.float32) * 0.3
    _, jcache = jfwd(jparams, jnp.asarray(x), jcache, jnp.int32(0), jnp.zeros((B,), jnp.int32))
    tbb.forward(tparams, torch.from_numpy(x), tcache, 0)
    pos = np.array([10, 6, 8], np.int32)
    for step in range(4):
        x = rng.standard_normal((B, 1, 64)).astype(np.float32) * 0.3
        want, jcache = jfwd(jparams, jnp.asarray(x), jcache, jnp.int32(0), jnp.asarray(pos),
                            pooled=True)
        got = tbb.forward(tparams, torch.from_numpy(x), tcache, 0,
                          positions=torch.from_numpy(pos).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {step}")
        pos = pos + 1
    _assert_cache_close(tcache, jbb, jcache)


def _tiny_models():
    tcfg_tiny = tcfg.ZonosConfig(
        backbone=_configs(BB3)[1], prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
    return JModel(JTINY_HYBRID), ZonosModel(tcfg_tiny)


def test_greedy_codes_equal_jax_engine_and_fp64_oracle():
    """The tiny hybrid's greedy decode (tests/test_hybrid_e2e_oracle.py's
    setup): codes equal JAX's ``DecodeEngine`` and the fp64 oracle (near-ties
    resolved to the port's token as that test does, at most a quarter of the
    decisions)."""
    jmodel, tmodel = _tiny_models()
    jparams = jmodel.init(jax.random.key(11), jnp.float32)
    tokens = [[2, 14, 25, 36, 47, 3]]
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(tokens)})
    jres = JEngine(jmodel).generate(jparams, jcond, key=jax.random.key(0), max_new_tokens=STEPS,
                                    sampling_params=JSampling(temperature=0.0))
    np_params = jax.device_get(jparams)
    tparams = params_from_jax(np_params)
    tcond = tmodel.prepare_conditioning(tparams, {"espeak": torch.tensor(tokens)})
    np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), **TOL)
    tres = DecodeEngine(tmodel).generate(tparams, tcond, generator=torch.Generator().manual_seed(0),
                                         max_new_tokens=STEPS,
                                         sampling_params=SamplingParams(temperature=0.0))
    assert tres.valid_length == int(jres.valid_length) == STEPS
    assert tres.steps == STEPS + 9 - 1
    codes = tres.codes.numpy()
    np.testing.assert_array_equal(codes, np.asarray(jres.codes))

    K = 9
    padded = np.concatenate([codes.astype(np.int64), np.full((1, K, K), 1025, np.int64)], axis=-1)
    ours_delayed = np.stack([np.roll(padded[:, k], k + 1, axis=-1) for k in range(K)], axis=1)
    ties = [0]
    oracle = oracle_greedy_decode(np_params, np.asarray(jcond, np.float64), STEPS,
                                  ours_delayed=ours_delayed, tie_tol=1e-3, tie_count=ties)
    np.testing.assert_array_equal(codes, oracle)
    assert ties[0] <= 0.25 * K * (STEPS + K - 1)


def test_five_layer_greedy_codes_equal_jax_engine():
    """Two attention layers between Mamba runs, perturbed weights, 20 frames
    with ``disable_eos``."""
    jcfg = ZonosConfig(backbone=_configs(BB5)[0],
                       prefix_conditioner=PrefixConditionerConfig.from_dict(PC))
    tcfg5 = tcfg.ZonosConfig(backbone=_configs(BB5)[1],
                             prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
    jmodel, tmodel = JModel(jcfg), ZonosModel(tcfg5)
    np_params = _perturb(jax.device_get(jmodel.init(jax.random.key(4), jnp.float32)), 4)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tokens = [[2, 10, 20, 30, 3]]
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(tokens)})
    jres = JEngine(jmodel).generate(jparams, jcond, key=jax.random.key(0), max_new_tokens=20,
                                    sampling_params=JSampling(temperature=0.0), disable_eos=True)
    tparams = params_from_jax(np_params)
    tcond = tmodel.prepare_conditioning(tparams, {"espeak": torch.tensor(tokens)})
    tres = DecodeEngine(tmodel).generate(tparams, tcond, generator=torch.Generator().manual_seed(0),
                                         max_new_tokens=20, disable_eos=True,
                                         sampling_params=SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))
    assert tres.valid_length == int(jres.valid_length) == 20


def test_params_tree_from_jax_and_npz():
    """The JAX list of per-layer dicts stacks by kind, in layer order; the
    ``.npz`` params cache loads to the same tree, bf16 kept bit-exact."""
    jmodel, tmodel = _tiny_models()
    jparams = jmodel.init(jax.random.key(5), jnp.bfloat16)
    tparams = params_from_jax(jax.device_get(jparams))
    bb = tparams["backbone"]
    assert set(bb) == {"mamba", "attn", "norm_f"}
    layers = jax.device_get(jparams["backbone"]["layers"])
    for kind, idx in (("mamba", (0, 2)), ("attn", (1,))):
        for j, i in enumerate(idx):
            for name in ("norm", "in_proj", "out_proj"):
                want = torch.from_numpy(np.array(layers[i][name]["weight"]).view(np.uint16))
                assert torch.equal(bb[kind][name]["weight"][j].view(torch.uint16), want)
    np.testing.assert_array_equal(bb["mamba"]["A_log"].numpy(),
                                  np.stack([layers[0]["A_log"], layers[2]["A_log"]]))
    # The port's own init has the same tree, shapes and dtypes.
    own = tmodel.init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")["backbone"]
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(bb)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(own)[0],
                                jax.tree_util.tree_flatten_with_path(bb)[0]):
        assert a.shape == b.shape and a.dtype == b.dtype, pa


def test_params_cache_npz_round_trip(tmp_path):
    jmodel, _ = _tiny_models()
    jparams = jmodel.init(jax.random.key(6), jnp.bfloat16)
    path = tmp_path / "hybrid.npz"
    save_params_cache(str(path), jparams)
    got = load_params_cache(str(path))
    want = params_from_jax(jax.device_get(jparams))
    g, w = jax.tree_util.tree_flatten(got)[0], jax.tree_util.tree_flatten(want)[0]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_hybrid_conditioners_match_jax():
    """The flagship hybrid's conditioner stack (the transformer's seven plus
    vqscore_8, ctc_loss, dnsmos_ovrl and speaker_noised), values present and
    absent (learned unconditional vectors)."""
    conds = [dict(c) for c in JZONOS_V01_HYBRID.prefix_conditioner.conditioners_list]
    pc = {"projection": "linear", "conditioners": conds}
    jpc = JPrefix(PrefixConditionerConfig.from_dict(pc), 64)
    tpc = PrefixConditioner(tcfg.PrefixConditionerConfig.from_dict(pc), 64)
    jparams = _perturb(jax.device_get(jpc.init(jax.random.key(7), jnp.float32)), 7)
    tparams = params_from_jax(jparams)
    rng = np.random.default_rng(8)
    values = {"espeak": rng.integers(0, 100, size=(1, 9)),
              "speaker": rng.standard_normal((1, 1, 128)).astype(np.float32),
              "emotion": rng.random((1, 1, 8)).astype(np.float32),
              "fmax": np.full((1, 1, 1), 22050.0, np.float32),
              "pitch_std": np.full((1, 1, 1), 20.0, np.float32),
              "speaking_rate": np.full((1, 1, 1), 15.0, np.float32),
              "language_id": np.full((1, 1, 1), 24.0, np.float32),
              "vqscore_8": np.full((1, 1, 8), 0.78, np.float32),
              "ctc_loss": np.zeros((1, 1, 1), np.float32),
              "dnsmos_ovrl": np.full((1, 1, 1), 4.0, np.float32),
              "speaker_noised": np.ones((1, 1, 1), np.float32)}
    for drop in ((), ("vqscore_8", "dnsmos_ovrl"), ("speaker", "speaker_noised", "ctc_loss")):
        cond = {k: v for k, v in values.items() if k not in drop}
        want = jpc.apply(jparams, {k: jnp.asarray(v) for k, v in cond.items()})
        got = tpc.apply(tparams, {k: torch.from_numpy(v) for k, v in cond.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(drop))


def test_routing_and_refusals():
    _, tmodel = _tiny_models()
    assert isinstance(tmodel.backbone, HybridBackbone)
    assert isinstance(backbone_for_config(tcfg.ZONOS_V01_HYBRID.backbone), HybridBackbone)
    with pytest.raises(NotImplementedError):  # int8 KV on the hybrid, as in JAX
        tmodel.allocate_cache(2, 16, torch.float32, "cpu", kv_int8=True)
    params = tmodel.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    q = quantize_zonos_params(params)  # the int8 hybrid: Mamba and attention projections
    for kind in ("mamba", "attn"):
        assert q["backbone"][kind]["in_proj"]["weight_int8"].dtype == torch.int8
        assert q["backbone"][kind]["out_proj"]["scale"].shape[-2] == 1
    assert q["backbone"]["mamba"]["conv1d"] is params["backbone"]["mamba"]["conv1d"]
    cache = tmodel.allocate_cache(2, 16, torch.float32, "cpu", state_bf16=True)
    assert cache["ssm"].dtype == torch.bfloat16 and "k_stage" not in cache
    ring = tmodel.allocate_cache(2, 16, torch.float32, "cpu", pool_ring=True)
    assert ring["k_stage"].shape == (1, 2, 16, 32)
    grouped = dataclasses.replace(tmodel.config.backbone,
                                  ssm_cfg=tcfg._freeze({**SSM, "ngroups": 2}))
    with pytest.raises(NotImplementedError):
        HybridBackbone(grouped)
