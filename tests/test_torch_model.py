"""The port's model modules against the JAX package's, with the same
weights carried across by ``params_from_jax``.

Tiny shapes (the ``TINY`` transformer of tests/test_engine.py, the tiny DAC
of tests/test_dac.py), fp32 on the CPU, JAX at ``highest`` matmul precision.
Tolerance 2e-5 absolute and relative unless a test says otherwise: the two
sides run the same fp32 math, summed in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.config import (
    ZONOS_V01_TRANSFORMER,
    BackboneConfig,
    PrefixConditionerConfig,
    ZonosConfig,
    _freeze,
)
from zonos_vibes_tpu.models import backbone as jbb
from zonos_vibes_tpu.models.conditioners import PrefixConditioner as JPrefix
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.dac import DACModel as JDACModel
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.models import backbone as tbb
from zonos_vibes_tpu_torch.models.conditioners import PrefixConditioner
from zonos_vibes_tpu_torch.models.dac import DACConfig, DACModel
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.rope import rope_table
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)
BB = dict(d_model=64, n_layer=2, attn_mlp_d_intermediate=128)
HEADS = {"num_heads": 4, "num_heads_kv": 2}


def _configs(conditioners, projection="linear"):
    """The same config built from each package's own config module."""
    pc = {"projection": projection, "conditioners": conditioners}
    j = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                    prefix_conditioner=PrefixConditionerConfig.from_dict(pc))
    t = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                         prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(pc))
    return j, t


def _perturb(tree, rng):
    """Random values in every leaf (JAX's init leaves norms at 1/0 and the
    unconditional vectors at 0, which would hide layout mistakes)."""
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32),
        tree)


def _to_port_cache(c):
    """JAX ``[L, B, Hkv, D, T]`` -> the port's time-major ``[L, B, T, Hkv*D]``."""
    c = np.asarray(c)
    L, B, H, D, T = c.shape
    return np.transpose(c, (0, 1, 4, 2, 3)).reshape(L, B, T, H * D)


FLAGSHIP_CONDITIONERS = [dict(c) for c in ZONOS_V01_TRANSFORMER.prefix_conditioner.conditioners_list]
MLP_CONDITIONERS = [
    {"type": "EspeakPhonemeConditioner", "name": "espeak", "projection": "mlp"},
    {"type": "FourierConditioner", "name": "pitch_std", "min_val": 0, "max_val": 400,
     "uncond_type": "learned", "std": 2.0},
]


@pytest.mark.parametrize("conditioners,projection,drop", [
    (FLAGSHIP_CONDITIONERS, "linear", ()),
    (FLAGSHIP_CONDITIONERS, "linear", ("speaker", "emotion", "language_id")),
    (MLP_CONDITIONERS, "mlp", ()),
    (MLP_CONDITIONERS, "none", ("pitch_std",)),
])
def test_prefix_conditioner(conditioners, projection, drop):
    jcfg, pcfg = _configs(conditioners, projection)
    rng = np.random.default_rng(0)
    jpc = JPrefix(jcfg.prefix_conditioner, 64)
    jparams = _perturb(jax.device_get(jpc.init(jax.random.key(1), jnp.float32)), rng)
    tparams = params_from_jax(jparams)
    values = {
        "espeak": rng.integers(0, 100, size=(2, 11)),
        "speaker": rng.standard_normal((2, 1, 128)).astype(np.float32),
        "emotion": rng.random((2, 1, 8)).astype(np.float32),
        "fmax": np.full((2, 1, 1), 22050.0, np.float32),
        "pitch_std": rng.random((2, 1, 1)).astype(np.float32) * 300,
        "speaking_rate": np.full((2, 1, 1), 15.0, np.float32),
        "language_id": np.array([[[24.0]], [[3.0]]], np.float32),
    }
    names = {s.name for s in jpc.specs}
    cond = {k: v for k, v in values.items() if k in names and k not in drop}
    want = jpc.apply(jparams, {k: jnp.asarray(v) for k, v in cond.items()})
    got = PrefixConditioner(pcfg.prefix_conditioner, 64).apply(
        tparams, {k: torch.from_numpy(v) for k, v in cond.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg, pcfg = _configs([{"type": "EspeakPhonemeConditioner", "name": "espeak"}])
    jmodel = JModel(jcfg)
    jparams = _perturb(jax.device_get(jmodel.init(jax.random.key(0), jnp.float32)),
                       np.random.default_rng(5))
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    return jmodel, jparams, ZonosModel(pcfg), params_from_jax(jax.device_get(jparams))


def test_embed_heads_and_logits(tiny_pair):
    jmodel, jparams, tmodel, tparams = tiny_pair
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1026, size=(2, 9, 3))
    np.testing.assert_allclose(
        tmodel.embed_codes(tparams, torch.from_numpy(codes)).numpy(),
        np.asarray(jmodel.embed_codes(jparams, jnp.asarray(codes))), **TOL)
    hidden = rng.standard_normal((2, 6, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.apply_heads(tparams, torch.from_numpy(hidden)).numpy(),
        np.asarray(jmodel.apply_heads(jparams, jnp.asarray(hidden))), **TOL)
    assert tmodel.head_out_dim == jmodel.head_out_dim == 1152

    T = 16
    jcache = jmodel.allocate_cache(2, T, jnp.float32)
    want, _ = jmodel.compute_logits(jparams, jnp.asarray(hidden), jcache, jnp.int32(0),
                                    jnp.zeros((2,), jnp.int32), 2.0)
    tcache = tmodel.allocate_cache(2, T, torch.float32, "cpu")
    got = tmodel.compute_logits(tparams, torch.from_numpy(hidden), tcache, 0, 2.0,
                                rope_table(16))
    assert got.shape == (1, 9, 1152)
    np.testing.assert_array_equal(got[..., 1025:].numpy(), np.asarray(want)[..., 1025:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_backbone_prefill_and_staged_decode(tiny_pair):
    """Hidden states after a prefill and 12 staged decode steps, and the
    cache and stage after them. A stage of 8 (smaller than the default 128,
    so the test is short) fills once: the flush at its canonical boundary
    is crossed and then read."""
    jmodel, jparams, tmodel, tparams = tiny_pair
    cfg_j, cfg_t = jmodel.config.backbone, tmodel.config.backbone
    rng = np.random.default_rng(2)
    L, B, T, S, STAGE, H, Dh = 2, 2, 32, 5, 8, 2, 16
    jcache = {
        "k": jnp.zeros((L, B, H, Dh, T)), "v": jnp.zeros((L, B, H, Dh, T)),
        "k_stage": jnp.zeros((L, B, STAGE, H * Dh)), "v_stage": jnp.zeros((L, B, STAGE, H * Dh)),
    }
    tcache = {"k": torch.zeros(L, B, T, H * Dh), "v": torch.zeros(L, B, T, H * Dh),
              "k_stage": torch.zeros(L, B, STAGE, H * Dh),
              "v_stage": torch.zeros(L, B, STAGE, H * Dh)}
    jfwd = jax.jit(functools.partial(jbb.transformer_forward, cfg=cfg_j))
    table = rope_table(Dh)

    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    want, jcache = jfwd(jparams["backbone"], hidden=jnp.asarray(x), cache=jcache,
                        offset=jnp.int32(0), lengths_per_sample=jnp.zeros((B,), jnp.int32))
    got = tbb.transformer_forward(tparams["backbone"], cfg_t, torch.from_numpy(x), tcache, 0,
                                  table)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    stage_base = S
    for step in range(12):
        pos = S + step
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        want, jcache = jfwd(jparams["backbone"], hidden=jnp.asarray(x), cache=jcache,
                            offset=jnp.int32(pos), lengths_per_sample=jnp.full((B,), pos),
                            stage_base=jnp.int32(stage_base))
        got = tbb.transformer_forward(tparams["backbone"], cfg_t, torch.from_numpy(x), tcache,
                                      pos, table, stage_base=stage_base)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {step}")
        if pos + 1 - stage_base == STAGE:
            jcache = jbb.flush_kv_stage(jcache, jnp.int32(stage_base))
            tbb.flush_kv_stage(tcache, stage_base)
            stage_base += STAGE
    assert stage_base == S + STAGE  # one flush crossed
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), _to_port_cache(jcache[name]), **TOL)
        np.testing.assert_allclose(tcache[name + "_stage"].numpy(),
                                   np.asarray(jcache[name + "_stage"]), **TOL)


def test_stage_less_pooled_decode_matches_jax(tiny_pair):
    """The transformer's pooled decode without a ring (JAX's
    ``transformer_forward(pooled=True)`` without ``pool_base``): three rows
    at their own positions over a shared prefill, 4 steps; hidden states,
    then the cache, whose columns land at each row's position."""
    jmodel, jparams, tmodel, tparams = tiny_pair
    cfg_j, cfg_t = jmodel.config.backbone, tmodel.config.backbone
    rng = np.random.default_rng(4)
    B, T = 3, 24
    jcache = jmodel.allocate_cache(B, T, jnp.float32)
    tcache = tmodel.allocate_cache(B, T, torch.float32, "cpu")
    table = rope_table(16)
    jfwd = jax.jit(functools.partial(jbb.transformer_forward, cfg=cfg_j))
    jpooled = jax.jit(functools.partial(jbb.transformer_forward, cfg=cfg_j, pooled=True))
    x = rng.standard_normal((B, 10, 64)).astype(np.float32)
    _, jcache = jfwd(jparams["backbone"], hidden=jnp.asarray(x), cache=jcache,
                     offset=jnp.int32(0), lengths_per_sample=jnp.zeros((B,), jnp.int32))
    tbb.transformer_forward(tparams["backbone"], cfg_t, torch.from_numpy(x), tcache, 0, table)
    pos = np.array([10, 6, 8], np.int32)
    for step in range(4):
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        want, jcache = jpooled(jparams["backbone"], hidden=jnp.asarray(x), cache=jcache,
                               offset=jnp.int32(0), lengths_per_sample=jnp.asarray(pos))
        got = tbb.transformer_forward(tparams["backbone"], cfg_t, torch.from_numpy(x), tcache, 0,
                                      table, positions=torch.from_numpy(pos).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {step}")
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), _to_port_cache(jcache[name]), **TOL)


def test_dac_decode():
    tiny = dict(encoder_hidden_size=16, downsampling_ratios=(2, 4), decoder_hidden_size=64,
                n_codebooks=3, codebook_size=32, codebook_dim=4)
    jdac = JDACModel(JDACConfig(**tiny))
    rng = np.random.default_rng(3)
    jparams = jax.device_get(jdac.init(jax.random.key(0)))
    # Random Snake alphas (init leaves them at 1).
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: (np.abs(np.asarray(x)) + rng.random(np.shape(x))).astype(np.float32)
        if "snake" in jax.tree_util.keystr(path) else x, jparams)
    codes = rng.integers(0, 32, size=(2, 3, 10))
    want = np.asarray(jdac.decode(jax.tree_util.tree_map(jnp.asarray, jparams),
                                  jnp.asarray(codes)))
    got = DACModel(DACConfig(**tiny)).decode(params_from_jax(jparams), torch.from_numpy(codes))
    assert got.shape == want.shape == (2, 1, 10 * 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
