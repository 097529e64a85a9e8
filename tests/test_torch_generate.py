"""The port's decode engine against the JAX package's ``generate_jit`` on the
tiny transformer, with the same fp32 weights carried by ``params_from_jax``.

Greedy decoding is deterministic on both sides, so the codes must be equal.
The default sampler draws from different random streams (a JAX key against
a ``torch.Generator``), so those cases compare shapes and the EOS
bookkeeping only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.engine import generate as jgen
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.delay_pattern import apply_delay_pattern as japply_delay
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine import generate as tgen
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

BB = dict(d_model=64, n_layer=2, attn_mlp_d_intermediate=128)
HEADS = {"num_heads": 4, "num_heads_kv": 2}
PC = {"projection": "linear",
      "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}
JTINY = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                    prefix_conditioner=PrefixConditionerConfig.from_dict(PC))
TTINY = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                         prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
PHONEMES = [[2, 10, 20, 30, 3]]


def _weights(force_eos: bool):
    params = jax.device_get(JModel(JTINY).init(jax.random.key(0), jnp.float32))
    if force_eos:
        # The final norm's output becomes the constant unit vector e_0, and
        # codebook 0's head gives EOS a logit of 50 along it: codebook 0
        # emits EOS at every step, and the cascade runs.
        params["backbone"]["norm_f"]["weight"] = np.zeros_like(params["backbone"]["norm_f"]["weight"])
        bias = np.zeros_like(params["backbone"]["norm_f"]["bias"])
        bias[0] = 1.0
        params["backbone"]["norm_f"]["bias"] = bias
        heads = np.array(params["heads"]["weight"])
        heads[0, 0, 1024] = 50.0
        params["heads"]["weight"] = heads
    return params


def _run_both(force_eos, max_new_tokens, sampling, disable_eos):
    np_params = _weights(force_eos)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jmodel = JModel(JTINY)
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(PHONEMES)})
    jres = jgen.DecodeEngine(jmodel).generate(
        jparams, jcond, key=jax.random.key(1), max_new_tokens=max_new_tokens,
        sampling_params=JSampling(**sampling), disable_eos=disable_eos)

    pipe = ZonosPipeline.from_params(TTINY, params_from_jax(np_params), device="cpu")
    cond = {"espeak": torch.tensor(PHONEMES)}
    np.testing.assert_allclose(pipe.prepare_conditioning(cond).numpy(), np.asarray(jcond),
                               rtol=1e-5, atol=1e-5)
    tres = pipe.generate(cond, generator=torch.Generator().manual_seed(1),
                         max_new_tokens=max_new_tokens,
                         sampling_params=SamplingParams(**sampling), disable_eos=disable_eos)
    return jres, tres


def test_greedy_codes_equal_jax_across_a_stage_flush():
    """140 steps: the cache holds 160 positions, so the 128-row stage fills
    once (at decode step 128) and is flushed and read again."""
    jres, tres = _run_both(False, 140, dict(temperature=0.0), disable_eos=True)
    assert tres.steps == 140 + 9 - 1
    assert tres.steps > 128  # past the flush
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))
    assert tres.valid_length == int(jres.valid_length) == 140
    np.testing.assert_array_equal(tres.valid_lengths.numpy(), np.asarray(jres.valid_lengths))


def test_int8_greedy_codes_equal_jax_across_a_stage_flush():
    """The int8 serving configuration: int8 projections and heads
    (``quantize_int8``, JAX's ``quantize_zonos_params(heads=True)``) and an
    int8 KV cache (``DecodeEngine(kv_int8=True)``), 140 greedy steps across
    the stage flush, whose quantized rows are read by the steps after it."""
    np_params = _weights(False)
    jparams = jquantize(jax.tree_util.tree_map(jnp.asarray, np_params), heads=True)
    jmodel = JModel(JTINY)
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(PHONEMES)})
    jres = jgen.DecodeEngine(jmodel, kv_int8=True).generate(
        jparams, jcond, key=jax.random.key(1), max_new_tokens=140,
        sampling_params=JSampling(temperature=0.0), disable_eos=True)

    pipe = ZonosPipeline.from_params(TTINY, params_from_jax(np_params), device="cpu")
    assert pipe.quantize_int8() is pipe
    assert pipe.params["heads"]["weight_int8"].dtype == torch.int8
    assert not pipe.engine.kv_int8  # the pipeline's own engine keeps an exact cache
    cond = {"espeak": torch.tensor(PHONEMES)}
    tres = tgen.DecodeEngine(pipe.model, kv_int8=True).generate(
        pipe.params, pipe.prepare_conditioning(cond), generator=torch.Generator().manual_seed(1),
        max_new_tokens=140, sampling_params=SamplingParams(temperature=0.0), disable_eos=True)
    assert tres.steps == 140 + 9 - 1 > 128
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))
    assert tres.valid_length == int(jres.valid_length) == 140


@pytest.mark.parametrize("sampling", [dict(temperature=0.0), dict(min_p=0.1)])
def test_eos_cascade_bookkeeping_matches_jax(sampling):
    """Codebook 0 forced to EOS: the run stops after the 9-step cascade on
    both sides with the same valid lengths. Greedy codes are equal; with the
    default sampler the other codebooks draw from different streams."""
    jres, tres = _run_both(True, 30, sampling, disable_eos=False)
    assert tres.steps < 30
    assert tres.codes.shape == tuple(jres.codes.shape) == (1, 9, 30)
    assert tres.valid_length == int(jres.valid_length)
    np.testing.assert_array_equal(tres.valid_lengths.numpy(), np.asarray(jres.valid_lengths))
    codes = tres.codes.numpy()
    assert (codes[..., tres.valid_length:] == 0).all()
    assert codes.min() >= 0 and codes.max() < 1024
    if sampling.get("temperature", 1.0) == 0.0:
        np.testing.assert_array_equal(codes, np.asarray(jres.codes))


def test_default_sampler_shapes():
    jres, tres = _run_both(False, 12, dict(min_p=0.1), disable_eos=False)
    assert tres.codes.shape == tuple(jres.codes.shape) == (1, 9, 12)
    codes = tres.codes.numpy()
    assert codes.min() >= 0 and codes.max() < 1024
    assert 0 < tres.valid_length <= 12
    assert int(tres.valid_lengths.max()) <= tres.valid_length


def test_masked_scatter_frame_matches_jax():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 1026, size=(4, 9))
    frame[rng.random((4, 9)) < 0.5] = -1
    frame[0, :] = -1
    frame[1, 0] = 1025  # a MASK-padded slot shifts the fill order
    frame[1, 1:] = -1
    nxt = rng.integers(0, 1025, size=(4, 9))
    want = jgen._masked_scatter_frame(jnp.asarray(frame), jnp.asarray(nxt))
    got = tgen._masked_scatter_frame(torch.from_numpy(frame), torch.from_numpy(nxt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_finalize_matches_jax():
    B, K, T = 3, 9, 12
    codes = np.random.default_rng(1).integers(0, 1024, size=(B, K, T))
    delayed = np.array(japply_delay(jnp.asarray(codes), 1025))
    stop = np.array([-1, 5, 1])
    want = jgen._finalize(JModel(JTINY), {"delayed": jnp.asarray(delayed),
                                           "offset": jnp.int32(T + K),
                                           "stop_offset": jnp.asarray(stop)})
    state = tgen.DecodeState(delayed=torch.from_numpy(delayed), cache={}, offset=T + K,
                             remaining=torch.zeros(B), stopping=torch.zeros(B, dtype=torch.bool),
                             stop_offset=torch.from_numpy(stop), stage_base=0,
                             rope=torch.zeros(0))
    got = tgen._finalize(ZonosModel(TTINY), state)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_entry_points_default_to_cuda():
    """Without a card the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ZonosPipeline.from_config(TTINY)
