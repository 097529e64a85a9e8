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
from zonos_vibes_tpu.models.autoencoder import DACAutoencoder as JAutoencoder
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.speaker import SpeakerEncoder as JSpeakerEncoder
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.delay_pattern import apply_delay_pattern as japply_delay
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.pipeline import ZonosPipeline as JPipeline
from zonos_vibes_tpu.utils import dsp as jdsp
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine import generate as tgen
from zonos_vibes_tpu_torch.models.autoencoder import DACAutoencoder
from zonos_vibes_tpu_torch.models.dac import DACConfig
from zonos_vibes_tpu_torch.models.speaker import SpeakerEncoder
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax, speaker_params_from_jax

BB = dict(d_model=64, n_layer=2, attn_mlp_d_intermediate=128)
HEADS = {"num_heads": 4, "num_heads_kv": 2}
PC = {"projection": "linear",
      "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}
JTINY = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                    prefix_conditioner=PrefixConditionerConfig.from_dict(PC))
TTINY = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                         prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
PHONEMES = [[2, 10, 20, 30, 3]]


def _random_tree(shape_tree, seed):
    """Random numpy weights in the layout of a JAX init's ``eval_shape``
    tree (JAX's own init draws eagerly, op by op, and takes seconds): convs
    and linears scaled by 1/sqrt(fan in), small biases, Snake alphas and
    BatchNorm scales in [0.5, 1.5], unit-normal codebooks."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name.startswith("snake") or name == "scale":
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name == "weight":
            fan_in = s.shape[0] if len(s.shape) == 2 else int(np.prod(s.shape[-4 if len(
                s.shape) >= 4 else -3:-1]))
            x = rng.standard_normal(s.shape) / fan_in ** 0.5
        elif name == "codebook":
            x = rng.standard_normal(s.shape)
        else:  # biases and shifts
            x = 0.05 * rng.standard_normal(s.shape)
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shape_tree)


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


# Voice cloning and continuation: a speaker conditioner fed by the tiny speaker
# encoder (16-d LDA output), and a 9-codebook tiny DAC (hop 8) for the prefix.
PC_SPK = {"projection": "linear",
          "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"},
                           {"type": "PassthroughConditioner", "name": "speaker", "cond_dim": 16,
                            "projection": "linear", "uncond_type": "learned"}]}
SPK = dict(in_planes=8, embd_dim=32, lda_dim=16, depths=(2, 2, 2, 2))
DAC9 = dict(encoder_hidden_size=16, downsampling_ratios=(2, 4), decoder_hidden_size=64,
            n_codebooks=9, codebook_size=32, codebook_dim=4)


def _clip(seed, n, sr):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * (220.0 + 300.0 * t) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_clone_and_continue_greedy_codes_equal_jax():
    """Cloning and continuation end to end on the CPU:
    ``make_speaker_embedding`` from a 44.1 kHz stereo reference,
    ``encode_audio`` of a 24 kHz prefix (311 frames),
    ``make_cond_dict(speaker=...)`` and a greedy continuation of 40 frames:
    the prefix codes and the generated codes equal the JAX pipeline's on
    the same weights. JAX's speaker embedding is taken
    through its own DSP chain, not its native library."""
    jcfg = ZonosConfig(backbone=BackboneConfig(**BB, attn_cfg=_freeze(HEADS)),
                       prefix_conditioner=PrefixConditionerConfig.from_dict(PC_SPK))
    tcfg_ = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                             prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC_SPK))
    np_params = jax.device_get(JModel(jcfg).init(jax.random.key(7), jnp.float32))
    np_dac = _random_tree(jax.eval_shape(
        lambda: JAutoencoder(JDACConfig(**DAC9)).init(jax.random.key(8))), 8)
    jspk = JSpeakerEncoder(**SPK)
    np_spk = _random_tree(jax.eval_shape(lambda: jspk.init(jax.random.key(9))), 9)
    jpipe = JPipeline(model=JModel(jcfg), params=jax.tree_util.tree_map(jnp.asarray, np_params),
                      dac=JAutoencoder(JDACConfig(**DAC9)),
                      dac_params=jax.tree_util.tree_map(jnp.asarray, np_dac),
                      speaker_encoder=jspk,
                      speaker_params=jax.tree_util.tree_map(jnp.asarray, np_spk))
    pipe = ZonosPipeline(model=ZonosModel(tcfg_), params=params_from_jax(np_params),
                         device=torch.device("cpu"), dac=DACAutoencoder(DACConfig(**DAC9)),
                         dac_params=params_from_jax(np_dac),
                         speaker_encoder=SpeakerEncoder(**SPK),
                         speaker_params=speaker_params_from_jax(np_spk))

    ref = np.stack([_clip(1, 22050, 44100), _clip(2, 22050, 44100)])  # stereo, 0.5 s
    speaker = pipe.make_speaker_embedding(ref, 44100)
    wav16 = jdsp.resample(jnp.asarray(ref.mean(axis=0))[None], 44100, 16000)
    _, jlda = jspk.embed_with_lda(jpipe.speaker_params, jdsp.log_fbank(wav16))
    jspeaker = jlda.reshape(1, 1, -1).astype(jnp.bfloat16)
    assert speaker.dtype == torch.bfloat16 and tuple(speaker.shape) == (1, 1, 16)
    np.testing.assert_array_equal(speaker.float().numpy(), np.asarray(jspeaker, np.float32))

    prefix = _clip(3, 1350, 24000)  # 2481 samples at 44.1 kHz, padded to 2488: 311 frames
    codes = pipe.encode_audio(prefix, 24000)
    jcodes = jpipe.encode_audio(prefix, 24000)
    assert tuple(codes.shape) == tuple(jcodes.shape) == (1, 9, 311)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))

    text = "Hello there, a cloned voice."
    cond = pipe.make_cond_dict(text=text, speaker=speaker)
    jcond = jpipe.make_cond_dict(text=text, speaker=jspeaker)
    assert cond["speaker"].dtype == torch.float32
    res = pipe.generate(cond, codes, generator=torch.Generator(), max_new_tokens=40,
                        sampling_params=SamplingParams(temperature=0.0), disable_eos=True)
    jres = jpipe.generate(jcond, jcodes, key=jax.random.key(0), max_new_tokens=40,
                          sampling_params=JSampling(temperature=0.0), disable_eos=True)
    assert tuple(res.codes.shape) == (1, 9, 311 + 40)
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(jres.codes))
    np.testing.assert_array_equal(res.codes[..., :311].numpy(), codes.numpy())
    assert res.valid_length == int(jres.valid_length) == 311 + 40


def test_make_speaker_embedding_draws_seed_zero_weights():
    """Without speaker weights the pipeline draws the flagship ResNet293's
    from seed 0 on its device, once: the same clip gives the same
    ``[1, 1, 128]`` bf16 embedding twice, and a 5 ms clip (under the
    512-sample minimum at 16 kHz) runs."""
    pc = {"projection": "linear",
          "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"},
                           {"type": "PassthroughConditioner", "name": "speaker",
                            "cond_dim": 128, "projection": "linear",
                            "uncond_type": "learned"}]}
    cfg = tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**BB, attn_cfg=tcfg._freeze(HEADS)),
                           prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(pc))
    pipe = ZonosPipeline.from_params(cfg, params_from_jax(_weights(False)), device="cpu")
    assert pipe.speaker_shape() == (1, 1, 128)
    clip = _clip(4, 220, 44100)
    a = pipe.make_speaker_embedding(clip, 44100)
    params = pipe.speaker_params
    b = pipe.make_speaker_embedding(clip, 44100)
    assert pipe.speaker_params is params
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (1, 1, 128)
    assert torch.isfinite(a.float()).all() and torch.equal(a, b)
    assert params["layer3"]["tail"]["conv1"]["weight"].shape == (63, 256, 256, 3, 3)
    with pytest.raises(ValueError, match="speaker"):
        ZonosPipeline.from_params(TTINY, params_from_jax(_weights(False)),
                                  device="cpu").speaker_shape()
