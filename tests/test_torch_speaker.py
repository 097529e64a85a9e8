"""The port's speaker-cloning path against the JAX package on the CPU: the
DSP (resampling, log filterbank), the ResNet + SimAM + ASP + LDA encoder
with the same weights, the full call against JAX's own DSP chain, and the
reference-checkpoint converter.

Tiny encoder as in tests/test_speaker.py: width 8, depths 2/2/2/2, 32-d
embedding, 16-d LDA. Inputs from numpy seeds; fp32 (JAX at ``highest``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.models.speaker import SpeakerEncoder as JSpeakerEncoder
from zonos_vibes_tpu.models.speaker import convert_speaker_state_dict as jconvert_speaker
from zonos_vibes_tpu.utils import dsp as jdsp
from zonos_vibes_tpu_torch.models.speaker import (MIN_16K, SpeakerEncoder,
                                                   convert_speaker_state_dict)
from zonos_vibes_tpu_torch.utils import dsp
from zonos_vibes_tpu_torch.utils.checkpoint import speaker_params_from_jax

IP, DEPTHS, EMBD, LDA = 8, (2, 2, 2, 2), 32, 16


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


def _wav(seed, *shape):
    """Speech-like test signal: a chirp plus noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    chirp = 0.5 * np.sin(2 * np.pi * (200.0 + 400.0 * t) * t)
    return (chirp + 0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("orig, new, n", [(44100, 16000, 44100), (24000, 44100, 24000),
                                          (16000, 16000, 1600), (44100, 16000, 300),
                                          (16000, 24000, 4001)])
def test_resample_matches_jax(orig, new, n):
    """44.1 -> 16 kHz (the speaker path), 24 -> 44.1 kHz (the DAC's
    preprocess), identity, a clip shorter than the filter, and an odd
    length: within 1e-5 of JAX, same length."""
    x = _wav(0, 2, n)
    want = np.asarray(jdsp.resample(jnp.asarray(x), orig, new))
    got = dsp.resample(torch.from_numpy(x), orig, new)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [16000, 512, 7000])
def test_log_fbank_matches_jax(n):
    """``log_fbank`` (and under it ``stft_power``, ``mel_spectrogram``,
    ``mel_filterbank``) within 1e-4 of JAX; the shortest input is the 512
    samples the speaker path pads to."""
    x = _wav(1, 1, n)
    want = np.asarray(jdsp.log_fbank(jnp.asarray(x)))
    got = dsp.log_fbank(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 80, n // 160 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(dsp.mel_filterbank(80, 512, 16000),
                                  jdsp.mel_filterbank(80, 512, 16000))


@pytest.fixture(scope="module")
def encoders():
    jenc = JSpeakerEncoder(in_planes=IP, embd_dim=EMBD, lda_dim=LDA, depths=DEPTHS)
    # Nonzero biases, so that a bias carried to the wrong channel shows.
    np_params = _random_tree(jax.eval_shape(lambda: jenc.init(jax.random.key(3))), 3)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    enc = SpeakerEncoder(in_planes=IP, embd_dim=EMBD, lda_dim=LDA, depths=DEPTHS)
    return jenc, jparams, enc, speaker_params_from_jax(np_params)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_embed_with_lda_matches_jax(encoders):
    """One mel through both encoders with the same weights: the 32-d
    embedding and the 16-d LDA output within 1e-4 relative."""
    jenc, jparams, enc, params = encoders
    mel = np.random.default_rng(4).standard_normal((1, 80, 57)).astype(np.float32)
    jemb, jlda = jenc.embed_with_lda(jparams, jnp.asarray(mel))
    emb, lda = enc.embed_with_lda(params, torch.from_numpy(mel))
    assert tuple(emb.shape) == (1, EMBD) and tuple(lda.shape) == (1, LDA)
    assert _rel(emb.numpy(), np.asarray(jemb)) <= 1e-4
    assert _rel(lda.numpy(), np.asarray(jlda)) <= 1e-4


def test_resnet_conv_layouts_match_jax(encoders):
    """The flattened ResNet output is channel-major (C * F'), as JAX's."""
    jenc, jparams, enc, params = encoders
    mel = np.random.default_rng(5).standard_normal((2, 80, 24)).astype(np.float32)
    want = np.asarray(jenc.resnet_forward(jparams, jnp.asarray(mel)))
    got = enc.resnet_forward(params, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, IP * 8 * 10, 3)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("sr, shape", [(24000, (2, 12000)), (44100, (300,)),
                                       (16000, (16000,))])
def test_full_call_matches_jax_dsp_chain(encoders, sr, shape):
    """``SpeakerEncoder.__call__`` (mono mix, 16 kHz, 512-sample pad,
    ``log_fbank``, LDA) against the same chain spelled out with the JAX
    package's DSP, so that the result does not depend on whether JAX's
    native DSP library is built. 300 samples at 44.1 kHz are 109 at 16 kHz:
    the pad."""
    jenc, jparams, enc, params = encoders
    wav = _wav(6, *shape)
    mono = wav.mean(axis=0) if wav.ndim == 2 else wav
    wav16 = jdsp.resample(jnp.asarray(mono)[None, :], sr, 16000)
    if wav16.shape[-1] < MIN_16K:
        wav16 = jnp.pad(wav16, ((0, 0), (0, MIN_16K - wav16.shape[-1])))
    jemb, jlda = jenc.embed_with_lda(jparams, jdsp.log_fbank(wav16))
    emb, lda = enc(params, wav, sr)
    assert _rel(emb.numpy(), np.asarray(jemb)) <= 1e-4
    assert _rel(lda.numpy(), np.asarray(jlda)) <= 1e-4


def _reference_state_dicts(seed=0):
    """Reference-named ResNet293-style and LDA state dicts (torch tensors) at
    the tiny shapes, with random BatchNorm statistics."""
    rng = np.random.default_rng(seed)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    sd = {}

    def bn(key, c):
        sd[f"{key}.weight"] = rand(c, lo=0.5, hi=1.5)
        sd[f"{key}.bias"] = rand(c, lo=-0.2, hi=0.2)
        sd[f"{key}.running_mean"] = rand(c, lo=-0.3, hi=0.3)
        sd[f"{key}.running_var"] = rand(c, lo=0.6, hi=1.5)

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = rand(cout, cin, k, k) / (cin * k * k) ** 0.5

    conv("front.conv1", IP, 1, 3)
    bn("front.bn1", IP)
    cin = IP
    for i, (depth, stride) in enumerate(zip(DEPTHS, (1, 2, 2, 2))):
        cout = IP * 2 ** i
        for j in range(depth):
            base = f"front.layer{i + 1}.{j}"
            c_in = cin if j == 0 else cout
            conv(f"{base}.conv1", cout, c_in, 3)
            bn(f"{base}.bn1", cout)
            conv(f"{base}.conv2", cout, cout, 3)
            bn(f"{base}.bn2", cout)
            if j == 0 and (stride != 1 or c_in != cout):
                conv(f"{base}.downsample.0", cout, c_in, 1)
                bn(f"{base}.downsample.1", cout)
        cin = cout
    C = IP * 8 * 10
    sd["pooling.attention.0.weight"] = rand(128, C, 1) * 0.05
    sd["pooling.attention.0.bias"] = rand(128) * 0.05
    bn("pooling.attention.2", 128)
    sd["pooling.attention.3.weight"] = rand(C, 128, 1) * 0.05
    sd["pooling.attention.3.bias"] = rand(C) * 0.05
    sd["bottleneck.weight"] = rand(EMBD, 2 * C) * 0.05
    sd["bottleneck.bias"] = rand(EMBD) * 0.05
    return sd, {"weight": rand(LDA, EMBD), "bias": rand(LDA)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_convert_speaker_state_dict_equals_jax():
    """The port's converter (BatchNorm folded, OIHW kernels, stacked tails)
    equals ``speaker_params_from_jax`` of JAX's converted tree bit for bit,
    and the converted encoders agree."""
    sd, lda_sd = _reference_state_dicts()
    got = convert_speaker_state_dict(sd, lda_sd, depths=DEPTHS)
    jtree = jconvert_speaker(sd, lda_sd, jnp.float32, depths=DEPTHS)
    want = speaker_params_from_jax(jax.device_get(jtree))
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for name, t in want_l.items():
        assert got_l[name].dtype == torch.float32, name
        assert torch.equal(got_l[name], t), name
    assert tuple(got["layer2"]["tail"]["conv1"]["weight"].shape) == (1, 2 * IP, 2 * IP, 3, 3)
    mel = np.random.default_rng(7).standard_normal((1, 80, 33)).astype(np.float32)
    jenc = JSpeakerEncoder(in_planes=IP, embd_dim=EMBD, lda_dim=LDA, depths=DEPTHS)
    enc = SpeakerEncoder(in_planes=IP, embd_dim=EMBD, lda_dim=LDA, depths=DEPTHS)
    _, jlda = jenc.embed_with_lda(jtree, jnp.asarray(mel))
    _, lda = enc.embed_with_lda(got, torch.from_numpy(mel))
    assert _rel(lda.numpy(), np.asarray(jlda)) <= 1e-4


def test_init_shapes_match_jax():
    """Random init: the JAX init's tree, shapes and dtypes (flagship
    topology: 97 blocks, 5120 ASP channels)."""
    jtree = jax.eval_shape(lambda: JSpeakerEncoder().init(jax.random.key(0)))
    want = speaker_params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jtree))
    got = SpeakerEncoder().init(torch.Generator().manual_seed(0))
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for name, t in want_l.items():
        assert got_l[name].shape == t.shape and got_l[name].dtype == t.dtype, name
    assert got["layer3"]["tail"]["conv1"]["weight"].shape[0] == 63
