"""The port's DAC encoder, residual vector quantizer and audio-prefix
preprocessing against the JAX package on the CPU, with the same weights,
and its reference-checkpoint converter against JAX's.

Tiny DAC as in tests/test_dac.py (width 16, strides 2/4, 3 codebooks of 32
entries in 4 dimensions, hop 8); inputs from numpy seeds; fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.models.autoencoder import DACAutoencoder as JAutoencoder
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.dac import DACModel as JDACModel
from zonos_vibes_tpu.utils.checkpoint import convert_dac_state_dict as jconvert_dac
from zonos_vibes_tpu_torch.models.autoencoder import DACAutoencoder
from zonos_vibes_tpu_torch.models.dac import DACConfig, DACModel
from zonos_vibes_tpu_torch.utils.checkpoint import convert_dac_state_dict, params_from_jax

TINY = dict(encoder_hidden_size=16, downsampling_ratios=(2, 4), decoder_hidden_size=64,
            n_codebooks=3, codebook_size=32, codebook_dim=4)


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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def dacs():
    # Snake alphas away from 1, so that an alpha on the wrong channel shows.
    np_params = _random_tree(jax.eval_shape(
        lambda: JDACModel(JDACConfig(**TINY)).init(jax.random.key(5))), 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return JDACModel(JDACConfig(**TINY)), jparams, DACModel(DACConfig(**TINY)), \
        params_from_jax(np_params)


def _audio(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    x = 0.4 * np.sin(2 * np.pi * (300.0 + 2000.0 * t) * t) + 0.1 * rng.standard_normal((2, 1, n))
    return x.astype(np.float32)


def test_encoder_latents_match_jax(dacs):
    """``encoder_forward`` (strided convs with padding ceil(s / 2), Snake,
    dilated residual units) within 1e-5 relative of JAX's."""
    jdac, jparams, dac, params = dacs
    audio = _audio(1, 8 * 40)
    want = np.asarray(jdac.encoder_forward(jparams, jnp.asarray(audio).transpose(0, 2, 1)))
    got = dac.encoder_forward(params, torch.from_numpy(audio)).numpy()
    assert got.shape == (2, 64, 40) and want.shape == (2, 40, 64)
    want = want.transpose(0, 2, 1)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_encode_codes_equal_jax(dacs):
    """``encode`` (encoder, then the 3-stage RVQ): codes equal to JAX's."""
    jdac, jparams, dac, params = dacs
    audio = _audio(2, 8 * 64)
    want = np.asarray(jdac.encode(jparams, jnp.asarray(audio)))
    got = dac.encode(params, torch.from_numpy(audio))
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape == (2, 3, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8  # the codes are not all one entry


def test_quantize_matches_jax_on_latents_and_ties(dacs):
    """``quantize`` on given latents equals JAX's. Codebook row 7 is made a
    copy of row 3 and ten frames are aimed at it: both pick row 3, the
    first (JAX's argmax); the later stages, which see the residual less the
    raw row's projection, agree too."""
    jdac, jparams, dac, params = dacs
    rng = np.random.default_rng(3)
    latents = rng.standard_normal((1, 30, 64)).astype(np.float32)
    q0 = jparams["quantizers"][0]
    cb = np.array(q0["codebook"])
    cb[7] = cb[3]
    w, b = np.asarray(q0["in_proj"]["weight"])[0], np.asarray(q0["in_proj"]["bias"])  # [64, 4]
    latents[0, :10] = np.linalg.pinv(w.T) @ (cb[3] - b)  # stage 0 projects onto row 3
    jp = {**jparams, "quantizers": [{**q0, "codebook": jnp.asarray(cb)},
                                    *jparams["quantizers"][1:]]}
    p = {**params, "quantizers": [{**params["quantizers"][0], "codebook": torch.from_numpy(cb)},
                                  *params["quantizers"][1:]]}
    want = np.asarray(jdac.quantize(jp, jnp.asarray(latents)))
    got = dac.quantize(p, torch.from_numpy(latents).transpose(1, 2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 0, :10] == 3).all() and not (want[0, 0] == 7).any()


@pytest.mark.parametrize("sr, n", [(24000, 3001), (44100, 8 * 25), (16000, 999)])
def test_preprocess_matches_jax(sr, n):
    """``preprocess``: resample to 44.1 kHz and right-pad to the hop, within
    1e-5 of JAX, same length (a multiple of 8)."""
    wav = _audio(4, n)[:, 0]
    want = np.asarray(JAutoencoder(JDACConfig(**TINY)).preprocess(jnp.asarray(wav), sr))
    got = DACAutoencoder(DACConfig(**TINY)).preprocess(torch.from_numpy(wav), sr).numpy()
    assert got.shape == want.shape and got.shape[-1] % 8 == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_init_tree_matches_jax():
    """Random init: the JAX init's tree (encoder, in- and out-projections,
    codebooks, decoder) at its shapes, in the port's layouts."""
    jtree = jax.eval_shape(lambda: JDACModel(JDACConfig(**TINY)).init(jax.random.key(0)))
    want = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jtree))
    got = DACModel(DACConfig(**TINY)).init(torch.Generator().manual_seed(0))
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for name, t in want_l.items():
        assert got_l[name].shape == t.shape and got_l[name].dtype == t.dtype, name


def _reference_dac_state_dict(seed=0):
    """A state dict with the names and shapes of HF ``transformers``'
    ``DacModel`` at the tiny config (numpy). The residual units' k7 convs
    and the transposed convs carry weight norm as
    ``parametrizations.weight.original0/1`` (g, v), the rest plain weights."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, shape, norm=False):
        cout = shape[1] if ".conv_t" in key else shape[0]
        if norm:
            sd[f"{key}.parametrizations.weight.original0"] = rng.uniform(
                0.1, 0.3, (shape[0], 1, 1)).astype(np.float32)
            sd[f"{key}.parametrizations.weight.original1"] = rng.standard_normal(
                shape).astype(np.float32)
        else:
            fan_in = shape[0 if ".conv_t" in key else 1] * shape[2]
            sd[f"{key}.weight"] = (rng.standard_normal(shape) / fan_in ** 0.5).astype(np.float32)
        sd[f"{key}.bias"] = (rng.standard_normal(cout) * 0.1).astype(np.float32)

    def res_units(base, dim):
        for u in (1, 2, 3):
            sd[f"{base}.res_unit{u}.snake1.alpha"] = rng.uniform(0.5, 1.5, (1, dim, 1)).astype(
                np.float32)
            conv(f"{base}.res_unit{u}.conv1", (dim, dim, 7), norm=True)
            sd[f"{base}.res_unit{u}.snake2.alpha"] = rng.uniform(0.5, 1.5, (1, dim, 1)).astype(
                np.float32)
            conv(f"{base}.res_unit{u}.conv2", (dim, dim, 1))

    cfg = DACConfig(**TINY)
    conv("encoder.conv1", (16, 1, 7))
    for i, st in enumerate(cfg.downsampling_ratios):
        dim = 16 * 2 ** (i + 1)
        res_units(f"encoder.block.{i}", dim // 2)
        sd[f"encoder.block.{i}.snake1.alpha"] = np.ones((1, dim // 2, 1), np.float32)
        conv(f"encoder.block.{i}.conv1", (dim, dim // 2, 2 * st))
    sd["encoder.snake1.alpha"] = np.ones((1, 64, 1), np.float32)
    conv("encoder.conv2", (64, 64, 3))
    for i in range(cfg.n_codebooks):
        conv(f"quantizer.quantizers.{i}.in_proj", (4, 64, 1))
        conv(f"quantizer.quantizers.{i}.out_proj", (64, 4, 1))
        sd[f"quantizer.quantizers.{i}.codebook.weight"] = rng.standard_normal((32, 4)).astype(
            np.float32)
    conv("decoder.conv1", (64, 64, 7))
    for i, st in enumerate(cfg.upsampling_ratios):
        cin, cout = 64 // 2 ** i, 64 // 2 ** (i + 1)
        sd[f"decoder.block.{i}.snake1.alpha"] = np.ones((1, cin, 1), np.float32)
        conv(f"decoder.block.{i}.conv_t1", (cin, cout, 2 * st), norm=True)
        res_units(f"decoder.block.{i}", cout)
    sd["decoder.snake1.alpha"] = np.ones((1, 16, 1), np.float32)
    conv("decoder.conv2", (1, 16, 7))
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_convert_dac_state_dict_equals_jax():
    """The port's converter on a reference-layout state dict (weight norm
    fused where present) equals ``params_from_jax`` of JAX's converted tree
    bit for bit, and encodes and decodes as JAX does."""
    sd = _reference_dac_state_dict()
    got = convert_dac_state_dict(sd, DACConfig(**TINY))
    jtree = jconvert_dac(sd, JDACConfig(**TINY), jnp.float32)
    want = params_from_jax(jax.device_get(jtree))
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for name, t in want_l.items():
        assert got_l[name].dtype == torch.float32, name
        assert torch.equal(got_l[name], t), name
    audio = _audio(5, 8 * 32)
    dac, jdac = DACModel(DACConfig(**TINY)), JDACModel(JDACConfig(**TINY))
    codes = dac.encode(got, torch.from_numpy(audio))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jdac.encode(jtree, jnp.asarray(audio))))
    np.testing.assert_allclose(dac.decode(got, codes).numpy(),
                               np.asarray(jdac.decode(jtree, jnp.asarray(codes.numpy()))),
                               rtol=1e-4, atol=1e-5)
