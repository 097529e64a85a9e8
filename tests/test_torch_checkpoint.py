"""Weight interchange with the JAX package, reference-checkpoint loading
against JAX's converter, and the port's independence from JAX."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.dac import DACModel as JDACModel
from zonos_vibes_tpu.engine.generate import DecodeEngine as JEngine
from zonos_vibes_tpu.frontend.text import VOCAB_SIZE
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.pipeline import ZonosPipeline as JPipeline
from zonos_vibes_tpu.utils.checkpoint import convert_zonos_state_dict as jconvert_zonos
from zonos_vibes_tpu.utils.checkpoint import save_params_cache
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils.checkpoint import (convert_zonos_state_dict,
                                                    load_params_cache, load_zonos_config,
                                                    params_from_jax)

REPO = Path(__file__).resolve().parents[1]
TINY = ZonosConfig(
    backbone=BackboneConfig(d_model=64, n_layer=2, attn_mlp_d_intermediate=128,
                            attn_cfg=_freeze({"num_heads": 4, "num_heads_kv": 2})),
    prefix_conditioner=PrefixConditionerConfig.from_dict({
        "projection": "none",  # an empty projection node crosses as {}
        "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"},
                         {"type": "FourierConditioner", "name": "fmax", "min_val": 0,
                          "max_val": 24000, "uncond_type": "learned"}]}),
)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_npz_round_trip_bf16(tmp_path):
    """bf16 model weights saved by JAX load bit-exact, dtype and tree kept
    (the fp32 Fourier buffer and norm vectors stay fp32)."""
    params = JModel(TINY).init(jax.random.key(0), jnp.bfloat16)
    path = tmp_path / "params.npz"
    save_params_cache(str(path), params)
    got = load_params_cache(str(path))
    want = params_from_jax(jax.device_get(params))
    assert got["prefix_conditioner"]["project"] == {}
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for name, t in want_leaves.items():
        assert got_leaves[name].dtype == t.dtype, name
        assert torch.equal(got_leaves[name], t), name
    assert got["embeddings"]["weight"].dtype == torch.bfloat16
    assert got["backbone"]["layers"]["norm1"]["weight"].dtype == torch.float32
    np.testing.assert_array_equal(
        got["backbone"]["layers"]["fc1"]["weight"].float().numpy(),
        np.asarray(params["backbone"]["layers"]["fc1"]["weight"], np.float32))


def test_npz_round_trip_dac_layouts(tmp_path):
    """DAC kernels change layout on the way in: conv [k, Cin, Cout] ->
    [Cout, Cin, k]; the pre-flipped transposed conv -> [Cin, Cout, k]."""
    cfg = JDACConfig(encoder_hidden_size=16, downsampling_ratios=(2, 4),
                     decoder_hidden_size=64, n_codebooks=3, codebook_size=32, codebook_dim=4)
    params = JDACModel(cfg).init(jax.random.key(1))
    path = tmp_path / "dac.npz"
    save_params_cache(str(path), params)
    got = load_params_cache(str(path))
    blk = params["decoder"]["blocks"][0]
    np.testing.assert_array_equal(got["decoder"]["blocks"][0]["conv_t"]["weight"].numpy(),
                                  np.transpose(np.asarray(blk["conv_t"]["weight"])[::-1], (1, 2, 0)))
    np.testing.assert_array_equal(got["decoder"]["conv1"]["weight"].numpy(),
                                  np.transpose(np.asarray(params["decoder"]["conv1"]["weight"]),
                                               (2, 1, 0)))
    # The encoder and the quantizers' in-projections come across too.
    np.testing.assert_array_equal(got["encoder"]["blocks"][1]["conv"]["weight"].numpy(),
                                  np.transpose(np.asarray(
                                      params["encoder"]["blocks"][1]["conv"]["weight"]), (2, 1, 0)))
    assert len(got["quantizers"]) == 3
    assert tuple(got["quantizers"][2]["in_proj"]["weight"].shape) == (4, 64, 1)


def test_int4_entries_raise(tmp_path):
    """An ``@s4`` entry loads (it raised before int4 was ported): JAX's
    widened int8 values in its grouped ``[L, G, K / G, N]`` shape become the
    port's packed leaf with scales ``[L, G, 1, N]``, the same weight."""
    rng = np.random.default_rng(4)
    q = rng.integers(-7, 8, size=(2, 3, 8, 6)).astype(np.int8)  # 2 layers, 3 groups of 8
    scale = rng.uniform(0.01, 0.1, size=(2, 3, 1, 6)).astype(np.float32)
    path = tmp_path / "s4.npz"
    np.savez(path, **{"backbone::layers::fc1::weight_int4@s4": q,
                      "backbone::layers::fc1::scale": scale})
    leaf = load_params_cache(str(path))["backbone"]["layers"]["fc1"]
    assert leaf["weight_int4"].dtype == torch.uint8 and leaf["weight_int4"].shape == (2, 24, 3)
    assert leaf["scale"].shape == (2, 3, 1, 6)
    from zonos_vibes_tpu_torch.ops.quant import dequantize_weight

    np.testing.assert_array_equal(dequantize_weight(leaf, torch.float32).numpy(),
                                  (q * scale).reshape(2, 24, 6))


def test_port_imports_nothing_of_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import zonos_vibes_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'zonos_vibes_tpu' or k.startswith('zonos_vibes_tpu.'))\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


# The reference checkpoint's topology at tiny widths (as tests/test_checkpoint.py):
# espeak without a projection, emotion with an MLP projection and a learned
# unconditional vector, a linear prefix projection.
REF_CONFIG = {
    "backbone": {"d_model": 32, "n_layer": 2, "attn_mlp_d_intermediate": 48,
                 "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}},
    "prefix_conditioner": {
        "projection": "linear",
        "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"},
                         {"type": "FourierConditioner", "name": "emotion", "input_dim": 8,
                          "uncond_type": "learned", "projection": "mlp"}]},
}


def _reference_state_dict(seed=0):
    """Reference-named state dict (fp32 tensors from a numpy seed)."""
    rng = np.random.default_rng(seed)
    D, L, F, qkv = 32, 2, 48, (4 + 2 * 2) * 8

    def randn(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32))

    sd = {}
    for k in range(9):
        sd[f"embeddings.{k}.weight"] = randn(1026, D)
        sd[f"heads.{k}.weight"] = randn(1025, D)
    for i in range(L):
        p = f"backbone.layers.{i}"
        sd[f"{p}.norm.weight"] = 1 + randn(D)
        sd[f"{p}.norm.bias"] = randn(D)
        sd[f"{p}.mixer.in_proj.weight"] = randn(qkv, D)
        sd[f"{p}.mixer.out_proj.weight"] = randn(D, 32)
        sd[f"{p}.norm2.weight"] = 1 + randn(D)
        sd[f"{p}.norm2.bias"] = randn(D)
        sd[f"{p}.mlp.fc1.weight"] = randn(2 * F, D)
        sd[f"{p}.mlp.fc2.weight"] = randn(D, F)
    sd["backbone.norm_f.weight"] = 1 + randn(D)
    sd["backbone.norm_f.bias"] = randn(D)
    c = "prefix_conditioner.conditioners"
    sd[f"{c}.0.phoneme_embedder.weight"] = randn(VOCAB_SIZE, D)
    sd[f"{c}.1.weight"] = randn(D // 2, 8)
    for j in (0, 2):
        sd[f"{c}.1.project.{j}.weight"] = randn(D, D)
        sd[f"{c}.1.project.{j}.bias"] = randn(D)
    sd[f"{c}.1.uncond_vector"] = randn(D)
    sd["prefix_conditioner.project.weight"] = randn(D, D)
    sd["prefix_conditioner.project.bias"] = randn(D)
    sd["prefix_conditioner.norm.weight"] = 1 + randn(D)
    sd["prefix_conditioner.norm.bias"] = randn(D)
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_zonos_state_dict_equals_jax(dtype):
    """The port's converter (stacked layers, transposed linears, heads padded
    1025 -> 1152 with zeros, fp32 layer norms) equals ``params_from_jax`` of
    JAX's converted tree bit for bit, dtypes included; a bf16 state dict
    (the reference's storage) converts the same way."""
    sd = _reference_state_dict()
    if dtype == "bfloat16":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    got = convert_zonos_state_dict(sd, tcfg.ZonosConfig.from_dict(REF_CONFIG),
                                   getattr(torch, dtype))
    jtree = jconvert_zonos(sd, ZonosConfig.from_dict(REF_CONFIG), getattr(jnp, dtype))
    want = params_from_jax(jax.device_get(jtree))
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for name, t in want_l.items():
        assert got_l[name].dtype == t.dtype, name
        assert torch.equal(got_l[name], t), name
    assert got["heads"]["weight"].shape == (9, 32, 1152)
    assert got["backbone"]["layers"]["norm1"]["weight"].dtype == torch.float32


def test_convert_zonos_state_dict_refuses_the_hybrid():
    with pytest.raises(NotImplementedError):
        convert_zonos_state_dict({}, tcfg.ZONOS_V01_HYBRID)


def test_from_local_greedy_codes_equal_jax(tmp_path):
    """``from_local`` on a written ``config.json`` + ``model.safetensors``
    pair: the same greedy codes as JAX's ``from_local`` (fp32, CPU)."""
    st = pytest.importorskip("safetensors.torch")
    cfg_path, model_path = tmp_path / "config.json", tmp_path / "model.safetensors"
    cfg_path.write_text(json.dumps(REF_CONFIG))
    st.save_file(_reference_state_dict(1), str(model_path))
    phonemes = [[2, 10, 20, 30, 3]]

    jpipe = JPipeline.from_local(str(cfg_path), str(model_path), dtype=jnp.float32)
    jprefix = jpipe.prepare_conditioning({"espeak": jnp.asarray(phonemes)})
    jres = JEngine(jpipe.model).generate(
        jpipe.params, jprefix, key=jax.random.key(0), max_new_tokens=24,
        sampling_params=JSampling(temperature=0.0), disable_eos=True)

    if not torch.cuda.is_available():  # the default device is the card's
        with pytest.raises(RuntimeError, match="CUDA"):
            ZonosPipeline.from_local(str(cfg_path), str(model_path))
    pipe = ZonosPipeline.from_local(str(cfg_path), str(model_path), dtype=torch.float32,
                                    device="cpu")
    assert pipe.model.config == load_zonos_config(str(cfg_path))
    assert pipe.params["embeddings"]["weight"].dtype == torch.float32
    res = pipe.generate({"espeak": torch.tensor(phonemes)}, generator=torch.Generator(),
                        max_new_tokens=24, sampling_params=SamplingParams(temperature=0.0),
                        disable_eos=True)
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(jres.codes))
    assert res.valid_length == int(jres.valid_length) == 24


def test_sample_cli_clones_a_voice_on_the_cpu(tmp_path, capsys):
    """``serve/sample.py --config --weights --speaker-wav --device cpu``: a
    tiny reference checkpoint with a 128-d speaker conditioner, the
    flagship speaker encoder and DAC with random weights, 8 frames -> a
    16-bit mono WAV of 8 x 512 samples at 44.1 kHz."""
    pytest.importorskip("safetensors.torch")
    import wave

    import safetensors.torch

    from zonos_vibes_tpu_torch.serve import sample

    config = json.loads(json.dumps(REF_CONFIG))
    config["prefix_conditioner"]["conditioners"][1] = {
        "type": "PassthroughConditioner", "name": "speaker", "cond_dim": 128,
        "projection": "linear", "uncond_type": "learned"}
    rng = np.random.default_rng(2)
    sd = {k: v for k, v in _reference_state_dict(2).items()
          if not k.startswith("prefix_conditioner.conditioners.1.")}
    for name, shape in (("project.weight", (32, 128)), ("project.bias", (32,)),
                        ("uncond_vector", (32,))):
        sd[f"prefix_conditioner.conditioners.1.{name}"] = torch.from_numpy(
            (rng.standard_normal(shape) * 0.1).astype(np.float32))
    (tmp_path / "config.json").write_text(json.dumps(config))
    safetensors.torch.save_file(sd, str(tmp_path / "model.safetensors"))
    pcm = (np.sin(np.linspace(0, 300, 4000)) * 12000).astype(np.int16)
    with wave.open(str(tmp_path / "voice.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.repeat(pcm, 2).tobytes())
    out = tmp_path / "cloned.wav"
    sample.main(["--config", str(tmp_path / "config.json"),
                 "--weights", str(tmp_path / "model.safetensors"),
                 "--speaker-wav", str(tmp_path / "voice.wav"), "--text", "Hello.",
                 "--max-seconds", "0.1", "--device", "cpu", "--out", str(out)])
    assert f"wrote {out}" in capsys.readouterr().out
    with wave.open(str(out), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 44100)
        assert w.getnframes() == 8 * 512
    wav, sr = sample.read_wav(str(tmp_path / "voice.wav"))
    assert sr == 16000 and wav.shape == (2, 4000) and wav.dtype == np.float32
