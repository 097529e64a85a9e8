"""Weight interchange with the JAX package, and the port's independence
from it."""

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
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.utils.checkpoint import save_params_cache
from zonos_vibes_tpu_torch.utils.checkpoint import load_params_cache, params_from_jax

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
    assert "encoder" not in got and len(got["quantizers"]) == 3


def test_int4_entries_raise(tmp_path):
    path = tmp_path / "s4.npz"
    np.savez(path, **{"backbone::fc1::weight_int4@s4": np.zeros((2, 2), np.int8)})
    with pytest.raises(NotImplementedError):
        load_params_cache(str(path))


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
