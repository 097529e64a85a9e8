"""The JAX side of the parallel layer's CPU tests: the tiny fp32 configurations
of the JAX package's own parallel tests, random weights in numpy at the
shapes of their ``init`` (drawn here, not by the JAX init, which takes
seconds op by op), and the port's parameters from the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from torch_parallel_workers import HYBRID_BACKBONE, PC
from zonos_vibes_tpu.config import BackboneConfig, PrefixConditionerConfig, ZonosConfig, _freeze
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel


def jax_config(n_layer: int, heads: tuple[int, int]) -> ZonosConfig:
    return ZonosConfig(
        backbone=BackboneConfig(d_model=64, n_layer=n_layer, attn_mlp_d_intermediate=128,
                                attn_cfg=_freeze({"num_heads": heads[0],
                                                  "num_heads_kv": heads[1]})),
        prefix_conditioner=PrefixConditionerConfig.from_dict(PC))


def jax_hybrid_config(**changes) -> ZonosConfig:
    """JAX's twin of ``torch_parallel_workers.tiny_hybrid_config``."""
    bb = {k: _freeze(v) if isinstance(v, dict) else v
          for k, v in {**HYBRID_BACKBONE, **changes}.items()}
    return ZonosConfig(backbone=BackboneConfig(**bb),
                       prefix_conditioner=PrefixConditionerConfig.from_dict(PC))


def random_params(cfg: ZonosConfig, seed: int) -> dict:
    """numpy weights in the layout of ``ZonosModel(cfg).init``: matrices
    normal / sqrt(fan in), norm scales near 1, small biases and vectors."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JModel(cfg).init(jax.random.key(0), jnp.float32))

    def leaf(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        if any("norm" in n for n in names):
            x = (1.0 + 0.1 * rng.standard_normal(s.shape) if names[-1] == "weight"
                 else 0.05 * rng.standard_normal(s.shape))
        elif len(s.shape) >= 2 and names[-1] == "weight" and "embeddings" not in names:
            x = rng.standard_normal(s.shape) / s.shape[-2] ** 0.5
        else:
            x = rng.standard_normal(s.shape) * (1.0 if "embeddings" in names else 0.05)
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_tree(np_params: dict):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def jax_conditioning(cfg: ZonosConfig, np_params: dict, phonemes) -> np.ndarray:
    model = JModel(cfg)
    return np.asarray(model.prepare_conditioning(jax_tree(np_params),
                                                 {"espeak": jnp.asarray(phonemes)}))
