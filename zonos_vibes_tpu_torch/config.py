"""Configuration dataclasses: the PyTorch port's own copy of the JAX
package's ``config.py`` (the port imports nothing of that package).

Model topology is checkpoint-owned: `ZonosConfig.from_dict` parses the HF
``config.json`` shipped with a checkpoint (reference: zonos/config.py:28-62).
Runtime concerns (mesh shape, sharding, decode buckets) live in
``RuntimeConfig`` and are user-owned.

All configs are frozen dataclasses, so they are hashable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


def _freeze(obj: Any) -> Any:
    """Recursively convert dicts/lists into hashable tuples-of-pairs."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj: Any) -> Any:
    """Inverse of :func:`_freeze` for tuple-of-pairs dicts."""
    if isinstance(obj, tuple) and all(
        isinstance(e, tuple) and len(e) == 2 and isinstance(e[0], str) for e in obj
    ):
        return {k: _thaw(v) for k, v in obj}
    if isinstance(obj, tuple):
        return [_thaw(v) for v in obj]
    return obj


@dataclass(frozen=True)
class BackboneConfig:
    """Backbone topology (reference: zonos/config.py:28-39).

    ``ssm_cfg`` empty => pure transformer; non-empty => hybrid
    (Mamba layers everywhere except ``attn_layer_idx``).
    Stored frozen (tuples) so the config is hashable for jit.
    """

    d_model: int = 1024
    d_intermediate: int = 0
    attn_mlp_d_intermediate: int = 0
    n_layer: int = 16
    ssm_cfg: tuple = ()
    attn_layer_idx: tuple = ()
    attn_cfg: tuple = ()
    rms_norm: bool = False
    residual_in_fp32: bool = False
    norm_epsilon: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "BackboneConfig":
        d = dict(d)
        for k in ("ssm_cfg", "attn_cfg"):
            if k in d:
                d[k] = _freeze(d[k] or {})
        if "attn_layer_idx" in d:
            d["attn_layer_idx"] = tuple(d["attn_layer_idx"] or ())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def is_hybrid(self) -> bool:
        return len(self.ssm_cfg) > 0

    @property
    def ssm_cfg_dict(self) -> dict:
        return _thaw(self.ssm_cfg) if self.ssm_cfg else {}

    @property
    def attn_cfg_dict(self) -> dict:
        return _thaw(self.attn_cfg) if self.attn_cfg else {}

    # Attention geometry. The reference transformer reads these from attn_cfg
    # (num_heads, num_heads_kv, head_dim); defaults match Zonos-v0.1.
    @property
    def num_heads(self) -> int:
        return self.attn_cfg_dict.get("num_heads", 16)

    @property
    def num_heads_kv(self) -> int:
        return self.attn_cfg_dict.get("num_heads_kv", max(self.num_heads // 4, 1))

    @property
    def head_dim(self) -> int:
        # Reference derives head_dim from d_model, never from attn_cfg
        # (_torch.py:110).
        return self.d_model // self.num_heads


@dataclass(frozen=True)
class PrefixConditionerConfig:
    """Conditioner roster + projection mode (reference: zonos/config.py:42-45).

    ``conditioners`` is a tuple of frozen dicts, each with a ``type`` key plus
    constructor kwargs; ``projection`` is one of ``none|linear|mlp``.
    """

    conditioners: tuple = ()
    projection: str = "none"

    @classmethod
    def from_dict(cls, d: dict) -> "PrefixConditionerConfig":
        return cls(
            conditioners=tuple(_freeze(c) for c in d.get("conditioners", [])),
            projection=d.get("projection", "none"),
        )

    @property
    def conditioners_list(self) -> list[dict]:
        return [_thaw(c) for c in self.conditioners]


@dataclass(frozen=True)
class ZonosConfig:
    """Top-level model config (reference: zonos/config.py:48-62)."""

    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    prefix_conditioner: PrefixConditionerConfig = field(
        default_factory=PrefixConditionerConfig
    )
    eos_token_id: int = 1024
    masked_token_id: int = 1025
    pad_vocab_to_multiple_of: int = 8
    num_codebooks: int = 9
    codebook_size: int = 1024
    # TPU-native: output heads are padded to a multiple of the MXU lane width
    # (128) instead of the reference's 1026 (utils.py:22-25). Pad logits are
    # masked to -inf (model.py:115 semantics), so sampling is unaffected, the
    # matmul tiles cleanly, and the vocab dim shards evenly under TP.
    head_pad_to_multiple: int = 128

    @classmethod
    def from_dict(cls, d: dict) -> "ZonosConfig":
        d = dict(d)
        backbone = BackboneConfig.from_dict(d.pop("backbone", {}))
        prefix = PrefixConditionerConfig.from_dict(d.pop("prefix_conditioner", {}))
        known = {f.name for f in dataclasses.fields(cls)} - {
            "backbone",
            "prefix_conditioner",
        }
        return cls(
            backbone=backbone,
            prefix_conditioner=prefix,
            **{k: v for k, v in d.items() if k in known},
        )

    @property
    def vocab_size(self) -> int:
        """Embedding vocab: codes + EOS + MASK = 1026 for Zonos-v0.1."""
        return self.codebook_size + 2

    @property
    def head_vocab_size(self) -> int:
        """Output head vocab: codes + EOS = 1025 (MASK is never emitted)."""
        return self.codebook_size + 1

    def padded_vocab(self, n: int) -> int:
        """Reference vocab padding quirk (zonos/utils.py:22-25): pads by
        ``n % multiple`` (NOT up to the next multiple), so 1025 -> 1026.
        Correctness holds because logits >= 1025 are masked to -inf
        (zonos/model.py:115). We reproduce the behavior for checkpoint parity.
        """
        m = self.pad_vocab_to_multiple_of
        return n + (n % m)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for parallel decode/serving.

    Axes: ``data`` (utterance batch DP), ``model`` (TP over heads/FFN),
    plus scaffold axes ``pipe`` (PP stages) and ``expert`` (EP; no-op for the
    shipped dense checkpoints but first-class in the layer map).
    """

    data: int = 1
    model: int = 1
    pipe: int = 1
    expert: int = 1

    @property
    def axis_names(self) -> tuple:
        return ("data", "model", "pipe", "expert")

    @property
    def shape(self) -> tuple:
        return (self.data, self.model, self.pipe, self.expert)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class RuntimeConfig:
    """Decode-engine + serving knobs (new layer; the reference has none —
    SURVEY.md §5.6)."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    max_new_tokens: int = 86 * 30  # 30 s at ~86.13 Hz (reference model.py:223)
    prefill_bucket_sizes: tuple = (64, 128, 256, 512, 1024)
    batch_bucket_sizes: tuple = (1, 2, 4, 8, 16)
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    logits_dtype: str = "float32"
    use_pallas_attention: bool = True
    donate_decode_state: bool = True


_ZONOS_V01_CONDITIONERS = (
    {"type": "EspeakPhonemeConditioner", "name": "espeak"},
    {"type": "PassthroughConditioner", "name": "speaker", "cond_dim": 128,
     "projection": "linear", "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "emotion", "input_dim": 8,
     "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "fmax", "min_val": 0,
     "max_val": 24000, "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "pitch_std", "min_val": 0,
     "max_val": 400, "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "speaking_rate", "min_val": 0,
     "max_val": 40, "uncond_type": "learned"},
    {"type": "IntegerConditioner", "name": "language_id", "min_val": -1,
     "max_val": 126, "uncond_type": "learned"},
)

# Flagship topology (Zonos-v0.1-transformer scale, ~1.6B params). The real
# values always come from the checkpoint's config.json at load time
# (utils/checkpoint.py); this literal exists for benches/dry-runs in
# checkpoint-less environments.
ZONOS_V01_TRANSFORMER = ZonosConfig(
    backbone=BackboneConfig(
        d_model=2048,
        n_layer=26,
        attn_mlp_d_intermediate=8192,
        attn_cfg=_freeze({"num_heads": 32, "num_heads_kv": 8}),
    ),
    prefix_conditioner=PrefixConditionerConfig.from_dict(
        {"projection": "linear",
         "conditioners": list(_ZONOS_V01_CONDITIONERS)}
    ),
)

DEFAULT_TRANSFORMER_CONFIG = ZONOS_V01_TRANSFORMER

# Hybrid (Mamba-2 + attention) flagship-scale stand-in (~1.5B params:
# 42 Mamba-2 blocks + 6 GQA attention blocks with SwiGLU MLPs). The real
# hybrid topology comes from the checkpoint's config.json
# (reference model.py:61,69 — ssm_cfg non-empty routes to the hybrid
# backbone, model.py:73); this literal exists for benches/dry-runs in
# checkpoint-less environments. Hybrid checkpoints also carry the
# quality conditioners (CONDITIONING_README.md:73-120).
_ZONOS_V01_HYBRID_EXTRA_CONDITIONERS = (
    {"type": "FourierConditioner", "name": "vqscore_8", "input_dim": 8,
     "min_val": 0.5, "max_val": 0.8, "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "ctc_loss", "min_val": -1.0,
     "max_val": 1000.0, "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "dnsmos_ovrl", "min_val": 1.0,
     "max_val": 5.0, "uncond_type": "learned"},
    {"type": "IntegerConditioner", "name": "speaker_noised", "min_val": 0,
     "max_val": 1, "uncond_type": "learned"},
)

ZONOS_V01_HYBRID = ZonosConfig(
    backbone=BackboneConfig(
        d_model=2048,
        n_layer=48,
        d_intermediate=0,
        attn_mlp_d_intermediate=8192,
        attn_layer_idx=(7, 15, 23, 31, 39, 47),
        ssm_cfg=_freeze({"layer": "Mamba2", "d_state": 128, "headdim": 64,
                         "chunk_size": 128}),
        attn_cfg=_freeze({"num_heads": 16, "num_heads_kv": 4,
                          "rotary_emb_dim": 64}),
        rms_norm=True,
        residual_in_fp32=True,
    ),
    prefix_conditioner=PrefixConditionerConfig.from_dict(
        {"projection": "linear",
         "conditioners": list(_ZONOS_V01_CONDITIONERS)
         + list(_ZONOS_V01_HYBRID_EXTRA_CONDITIONERS)}
    ),
)
