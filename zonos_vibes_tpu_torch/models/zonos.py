"""Zonos model core (the JAX package's ``models/zonos.py``): code embeddings,
output heads, the CFG mix and conditioning.

The 9 per-codebook embedding tables (1026 rows) and output heads are stacked
on a leading codebook axis. Heads are padded from 1025 to 1152 columns and
every logit at or above 1025 is forced to ``NEG_INF``, so MASK and the pad
slots are never sampled. Head logits are fp32: the bf16 hidden state and
weights are widened before the product (exact), as JAX contracts them with
an fp32 result type; a bf16 product would round the logits and move the
sampled tokens. int8 heads (``ops/quant``) run the int8 matmul kernel, all
9 in one launch, with the scale on the fp32 logits; int8 embedding tables
dequantize only the gathered rows.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..config import ZonosConfig
from ..ops.attention import NEG_INF
from ..ops.cuda.qmm import qmm_int8
from ..ops.rope import rope_table
from .conditioners import PrefixConditioner
from .registry import backbone_for_config


@dataclass(frozen=True)
class ZonosModel:
    """Config wrapper; parameters travel separately as a dict of tensors."""

    config: ZonosConfig

    @functools.cached_property
    def backbone(self):
        return backbone_for_config(self.config.backbone)

    @property
    def prefix_conditioner(self) -> PrefixConditioner:
        return PrefixConditioner(self.config.prefix_conditioner, self.config.backbone.d_model)

    @property
    def head_out_dim(self) -> int:
        """Head vocab (1025) padded to ``head_pad_to_multiple`` (1152)."""
        m = self.config.head_pad_to_multiple
        n = self.config.head_vocab_size
        return n if n % m == 0 else n + m - (n % m)

    def init(self, gen: torch.Generator, dtype=torch.bfloat16, device="cpu") -> dict:
        """Random parameters at the shapes of the JAX ``init``, from ``gen``."""
        cfg = self.config
        D, K = cfg.backbone.d_model, cfg.num_codebooks

        def normal(shape):
            return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

        return {
            "embeddings": {"weight": normal((K, cfg.vocab_size, D)).to(dtype)},
            "heads": {"weight": (normal((K, D, self.head_out_dim)) / D ** 0.5).to(dtype)},
            "backbone": self.backbone.init(gen, dtype, device),
            "prefix_conditioner": self.prefix_conditioner.init(gen, dtype, device),
        }

    def embed_codes(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, S]`` codes -> ``[B, S, D]``: the sum over codebooks. An
        int8 table (scale ``[K, 1, D]``) sums the dequantized rows in fp32 and
        returns its ``act_dtype`` marker's dtype."""
        e = params["embeddings"]
        w = e.get("weight_int8", e.get("weight"))  # [K, V, D]
        idx = torch.arange(w.shape[0], device=codes.device)[None, :, None]
        rows = w[idx, codes.long()]  # [B, K, S, D]
        if "weight_int8" in e:
            return (rows.float() * e["scale"][None]).sum(dim=1).to(e["act_dtype"].dtype)
        return rows.sum(dim=1)

    def apply_heads(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """``[B, S, D] -> [B, K, S, V]`` fp32 logits."""
        h = params["heads"]
        if "weight_int8" in h:
            B, S, D = hidden.shape
            K, _, V = h["weight_int8"].shape
            y = qmm_int8(hidden.reshape(B * S, D).contiguous(), h["weight_int8"], h["scale"],
                         torch.float32)  # [B*S, K, V]
            return y.reshape(B, S, K, V).permute(0, 2, 1, 3)
        return torch.einsum("bsd,kdv->bksv", hidden.float(), h["weight"].float())

    def allocate_cache(self, batch_size: int, max_seqlen: int, dtype, device,
                       kv_int8: bool = False, state_bf16: bool = False,
                       pool_ring: bool = False) -> dict:
        """The backbone's cache. ``kv_int8`` (transformer only) stores the
        flushed KV prefix as int8; ``state_bf16`` (hybrid only) stores the
        SSM state in bf16; ``pool_ring`` gives a hybrid cache the pool's
        ring stages (a transformer cache always carries its stage)."""
        if self.config.backbone.is_hybrid:
            if kv_int8:
                raise NotImplementedError("int8 KV on the hybrid backbone is not supported, as "
                                          "in the JAX package")
            state_dtype = torch.bfloat16 if state_bf16 else torch.float32
            return self.backbone.allocate_cache(batch_size, max_seqlen, dtype, device,
                                                state_dtype=state_dtype, pool_ring=pool_ring)
        if state_bf16:
            raise ValueError("state_bf16 is hybrid-only: a transformer cache has no SSM state")
        return self.backbone.allocate_cache(batch_size, max_seqlen, dtype, device, kv_int8)

    def rope_for(self, device):
        """The transformer's RoPE table, or None: the hybrid computes its
        rotary angles per layer."""
        if self.config.backbone.is_hybrid:
            return None
        return rope_table(self.config.backbone.head_dim, device=device)

    def backbone_forward(self, params: dict, hidden, cache: dict, offset, rope,
                         capture_fc2: bool = False):
        """The backbone over ``hidden`` (a prefill or a whole teacher-forced
        sequence), the cache updated in place; with ``capture_fc2`` (the
        transformer only) also the ``[L, F]`` fc2-input energies for
        ``ops/quant.awq_fold``."""
        if capture_fc2:
            if self.config.backbone.is_hybrid:
                raise ValueError("capture_fc2 is a transformer calibration tap; the hybrid "
                                 "has no AWQ fold")
            return self.backbone.forward(params["backbone"], hidden, cache, offset, rope,
                                         capture_fc2=True)
        return self.backbone.forward(params["backbone"], hidden, cache, offset, rope)

    def compute_logits(self, params: dict, hidden, cache: dict, offset, cfg_scale,
                       rope, stage_base=None, *, positions=None, pool_base=None):
        """Backbone -> last position -> heads -> CFG mix -> pad mask.
        ``hidden`` is the CFG-doubled ``[2B, S, D]``; returns ``[B, K, V]``
        fp32 logits (the cache is updated in place). ``cfg_scale`` is a
        float, or a ``[B]`` tensor of per-row scales (the pool's runtime
        knob, mixed even where it is 1). A solo decode step's ``offset``
        (and the transformer's ``stage_base``) may be device tensors, passed
        through to the backbone, so that no host value enters the step.
        ``positions`` (and, for ring mode, ``pool_base``) go to the
        backbone's pooled decode."""
        logits = self.forward_logits(params, hidden, cache, offset, rope, stage_base,
                                     positions=positions, pool_base=pool_base)
        if isinstance(cfg_scale, torch.Tensor):
            cond, uncond = logits.chunk(2, dim=0)
            logits = uncond + (cond - uncond) * cfg_scale.float()[:, None, None]
        elif cfg_scale != 1.0:
            cond, uncond = logits.chunk(2, dim=0)
            logits = uncond + (cond - uncond) * cfg_scale
        mask_from = self.config.head_vocab_size
        logits[..., mask_from:] = NEG_INF
        return logits

    def forward_logits(self, params: dict, hidden, cache: dict, offset, rope, stage_base=None, *,
                       positions=None, pool_base=None) -> torch.Tensor:
        """Backbone -> last position -> heads: the ``[2B, K, V]`` fp32 logits
        of every row before the CFG mix (the parallel layer's model gathers
        them here from its ranks)."""
        out = self.backbone.forward(params["backbone"], hidden, cache, offset, rope, stage_base,
                                    positions=positions, pool_base=pool_base)
        return self.apply_heads(params, out[:, -1:, :])[:, :, 0, :]

    def prepare_conditioning(self, params: dict, cond_dict: dict,
                             uncond_dict: dict | None = None) -> torch.Tensor:
        """``[cond; uncond]`` stacked on the batch: CFG doubling."""
        pc = self.prefix_conditioner
        missing = pc.required_keys - set(cond_dict)
        if missing:
            raise ValueError(f"Missing required keys: {missing}")
        if uncond_dict is None:
            uncond_dict = {k: cond_dict[k] for k in pc.required_keys}
        p = params["prefix_conditioner"]
        return torch.cat([pc.apply(p, cond_dict), pc.apply(p, uncond_dict)], dim=0)
