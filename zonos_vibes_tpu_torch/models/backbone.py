"""Transformer backbone: the JAX package's ``models/backbone.py`` in PyTorch.

Pre-LN blocks ``x += Attn(LN(x)); x += SwiGLU(LN(x))`` and a final
LayerNorm; GQA attention with a fused qkv projection, interleaved-pair RoPE
and a preallocated KV cache. Parameters are a dict of tensors with the JAX
package's tree and layouts (a leading ``[n_layer]`` axis on every layer
tensor, weights ``[in, out]``), so ``utils/checkpoint.params_from_jax``
carries them across unchanged.

The KV cache keeps the JAX design: a flushed prefix, a small stage of the
most recent positions, and the current token's column, with flushes at
canonical absolute boundaries. Its buffers are time-major:

* ``k``, ``v``: ``[L, B, T, Hkv*Dh]`` flushed prefix (and the prefill);
* ``k_stage``, ``v_stage``: ``[L, B, STAGE, Hkv*Dh]`` unflushed tail.

A flush is then one contiguous copy per (layer, row). On a CUDA device the
decode step runs ``ops/cuda``'s decode-attention kernel per layer and two
stage splices per step, and prefill runs the prefill-attention kernel per
layer; on the CPU the same wrappers run their plain versions.
"""

from __future__ import annotations

import torch

from ..config import BackboneConfig
from ..ops.attention import update_kv_cache
from ..ops.cuda.decode_attention import decode_attention_layered
from ..ops.cuda.prefill_attention import prefill_attention
from ..ops.cuda.stage_write import stage_splice
from ..ops.mlp import swiglu_mid
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope

# Decode-tail stage depth (the JAX package's KV_STAGE).
KV_STAGE = 128


def init_transformer_backbone(gen: torch.Generator, cfg: BackboneConfig, dtype, device) -> dict:
    """Random parameters with the shapes of the JAX ``init`` (normal /
    sqrt(fan_in) weights, unit norms), drawn from ``gen``."""
    L, D = cfg.n_layer, cfg.d_model
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim
    F = cfg.attn_mlp_d_intermediate
    qkv_out = (Hq + 2 * Hkv) * Dh

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w / fan_in ** 0.5).to(dtype)

    f32 = torch.float32
    return {
        "layers": {
            "norm1": {"weight": torch.ones((L, D), dtype=f32, device=device),
                      "bias": torch.zeros((L, D), dtype=f32, device=device)},
            "in_proj": {"weight": dense((L, D, qkv_out), D)},
            "out_proj": {"weight": dense((L, Hq * Dh, D), Hq * Dh)},
            "norm2": {"weight": torch.ones((L, D), dtype=f32, device=device),
                      "bias": torch.zeros((L, D), dtype=f32, device=device)},
            "fc1": {"weight": dense((L, D, 2 * F), D)},
            "fc2": {"weight": dense((L, F, D), F)},
        },
        "norm_f": {"weight": torch.ones((D,), dtype=dtype, device=device),
                   "bias": torch.zeros((D,), dtype=dtype, device=device)},
    }


def allocate_kv_cache(cfg: BackboneConfig, batch_size: int, max_seqlen: int, dtype,
                      device) -> dict:
    """Zeroed time-major cache ``[L, B, T, Hkv*Dh]`` and stage
    ``[L, B, min(KV_STAGE, T), Hkv*Dh]``."""
    L, W = cfg.n_layer, cfg.num_heads_kv * cfg.head_dim
    stage = min(KV_STAGE, max_seqlen)

    def zeros(t):
        return torch.zeros((L, batch_size, t, W), dtype=dtype, device=device)

    return {"k": zeros(max_seqlen), "v": zeros(max_seqlen),
            "k_stage": zeros(stage), "v_stage": zeros(stage)}


def flush_kv_stage(cache: dict, stage_base: int) -> dict:
    """Copy the full stage into the cache at ``[stage_base, stage_base +
    STAGE)``, in place. The decode loop calls it only when the stage is
    exactly full."""
    depth = cache["k_stage"].shape[2]
    cache["k"][:, :, stage_base: stage_base + depth] = cache["k_stage"]
    cache["v"][:, :, stage_base: stage_base + depth] = cache["v_stage"]
    return cache


def _block(lp: dict, cfg: BackboneConfig, x, attend, positions, table):
    """One block over this layer's parameters ``lp``; ``attend(q, k, v)``
    returns ``[B, S, Hq, Dh]``."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim
    h = layer_norm(x, lp["norm1"]["weight"], lp["norm1"]["bias"], cfg.norm_epsilon)
    q, k, v = torch.matmul(h, lp["in_proj"]["weight"]).split(
        [Hq * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    q = apply_rope(q.reshape(B, S, Hq, Dh), positions, table)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, table)
    y = attend(q, k, v.reshape(B, S, Hkv, Dh))
    x = x + torch.matmul(y.reshape(B, S, Hq * Dh), lp["out_proj"]["weight"])
    h = layer_norm(x, lp["norm2"]["weight"], lp["norm2"]["bias"], cfg.norm_epsilon)
    return x + torch.matmul(swiglu_mid(h, lp["fc1"]), lp["fc2"]["weight"])


def transformer_forward(params: dict, cfg: BackboneConfig, hidden: torch.Tensor, cache: dict,
                        offset: int, rope: torch.Tensor, stage_base: int | None = None):
    """Layer stack and final LayerNorm; updates ``cache`` in place.

    ``hidden [B, S, D]``. With ``S > 1`` (prefill) the chunk is written at
    cache positions ``[offset, offset + S)`` and attends causally. With
    ``S == 1`` (staged decode) ``offset`` is the absolute position of the
    token, ``stage_base`` the flushed-prefix length: the token attends the
    prefix ``[0, stage_base)``, stage rows ``[0, offset - stage_base)`` and
    itself, and its columns land in stage slot ``offset - stage_base``.
    RoPE positions are ``offset + arange(S)`` for every row.
    """
    B, S, _ = hidden.shape
    layers = params["layers"]
    L = cfg.n_layer
    W = cfg.num_heads_kv * cfg.head_dim
    dev = hidden.device
    positions = (offset + torch.arange(S, device=dev))[None, :].expand(B, S)

    if S > 1:
        def attend_for(l):
            def attend(q, k, v):
                kc, vc = update_kv_cache(cache["k"][l], cache["v"][l], k, v, offset)
                return prefill_attention(q, kc, vc, offset)
            return attend
    else:
        if stage_base is None:
            raise ValueError("single-token decode runs on the staged cache: pass stage_base")
        stage_len = offset - stage_base
        # (flushed_end, stage_len, layer) per layer, one copy to the device.
        scalars = torch.tensor([[stage_base, stage_len, l] for l in range(L)],
                               dtype=torch.int32).to(dev)
        k_cols = torch.empty((L, B, W), dtype=cache["k_stage"].dtype, device=dev)
        v_cols = torch.empty_like(k_cols)

        def attend_for(l):
            def attend(q, k, v):
                k_cols[l] = k.reshape(B, W)
                v_cols[l] = v.reshape(B, W)
                return decode_attention_layered(
                    q, cache["k"], cache["v"], cache["k_stage"], cache["v_stage"],
                    k_cols[l], v_cols[l], scalars[l])
            return attend

    for l in range(L):
        lp = {name: {k: t[l] for k, t in leaf.items()} for name, leaf in layers.items()}
        hidden = _block(lp, cfg, hidden, attend_for(l), positions, rope)

    if S == 1:
        slot = scalars[0, 1:2]
        stage_splice(cache["k_stage"], k_cols, slot)
        stage_splice(cache["v_stage"], v_cols, slot)
    nf = params["norm_f"]
    return layer_norm(hidden, nf["weight"], nf["bias"], cfg.norm_epsilon)


class TransformerBackbone:
    """Uniform interface over the functional stack (the JAX package's
    ``TransformerBackbone``)."""

    def __init__(self, cfg: BackboneConfig):
        if cfg.is_hybrid:
            raise NotImplementedError("the hybrid (Mamba-2) backbone is not ported yet")
        self.cfg = cfg

    def init(self, gen, dtype, device) -> dict:
        return init_transformer_backbone(gen, self.cfg, dtype, device)

    def allocate_cache(self, batch: int, max_seqlen: int, dtype, device) -> dict:
        return allocate_kv_cache(self.cfg, batch, max_seqlen, dtype, device)

    def forward(self, params, hidden, cache, offset, rope, stage_base=None):
        return transformer_forward(params, self.cfg, hidden, cache, offset, rope, stage_base)
