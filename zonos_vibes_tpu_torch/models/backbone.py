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

A flush is then one contiguous copy per (layer, row). With ``kv_int8`` the
flushed prefix is int8 with fp32 per-(position, kv head) scales ``k_scale``,
``v_scale`` ``[L, B, T, Hkv]`` (JAX keeps ``[L, B, Hkv, T]``), quantized once
per flush and once per prefill; the stage and the current column stay
exact. The projections take float, int8 or int4 weights (``ops/quant``).

The continuous-batching pool's decode (``positions`` and ``pool_base``
given) gives every row its own position: the stage is each row's ring, row
``b`` attends its flushed prefix ``[0, pool_base[b])``, ring rows ``[0,
positions[b] - pool_base[b])`` and itself, and its columns land in ring
slot ``positions[b] - pool_base[b]``; ``engine/pool.flush_pool_rings``
copies the rings into the cache once per segment. With ``positions`` alone
(the stage-less pooled decode, JAX's ``forward(pooled=True)`` without
``pool_base``) row ``b`` attends ``[0, positions[b])`` of the cache and
itself, and its columns are written at ``positions[b]`` after the stack.

On a CUDA device the decode step runs ``ops/cuda``'s decode-attention kernel
(or its int8-prefix variant, or their pooled versions) per layer, which
also stores the layer's columns into their stage slot (JAX splices them
after the layer scan; no layer reads another's stage plane within a step,
so the stage is the same), prefill runs the prefill-attention kernel per
layer, and int8 and int4 projections run the int8 and packed-int4 matmul
kernels; on the CPU the same wrappers run their plain versions.
"""

from __future__ import annotations

import torch

from ..config import BackboneConfig
from ..ops.attention import update_kv_cache
from ..ops.cuda.decode_attention import (
    decode_attention_layered,
    decode_attention_layered_q,
    decode_attention_pooled_staged,
    decode_attention_pooled_staged_q,
    decode_attention_pooled_unstaged,
)
from ..ops.cuda.prefill_attention import prefill_attention
from ..ops.mlp import swiglu_mid
from ..ops.norms import layer_norm
from ..ops.quant import dequantize_rows, proj_matmul, proj_matmul_f32, quantize_rows
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
                      device, kv_int8: bool = False, *, layers: int | None = None,
                      kv_heads: int | None = None) -> dict:
    """Zeroed time-major cache ``[L, B, T, Hkv*Dh]`` and stage
    ``[L, B, min(KV_STAGE, T), Hkv*Dh]`` of ``dtype``. With ``kv_int8`` the
    cache is int8 and ``k_scale``/``v_scale`` ``[L, B, T, Hkv]`` fp32 start
    at 1, as in JAX; the stage keeps ``dtype``. ``layers`` and ``kv_heads``
    (default: the config's) size a rank-local cache (``parallel/``)."""
    L = cfg.n_layer if layers is None else layers
    Hkv = cfg.num_heads_kv if kv_heads is None else kv_heads
    W = Hkv * cfg.head_dim
    stage = min(KV_STAGE, max_seqlen)

    def zeros(t, dt):
        return torch.zeros((L, batch_size, t, W), dtype=dt, device=device)

    cache_dtype = torch.int8 if kv_int8 else dtype
    out = {"k": zeros(max_seqlen, cache_dtype), "v": zeros(max_seqlen, cache_dtype),
           "k_stage": zeros(stage, dtype), "v_stage": zeros(stage, dtype)}
    if kv_int8:
        for name in ("k_scale", "v_scale"):
            out[name] = torch.ones((L, batch_size, max_seqlen, Hkv), dtype=torch.float32,
                                   device=device)
    return out


def flush_kv_stage(cache: dict, stage_base: int, scalars: torch.Tensor | None = None) -> dict:
    """Copy the full stage into the cache at ``[stage_base, stage_base +
    STAGE)``, in place, quantizing it first for an int8 cache. The decode
    loop calls it only when the stage is exactly full. ``scalars``, the
    decode's device ``[L, 3]`` ``(flushed_end, stage_len, layer)``, move on
    in place after the copy on the same stream: ``flushed_end`` by STAGE,
    ``stage_len`` to 0."""
    depth = cache["k_stage"].shape[2]
    window = slice(stage_base, stage_base + depth)
    for name in ("k", "v"):
        stage = cache[name + "_stage"]
        if name + "_scale" in cache:
            q, scale = quantize_rows(stage, cache[name + "_scale"].shape[-1])
            cache[name][:, :, window] = q
            cache[name + "_scale"][:, :, window] = scale
        else:
            cache[name][:, :, window] = stage
    if scalars is not None:
        scalars[:, 0] += depth
        scalars[:, 1] = 0
    return cache


def _dequantized_layer(cache: dict, name: str, layer: int, offset: int,
                       length: int) -> torch.Tensor:
    """A ``[B, length, Hkv*Dh]`` scratch of the stage's dtype holding layer
    ``layer``'s int8 positions ``[0, offset)`` dequantized (the rest unset)."""
    q = cache[name][layer, :, :offset]
    B, _, W = q.shape
    out = torch.empty((B, length, W), dtype=cache[name + "_stage"].dtype, device=q.device)
    out[:, :offset] = dequantize_rows(q, cache[name + "_scale"][layer, :, :offset])
    return out


def _row_parallel(x: torch.Tensor, p: dict, reduce) -> torch.Tensor:
    """``x @ W`` for out_proj and fc2. Without ``reduce``, the single-card
    product. With it (tensor parallelism: ``W`` is this rank's slice of the
    contraction rows), trap: row-parallel rounding. The rank's fp32 partial
    goes to ``reduce``, which sums the partials in fp32 over the group, and
    the sum rounds once to ``x.dtype``, as the single-card product rounds
    once; bf16 partials would round twice."""
    if reduce is None:
        return proj_matmul(x, p)
    return reduce(proj_matmul_f32(x, p)).to(x.dtype)


def _block(lp: dict, cfg: BackboneConfig, x, attend, positions, table, energy=None, *,
           heads: tuple[int, int] | None = None, reduce=None):
    """One block over this layer's parameters ``lp``; ``attend(q, k, v)``
    returns ``[B, S, Hq, Dh]``. With a list ``energy``, the fc2 input's
    per-channel sum of squares over (B, S) is appended to it (fp32).

    ``heads`` ``(Hq, Hkv)`` are the heads ``lp`` holds (default: the
    config's). Trap: a tensor-parallel rank's head counts must not come
    from a ``BackboneConfig``, whose ``head_dim`` is ``d_model //
    num_heads``: a config with ``num_heads / n`` would multiply the head
    dim by ``n``. The head dim stays the full config's. ``reduce`` makes
    out_proj and fc2 row-parallel (:func:`_row_parallel`)."""
    B, S, _ = x.shape
    Hq, Hkv = heads if heads is not None else (cfg.num_heads, cfg.num_heads_kv)
    Dh = cfg.head_dim
    h = layer_norm(x, lp["norm1"]["weight"], lp["norm1"]["bias"], cfg.norm_epsilon)
    q, k, v = proj_matmul(h, lp["in_proj"]).split([Hq * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    q = apply_rope(q.reshape(B, S, Hq, Dh), positions, table)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, table)
    y = attend(q, k, v.reshape(B, S, Hkv, Dh))
    x = x + _row_parallel(y.reshape(B, S, Hq * Dh), lp["out_proj"], reduce)
    h = layer_norm(x, lp["norm2"]["weight"], lp["norm2"]["bias"], cfg.norm_epsilon)
    mid = swiglu_mid(h, lp["fc1"])
    if energy is not None:
        energy.append((mid.float() ** 2).sum(dim=(0, 1)))
    return x + _row_parallel(mid, lp["fc2"], reduce)


def stack_forward(layers: dict, cfg: BackboneConfig, hidden: torch.Tensor, cache: dict,
                  offset: int | torch.Tensor, rope: torch.Tensor,
                  stage_base: int | torch.Tensor | None = None, *,
                  positions: torch.Tensor | None = None,
                  pool_base: torch.Tensor | None = None, capture_fc2: bool = False,
                  heads: tuple[int, int] | None = None, layer0: int = 0, reduce=None):
    """The layer stack (``layers``: stacked ``[L, ...]`` leaves), without the
    final LayerNorm; updates ``cache`` in place. JAX's ``_stack_forward``,
    which its pipeline stages call.

    ``hidden [B, S, D]``. With ``S > 1`` (prefill) the chunk is written at
    cache positions ``[offset, offset + S)`` and attends causally. With
    ``S == 1`` (staged decode) ``offset`` is the absolute position of the
    token, ``stage_base`` the flushed-prefix length: the token attends the
    prefix ``[0, stage_base)``, stage rows ``[0, offset - stage_base)`` and
    itself, and its columns land in stage slot ``offset - stage_base``.
    RoPE positions are ``offset + arange(S)`` for every row. For a staged
    decode ``offset`` may be a one-element int64 device tensor and
    ``stage_base`` the device ``[L, 3]`` int32 ``(flushed_end, stage_len,
    layer)`` that the kernel reads: then no host value enters the step,
    which a CUDA graph can capture (the caller advances ``stage_len`` and
    ``offset`` on the device; :func:`flush_kv_stage` moves
    ``flushed_end``).

    With ``positions [B]`` (``S == 1``, device) ``offset`` is unused: they
    are the rows' absolute positions (RoPE and attention bounds). With
    ``pool_base [B]`` too (the pool's ring decode) they are the rows'
    flushed watermarks; without it the decode is stage-less (bf16 or fp32
    cache only). A staged decode's columns reach the stage inside each
    layer's attention call.

    With an int8 cache a prefill attends over a scratch holding the layer's
    dequantized positions ``[0, offset)`` and the exact chunk; the chunk is
    quantized into the cache after.

    ``capture_fc2`` (a prefill only: quantization calibration for
    ``ops/quant.awq_fold``) returns ``(hidden, energy)`` with ``energy [L,
    F]`` fp32, each layer's fc2-input sum of squares over (B, S), as JAX's
    ``capture_fc2``. During decode it raises: JAX's decode scan then
    mis-shapes the K/V columns it emits.

    For the parallel layer (``parallel/``): ``heads`` ``(Hq, Hkv)`` are the
    heads ``layers`` hold (a tensor-parallel rank's; :func:`_block`), the
    cache holds ``Hkv`` heads, and ``reduce`` sums the row-parallel
    partials. Layer ``l`` of ``layers`` uses cache layer ``layer0 + l``
    (and row ``layer0 + l`` of the ``[L_cache, 3]`` device scalars, whose
    layer column says the same): a pipeline stage's microbatches keep
    their caches as consecutive runs of layers of one buffer.
    """
    B, S, _ = hidden.shape
    L = layers["norm1"]["weight"].shape[0]
    Hkv = heads[1] if heads is not None else cfg.num_heads_kv
    W = Hkv * cfg.head_dim
    dev = hidden.device
    kv_int8 = "k_scale" in cache
    pooled = positions is not None
    ring = pool_base is not None
    if (pooled and S != 1) or (ring and not pooled):
        raise ValueError("pooled decode runs one token per row: pass positions (and "
                         "pool_base for ring mode) with S == 1")
    if capture_fc2 and (S == 1 or pooled):
        raise ValueError("capture_fc2 reads a prefill's fc2 inputs; it is not supported "
                         "during decode")
    if pooled:
        if ring:
            bases = pool_base.to(torch.int32).contiguous()
            ring_len = (positions - pool_base).to(torch.int32).contiguous()
        elif kv_int8:
            raise NotImplementedError("the stage-less pooled decode takes a bf16 or fp32 "
                                      "cache, not an int8 one")
        else:
            prefix_ends = positions.to(torch.int32).contiguous()
        row_pos = positions.long()
        positions = row_pos[:, None]
    else:
        positions = (offset + torch.arange(S, device=dev))[None, :].expand(B, S)

    if S > 1 and kv_int8:
        def attend_for(l):
            def attend(q, k, v):
                kc, vc = (_dequantized_layer(cache, name, layer0 + l, offset, offset + S)
                          for name in ("k", "v"))
                update_kv_cache(kc, vc, k, v, offset)
                y = prefill_attention(q, kc, vc, offset)
                for name, exact in (("k", kc), ("v", vc)):
                    qrows, scale = quantize_rows(exact[:, offset:], Hkv)
                    cache[name][layer0 + l, :, offset: offset + S] = qrows
                    cache[name + "_scale"][layer0 + l, :, offset: offset + S] = scale
                return y
            return attend
    elif S > 1:
        def attend_for(l):
            def attend(q, k, v):
                kc, vc = update_kv_cache(cache["k"][layer0 + l], cache["v"][layer0 + l], k, v,
                                         offset)
                return prefill_attention(q, kc, vc, offset)
            return attend
    elif pooled and not ring:
        k_cols = torch.empty((L, B, W), dtype=cache["k"].dtype, device=dev)
        v_cols = torch.empty_like(k_cols)

        def attend_for(l):
            def attend(q, k, v):
                k_cols[l] = k.reshape(B, W)
                v_cols[l] = v.reshape(B, W)
                return decode_attention_pooled_unstaged(
                    q.contiguous(), cache["k"], cache["v"], k_cols[l], v_cols[l], prefix_ends,
                    layer0 + l)
            return attend
    elif pooled:
        # The kernel stores each row's columns in its ring slot ring_len[b];
        # V stays a row view of the qkv projection's output.
        def attend_for(l):
            def attend(q, k, v):
                if kv_int8:
                    return decode_attention_pooled_staged_q(
                        q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                        cache["k_stage"], cache["v_stage"], k.reshape(B, W), v.reshape(B, W),
                        bases, ring_len, layer0 + l)
                return decode_attention_pooled_staged(
                    q, cache["k"], cache["v"], cache["k_stage"], cache["v_stage"],
                    k.reshape(B, W), v.reshape(B, W), bases, ring_len, layer0 + l)
            return attend
    else:
        if stage_base is None:
            raise ValueError("single-token decode runs on the staged cache: pass stage_base")
        if isinstance(stage_base, torch.Tensor):
            scalars = stage_base
        else:
            # (flushed_end, stage_len, layer) per cache layer, one copy to the device.
            scalars = torch.tensor([[stage_base, offset - stage_base, c]
                                    for c in range(cache["k"].shape[0])],
                                   dtype=torch.int32).to(dev)
        # The kernel stores the columns in stage slot stage_len.

        def attend_for(l):
            def attend(q, k, v):
                if kv_int8:
                    return decode_attention_layered_q(
                        q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                        cache["k_stage"], cache["v_stage"], k.reshape(B, W), v.reshape(B, W),
                        scalars[layer0 + l])
                return decode_attention_layered(
                    q, cache["k"], cache["v"], cache["k_stage"], cache["v_stage"],
                    k.reshape(B, W), v.reshape(B, W), scalars[layer0 + l])
            return attend

    energy = [] if capture_fc2 else None
    for l in range(L):
        lp = {name: {k: t[l] for k, t in leaf.items()} for name, leaf in layers.items()}
        hidden = _block(lp, cfg, hidden, attend_for(l), positions, rope, energy, heads=heads,
                        reduce=reduce)

    if pooled and not ring:
        # Each row's columns at its own position (clamped, as JAX's
        # dynamic_update_slice clamps), one indexed copy per K and V.
        rows = torch.arange(B, device=dev)
        idx = row_pos.clamp(0, cache["k"].shape[2] - 1)
        cache["k"][layer0: layer0 + L, rows, idx] = k_cols
        cache["v"][layer0: layer0 + L, rows, idx] = v_cols
    return (hidden, torch.stack(energy)) if capture_fc2 else hidden


def transformer_forward(params: dict, cfg: BackboneConfig, hidden: torch.Tensor, cache: dict,
                        offset: int | torch.Tensor, rope: torch.Tensor,
                        stage_base: int | torch.Tensor | None = None, *,
                        positions: torch.Tensor | None = None,
                        pool_base: torch.Tensor | None = None, capture_fc2: bool = False,
                        heads: tuple[int, int] | None = None, reduce=None):
    """Layer stack (:func:`stack_forward`, whose docstring holds the
    arguments) and final LayerNorm; updates ``cache`` in place."""
    out = stack_forward(params["layers"], cfg, hidden, cache, offset, rope, stage_base,
                        positions=positions, pool_base=pool_base, capture_fc2=capture_fc2,
                        heads=heads, reduce=reduce)
    hidden, energy = out if capture_fc2 else (out, None)
    nf = params["norm_f"]
    out = layer_norm(hidden, nf["weight"], nf["bias"], cfg.norm_epsilon)
    return (out, energy) if capture_fc2 else out


class TransformerBackbone:
    """Uniform interface over the functional stack (the JAX package's
    ``TransformerBackbone``)."""

    def __init__(self, cfg: BackboneConfig):
        self.cfg = cfg

    def init(self, gen, dtype, device) -> dict:
        return init_transformer_backbone(gen, self.cfg, dtype, device)

    def allocate_cache(self, batch: int, max_seqlen: int, dtype, device,
                       kv_int8: bool = False) -> dict:
        return allocate_kv_cache(self.cfg, batch, max_seqlen, dtype, device, kv_int8)

    def forward(self, params, hidden, cache, offset, rope, stage_base=None, *, positions=None,
                pool_base=None, capture_fc2=False):
        return transformer_forward(params, self.cfg, hidden, cache, offset, rope, stage_base,
                                   positions=positions, pool_base=pool_base,
                                   capture_fc2=capture_fc2)
