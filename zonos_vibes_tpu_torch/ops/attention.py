"""GQA attention with a preallocated KV cache: the plain PyTorch versions.

Semantics match the JAX package's ``ops/attention.py``: fused qkv with no
bias, interleaved-pair RoPE applied by the caller, causal attention inside
a prefill chunk, and single-query decode over the whole valid prefix with no
mask on the left-padded conditioning positions. Softmax runs in fp32.

Layout: one layer's cache is TIME-MAJOR ``[B, T, Hkv * D]``, the layout of
the decode stage, so a stage flush is one contiguous copy and a position's
K (or V) for all heads is one contiguous row. (The JAX package keeps a
time-minor ``[B, Hkv, D, T]`` cache for the TPU's lane tiling; parity is held
on outputs for the same logical inputs.)

These functions are the CPU path and the references the kernels in
``ops/cuda/`` are held against; the model calls the kernel wrappers, which
fall back to them only for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def update_kv_cache(k_cache, v_cache, k, v, offset):
    """Write ``k, v`` ``[B, S, Hkv, D]`` into ``[B, T, Hkv * D]`` caches at
    positions ``[offset, offset + S)``, in place. Returns the caches.
    ``offset`` is a host int or a one-element device tensor (the decode
    step's position, read by an indexed copy and never by the host)."""
    B, S = k.shape[:2]
    for cache, x in ((k_cache, k), (v_cache, v)):
        x = x.reshape(B, S, -1).to(cache.dtype)
        if isinstance(offset, torch.Tensor):
            cache.index_copy_(1, offset.reshape(1) + torch.arange(S, device=offset.device), x)
        else:
            cache[:, offset: offset + S] = x
    return k_cache, v_cache


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q [B,S,Hq,D] x k [B,T,Hkv*D] -> scores [B,Hkv,G,S,T]`` (fp32)."""
    B, S, Hq, D = q.shape
    T = k.shape[1]
    Hkv = k.shape[2] // D
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D).float()
    kk = k.reshape(B, T, Hkv, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kk)
    return scores * (1.0 / math.sqrt(D))


def _apply_scores(probs: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """``probs [B,Hkv,G,S,T] x v [B,T,Hkv*D] -> [B,S,Hq,D]``. The
    probabilities round to the cache dtype before the product, as in JAX."""
    B, Hkv, G, S, T = probs.shape
    vv = v.reshape(B, T, Hkv, -1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(), vv.float())
    return out.reshape(B, S, Hkv * G, -1).to(out_dtype)


def prefill_attention(q, k_cache, v_cache, offset: int) -> torch.Tensor:
    """Causal attention for a chunk already written into the cache: query
    ``i`` (absolute ``offset + i``) attends cache positions
    ``[0, offset + i]``. ``q [B, S, Hq, D]``, caches ``[B, T, Hkv*D]``."""
    S = q.shape[1]
    T = k_cache.shape[1]
    scores = _grouped_scores(q, k_cache)
    key_pos = torch.arange(T, device=q.device)[None, :]
    qry_pos = offset + torch.arange(S, device=q.device)[:, None]
    scores = scores.masked_fill(key_pos > qry_pos, NEG_INF)
    return _apply_scores(torch.softmax(scores, dim=-1), v_cache, q.dtype)


def decode_attention(q, k_cache, v_cache, seq_end: int) -> torch.Tensor:
    """Single-query attention over positions ``[0, seq_end)``.
    ``q [B, 1, Hq, D]``, caches ``[B, T, Hkv*D]``; returns ``[B, 1, Hq, D]``."""
    T = k_cache.shape[1]
    scores = _grouped_scores(q, k_cache)
    valid = torch.arange(T, device=q.device) < seq_end
    scores = scores.masked_fill(~valid, NEG_INF)
    return _apply_scores(torch.softmax(scores, dim=-1), v_cache, q.dtype)
