"""Sequence-parallel prefill of the transformer backbone (the JAX package's
``parallel/sp_prefill.py``).

Prefill is the one phase with enough positions to split: conditioning and
an audio prefix of hundreds to thousands of frames. Each rank of a group
runs the whole layer stack on its contiguous chunk of the sequence. Norms,
projections and the MLP are row-wise in the sequence; attention, the only
operation across positions, goes through ring attention or Ulysses
(:mod:`.ring_attention`). Each layer's K/V chunk is written into the
standard decode cache, so decode runs unchanged after it.

Weights: a rank either holds the whole layers, or (``gather_weights``, the
parallel engine's case) only its tensor-parallel slices, which are gathered
over the group one layer at a time and dropped after it; that all-gather is
what GSPMD inserts in the JAX package, whose prefill also reads
model-sharded weights.

The cache is written at positions ``[0, S)`` in either of two layouts,
told apart by its width: all kv heads (the standard single-card cache, as
the JAX function writes it: the chunks are gathered along the sequence) or
this rank's ``Hkv / n`` heads (a tensor-parallel rank's cache: one
all-to-all turns sequence chunks into head groups).
"""

from __future__ import annotations

import torch

from ..config import BackboneConfig
from ..models.backbone import _block
from ..ops.norms import layer_norm
from ..ops.rope import rope_table
from .comm import Comm
from .ring_attention import ring_attention_prefill, ulysses_prefill
from .sharding import join_tp_layers

METHODS = {"ring": ring_attention_prefill, "ulysses": ulysses_prefill}
_TP_LEAVES = ("in_proj", "out_proj", "fc1", "fc2")


def _gathered_layer(lp: dict, cfg: BackboneConfig, comm: Comm) -> dict:
    """One layer's whole weights from every rank's tensor-parallel slices."""
    per_rank = [dict(lp) for _ in range(comm.size)]
    for name in _TP_LEAVES:
        parts = {k: comm.all_gather(t[None], dim=0).unbind(0) for k, t in lp[name].items()}
        for r in range(comm.size):
            per_rank[r][name] = {k: v[r] for k, v in parts.items()}
    return join_tp_layers(per_rank, cfg)


def _write_kv(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor, comm: Comm,
              head_dim: int) -> None:
    """This layer's K/V chunks ``[B, S_c, Hkv, Dh]`` into the cache at
    positions ``[0, n * S_c)``: all heads, or this rank's (module docstring)."""
    B, S_c, Hkv, _ = k.shape
    heads = cache["k"].shape[-1] // head_dim
    for name, x in (("k", k), ("v", v)):
        if heads == Hkv:
            rows = comm.all_gather(x, dim=1)
        elif heads * comm.size == Hkv:
            rows = comm.all_to_all(x, split_dim=2, concat_dim=1)
        else:
            raise ValueError(f"sp_prefill_forward: a cache of {heads} kv heads is neither "
                             f"all {Hkv} nor a rank's {Hkv // comm.size}")
        cache[name][layer, :, : rows.shape[1]] = rows.reshape(B, rows.shape[1], -1).to(
            cache[name].dtype)


def sp_prefill_forward(params: dict, cfg: BackboneConfig, hidden: torch.Tensor, cache: dict,
                       comm: Comm, method: str = "ring", rope: torch.Tensor | None = None, *,
                       gather_weights: bool = False) -> torch.Tensor:
    """The first prefill (cache offset 0) of ``hidden [B, S_c, D]``, this
    rank's chunk of ``S = n * S_c`` positions (RoPE at global positions
    ``rank * S_c + i``), over ``params`` (``{"layers", "norm_f"}``, stacked
    layers: whole, or this rank's tensor-parallel slices with
    ``gather_weights``). Writes ``cache`` (module docstring) and returns this
    rank's chunk of the final-normed hidden states; the same as the dense
    prefill up to the order of fp32 sums."""
    if method not in METHODS:
        raise ValueError(f"sp_prefill_forward: method must be one of {sorted(METHODS)}")
    if "weight" not in params["layers"]["in_proj"]:
        raise ValueError("sp_prefill_forward is a float prefill: quantized weights decode "
                         "after a dense prefill")
    attention = METHODS[method]
    B, S_c, _ = hidden.shape
    Dh = cfg.head_dim
    if rope is None:
        rope = rope_table(Dh, device=hidden.device)
    positions = (comm.rank * S_c + torch.arange(S_c, device=hidden.device))[None].expand(B, S_c)
    layers = params["layers"]
    h = hidden
    for l in range(layers["norm1"]["weight"].shape[0]):
        lp = {name: {k: t[l] for k, t in leaf.items()} for name, leaf in layers.items()}
        if gather_weights:
            lp = _gathered_layer(lp, cfg, comm)

        def attend(q, k, v, l=l):
            _write_kv(cache, l, k, v, comm, Dh)
            return attention(q, k, v, comm)

        h = _block(lp, cfg, h, attend, positions, rope)
    nf = params["norm_f"]
    return layer_norm(h, nf["weight"], nf["bias"], cfg.norm_epsilon)
