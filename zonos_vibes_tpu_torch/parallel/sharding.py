"""The device mesh, and each rank's slices of the parameters and the cache.

The JAX package names a ``jax.sharding.Mesh`` with axes ``(data, model,
pipe, expert)`` and gives every parameter a ``PartitionSpec``; GSPMD slices
the arrays and inserts the collectives. The port builds the same mesh over
``torch.distributed`` (:func:`make_mesh`), and each rank holds explicit
slices of the full tree (:func:`shard_zonos_params`): Megatron-style tensor
parallelism on ``model`` (the qkv projection and fc1 split by columns,
out_proj and fc2 by contraction rows, the output heads by vocab columns),
contiguous runs of layers on ``pipe``, everything else whole. The layouts
are the port's own: what matches JAX is the result for the same logical
weights, not the buffers.

The transformer backbone only, with float or int8 projections. The hybrid
(its Mamba ``in_proj`` mixes ``z | xBC | dt``) and grouped int4 trees (the
contraction split moves to the group axis) are not split yet: ROADMAP.md
queue 1, item 7.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import BackboneConfig, MeshConfig
from ..models.backbone import allocate_kv_cache

DATA, MODEL, PIPE, EXPERT = "data", "model", "pipe", "expert"
_ROADMAP_NEXT = "ROADMAP.md queue 1, item 7"


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """The ``(data, model, pipe, expert)`` mesh over the initialised process
    group, whose world size must be ``cfg.num_devices``: rank ``r`` sits at
    the row-major coordinates of ``r`` in ``cfg.shape`` (JAX reshapes its
    device list the same way). Every rank calls it (it creates one group per
    axis)."""
    world = torch.distributed.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} ranks, the process group "
                         f"has {world}")
    return init_device_mesh(device_type, cfg.shape, mesh_dim_names=cfg.axis_names)


def check_supported(params: dict, backbone: BackboneConfig, model_size: int) -> None:
    """Refuse, naming the ROADMAP item, a tree the parallel layer does not
    split yet; and head counts the model axis does not divide."""
    if backbone.is_hybrid:
        raise NotImplementedError(f"the hybrid backbone under the parallel layer is not ported "
                                  f"({_ROADMAP_NEXT})")
    layers = params["backbone"]["layers"]
    if any("weight_int4" in leaf for leaf in layers.values()):
        raise NotImplementedError(f"int4 weight trees under the parallel layer are not ported "
                                  f"({_ROADMAP_NEXT})")
    if backbone.num_heads_kv % model_size:
        raise ValueError(f"{backbone.num_heads_kv} kv heads do not split over a model axis of "
                         f"{model_size}")


def _cols(x: torch.Tensor, start: int, width: int) -> torch.Tensor:
    return x[..., start: start + width]


def _split_cols(leaf: dict, spans) -> dict:
    """A column-parallel slice: the columns ``spans`` (``(start, width)``
    pairs, concatenated in order) of the weight and, for an int8 leaf, of
    its per-column scale with it."""
    return {k: torch.cat([_cols(t, a, w) for a, w in spans], dim=-1).contiguous()
            for k, t in leaf.items()}


def _split_rows(leaf: dict, start: int, rows: int) -> dict:
    """A row-parallel slice: rows ``[start, start + rows)`` of the weight's
    contraction axis. An int8 leaf keeps its whole per-column scale: it is
    applied to each rank's fp32 partial, which commutes with the sum."""
    out = {}
    for k, t in leaf.items():
        out[k] = t if k == "scale" else t[..., start: start + rows, :].contiguous()
    return out


def tp_slices(params: dict, cfg: BackboneConfig, rank: int, n: int) -> dict:
    """Rank ``rank`` of ``n``'s tensor-parallel slices of a full tree
    (stacked ``[L, ...]`` layers), the rest whole."""
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim
    F = cfg.attn_mlp_d_intermediate
    hq, hkv, f = Hq // n, Hkv // n, F // n
    layers = params["backbone"]["layers"]
    # Trap: the fused in_proj is q | k | v. JAX gives it P(None, None, MODEL),
    # a contiguous split of the fused axis that GSPMD repairs by resharding;
    # an explicit column split must take this rank's q heads, its k heads and
    # its v heads (at TP 2 on the flagship: 1024 + 256 + 256 of 3072).
    qkv = [(rank * hq * Dh, hq * Dh), (Hq * Dh + rank * hkv * Dh, hkv * Dh),
           ((Hq + Hkv) * Dh + rank * hkv * Dh, hkv * Dh)]
    # Trap: fc1 is [y | gate] halves (ops/mlp.py); a rank takes its slice of each.
    fc1 = [(rank * f, f), (F + rank * f, f)]
    local = dict(layers)
    local["in_proj"] = _split_cols(layers["in_proj"], qkv)
    local["out_proj"] = _split_rows(layers["out_proj"], rank * hq * Dh, hq * Dh)
    local["fc1"] = _split_cols(layers["fc1"], fc1)
    local["fc2"] = _split_rows(layers["fc2"], rank * f, f)
    heads = params["heads"]
    # Heads shard on the vocab: 1152 columns divide by 2, 4 and 8.
    V = next(iter(heads.values())).shape[-1]
    if V % n:
        raise ValueError(f"{V} head columns do not split over a model axis of {n}")
    return {**params, "backbone": {**params["backbone"], "layers": local},
            "heads": _split_cols(heads, [(rank * V // n, V // n)])}


def pp_slices(params: dict, rank: int, n: int) -> dict:
    """Rank ``rank`` of ``n``'s pipeline stage: layers ``[rank * L / n, (rank +
    1) * L / n)`` of every layer leaf; embeddings, heads, the final norm and
    the conditioners whole (they run outside the pipeline)."""
    layers = params["backbone"]["layers"]
    L = layers["norm1"]["weight"].shape[0]
    if L % n:
        raise ValueError(f"{L} layers do not split over {n} pipeline stages")
    a, b = rank * L // n, (rank + 1) * L // n
    local = {name: {k: t[a:b].contiguous() for k, t in leaf.items()}
             for name, leaf in layers.items()}
    return {**params, "backbone": {**params["backbone"], "layers": local}}


def shard_zonos_params(params: dict, mesh: DeviceMesh, cfg: BackboneConfig) -> dict:
    """This rank's slices of a full port tree (``utils/checkpoint.
    params_from_jax``, float or int8 projections): its stage's layers on
    ``pipe``, its tensor-parallel slices on ``model``; whole over ``data``
    and ``expert``."""
    n_model, n_pipe = axis_size(mesh, MODEL), axis_size(mesh, PIPE)
    check_supported(params, cfg, n_model)
    out = params  # an axis of one rank keeps the tree's own tensors
    if n_pipe > 1:
        out = pp_slices(out, mesh.get_local_rank(PIPE), n_pipe)
    if n_model > 1:
        out = tp_slices(out, cfg, mesh.get_local_rank(MODEL), n_model)
    return out


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def join_tp_layers(shards: list[dict], cfg: BackboneConfig) -> dict:
    """The full layer tree from every model rank's :func:`tp_slices` layer
    tree, in rank order (stacked ``[L, ...]`` leaves or one layer's)."""
    n = len(shards)
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim
    hq, hkv, f = Hq // n, Hkv // n, cfg.attn_mlp_d_intermediate // n
    full = dict(shards[0])
    full["in_proj"] = _join_cols([s["in_proj"] for s in shards], [hq * Dh, hkv * Dh, hkv * Dh])
    full["out_proj"] = _join_rows([s["out_proj"] for s in shards])
    full["fc1"] = _join_cols([s["fc1"] for s in shards], [f, f])
    full["fc2"] = _join_rows([s["fc2"] for s in shards])
    return full


def _join_cols(leaves: list[dict], widths: list[int]) -> dict:
    """Inverse of :func:`_split_cols`: each rank's pieces of the given widths,
    piece by piece (all ranks' first pieces, then all ranks' second ...)."""
    out = {}
    for k in leaves[0]:
        pieces = [leaf[k].split(widths, dim=-1) for leaf in leaves]
        out[k] = torch.cat([p[i] for i in range(len(widths)) for p in pieces], dim=-1)
    return out


def _join_rows(leaves: list[dict]) -> dict:
    return {k: leaves[0][k] if k == "scale" else torch.cat([leaf[k] for leaf in leaves], dim=-2)
            for k in leaves[0]}


def unshard_tp(shards: list[dict], cfg: BackboneConfig) -> dict:
    """The full tree from every model rank's :func:`tp_slices`, in rank order."""
    layers = join_tp_layers([s["backbone"]["layers"] for s in shards], cfg)
    heads = _join_cols([s["heads"] for s in shards],
                       [next(iter(shards[0]["heads"].values())).shape[-1]])
    return {**shards[0], "backbone": {**shards[0]["backbone"], "layers": layers}, "heads": heads}


def allocate_local_cache(cfg: BackboneConfig, batch: int, max_seqlen: int, dtype, device,
                         *, model: int = 1, layers: int | None = None) -> dict:
    """A rank's KV cache: ``[L, batch, T, (Hkv / model) * Dh]`` (and its
    stage) for ``batch`` rows (this data rank's), ``layers`` layers
    (default: all). A bf16 or fp32 cache: an int8 KV cache under the
    parallel layer is not ported (ROADMAP.md queue 1, item 7)."""
    return allocate_kv_cache(cfg, batch, max_seqlen, dtype, device,
                             layers=cfg.n_layer if layers is None else layers,
                             kv_heads=cfg.num_heads_kv // model)
