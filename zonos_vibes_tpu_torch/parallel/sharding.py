"""The device mesh, and each rank's slices of the parameters and the cache.

The JAX package names a ``jax.sharding.Mesh`` with axes ``(data, model,
pipe, expert)`` and gives every parameter a ``PartitionSpec``; GSPMD slices
the arrays and inserts the collectives. The port builds the same mesh over
``torch.distributed`` (:func:`make_mesh`), and each rank holds explicit
slices of the full tree (:func:`shard_zonos_params`): Megatron-style tensor
parallelism on ``model`` (the qkv projection and fc1 split by columns,
out_proj and fc2 by contraction rows, the output heads by vocab columns;
on the hybrid also each Mamba mixer by heads), contiguous runs of layers on
``pipe``, everything else whole. The layouts are the port's own: what
matches JAX is the result for the same logical weights, not the buffers.

Both backbones, with float, int8, int4 (grouped or not) or mixed-width
projections. JAX's GSPMD repairs any contiguous split by resharding; an
explicit split must take each fused segment's own slice, and the traps are
named where they apply: the fused qkv and fc1 (:func:`_attn_slices`), the
Mamba ``in_proj`` that is not a partition (:func:`_mamba_slices`), int4
row splits (:func:`_split_rows`) and int4 column splits
(:func:`_split_cols`).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import BackboneConfig, MeshConfig
from ..models.backbone import allocate_kv_cache
from ..models.mamba_backbone import Mamba2Spec, attention_geometry

DATA, MODEL, PIPE, EXPERT = "data", "model", "pipe", "expert"
# qmm_int4 takes N a multiple of 32 (a 16-byte row copy, ops/cuda/qmm.py).
INT4_COLS = 32


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


def check_supported(backbone: BackboneConfig, model_size: int) -> None:
    """Refuse head counts the model axis does not divide: the attention's
    kv (and query) heads and, on the hybrid, the Mamba heads."""
    if backbone.is_hybrid:
        hq, hkv, _, _ = attention_geometry(backbone)
        counts = {"kv heads": hkv, "query heads": hq,
                  "Mamba heads": Mamba2Spec(backbone.d_model, backbone.ssm_cfg_dict).nheads}
    else:
        counts = {"kv heads": backbone.num_heads_kv}
    for what, c in counts.items():
        if c % model_size:
            raise ValueError(f"{c} {what} do not split over a model axis of {model_size}")


def _is_int4(leaf: dict) -> bool:
    return "weight_int4" in leaf


def _split_cols(leaf: dict, spans, pad_to: int = 1) -> dict:
    """A column-parallel slice: the columns ``spans`` (``(start, width)``
    pairs, concatenated in order) of the weight and, for an int8 or int4
    leaf, of its per-column scale with it.

    Trap: int4 column splits keep byte pairs. Two columns share a byte of
    a packed weight (``ops/cuda/qmm.pack_int4``), so every span must start
    and end on an even column. An int4 slice is padded with zero columns
    and zero scales to a multiple of ``pad_to`` (the caller drops the pad
    columns of the output)."""
    if not _is_int4(leaf):
        return {k: torch.cat([t[..., a: a + w] for a, w in spans], dim=-1).contiguous()
                for k, t in leaf.items()}
    if any(a % 2 or w % 2 for a, w in spans):
        raise ValueError(f"int4 columns are packed in pairs: the column spans {list(spans)} "
                         f"must start and end on even columns")
    pad = -sum(w for _, w in spans) % pad_to
    out = {}
    for k, t in leaf.items():
        half = 2 if k == "weight_int4" else 1
        parts = [t[..., a // half: (a + w) // half] for a, w in spans]
        if pad:
            parts.append(t.new_zeros((*t.shape[:-1], pad // half)))
        out[k] = torch.cat(parts, dim=-1).contiguous()
    return out


def _split_rows(leaf: dict, rank: int, n: int) -> dict:
    """A row-parallel slice: rank ``rank`` of ``n``'s contiguous rows of the
    weight's contraction axis. An int8 leaf keeps its whole per-column
    scale: it is applied to each rank's fp32 partial, which commutes with
    the sum.

    Trap: int4 row splits are contiguous, not JAX's. JAX splits the
    contraction within every group (``[G, group, out]`` sharded on
    ``group``); a row-parallel rank's rows are dictated by the activations
    it owns (its heads' outputs, its FFN columns), which are contiguous. So
    it takes rows ``[r K / n, (r + 1) K / n)`` of the packed ``[K, N / 2]``
    weight with the scales of the groups they fall in: ``G / n`` groups when
    the group size divides ``K / n``, one group's ``[1, 1, N]`` when ``K /
    n`` divides the group size. Partial sums within a group commute with
    that group's scale, so both sum to the total; any other ratio raises."""
    wkey = next(k for k in leaf if k != "scale")
    K = leaf[wkey].shape[-2]
    if K % n:
        raise ValueError(f"{K} contraction rows do not split over a model axis of {n}")
    rows = K // n
    start = rank * rows
    out = {wkey: leaf[wkey][..., start: start + rows, :].contiguous()}
    if "scale" not in leaf:
        return out
    scale = leaf["scale"]
    if not _is_int4(leaf):
        return {**out, "scale": scale}
    gs = K // scale.shape[-3]
    if rows % gs == 0:
        groups = slice(start // gs, (start + rows) // gs)
    elif gs % rows == 0:
        groups = slice(start // gs, start // gs + 1)
    else:
        raise ValueError(f"int4 groups of {gs} rows and a model rank's {rows} contraction rows: "
                         f"neither divides the other")
    return {**out, "scale": scale[..., groups, :, :].contiguous()}


def _attn_slices(layers: dict, heads: tuple[int, int], Dh: int, F: int, rank: int,
                 n: int) -> dict:
    """One rank's slices of attention layers (the transformer's, the
    hybrid's ``attn``) with ``heads`` ``(Hq, Hkv)`` of ``Dh`` and an MLP of
    ``F``, whose other leaves stay whole."""
    Hq, Hkv = heads
    hq, hkv = Hq // n, Hkv // n
    # Trap: the fused in_proj is q | k | v. JAX gives it P(None, None, MODEL),
    # a contiguous split of the fused axis that GSPMD repairs by resharding;
    # an explicit column split must take this rank's q heads, its k heads and
    # its v heads (at TP 2 on the flagship: 1024 + 256 + 256 of 3072).
    qkv = [(rank * hq * Dh, hq * Dh), (Hq * Dh + rank * hkv * Dh, hkv * Dh),
           ((Hq + Hkv) * Dh + rank * hkv * Dh, hkv * Dh)]
    local = dict(layers)
    local["in_proj"] = _split_cols(layers["in_proj"], qkv)
    local["out_proj"] = _split_rows(layers["out_proj"], rank, n)
    return _mlp_slices(local, layers, F, rank, n)


def _mlp_slices(local: dict, layers: dict, F: int, rank: int, n: int) -> dict:
    if "fc1" in layers:
        f = F // n
        # Trap: fc1 is [y | gate] halves (ops/mlp.py); a rank takes its slice of each.
        local["fc1"] = _split_cols(layers["fc1"], [(rank * f, f), (F + rank * f, f)])
        local["fc2"] = _split_rows(layers["fc2"], rank, n)
    return local


def _mamba_slices(layers: dict, s: Mamba2Spec, F: int, rank: int, n: int) -> dict:
    """One rank's slices of the hybrid's Mamba layers (``s``: the full
    geometry): its heads of every mixer leaf, the rest whole."""
    Di, N = s.d_inner, s.d_state
    dl, hl = Di // n, s.nheads // n
    # Trap: the Mamba in_proj is not a partition. Its columns are z | x | B |
    # C | dt (d_inner + d_inner + d_state + d_state + nheads: 8512 on the
    # flagship), and with one group B and C are shared by every head. A rank
    # takes its heads' z, x and dt columns and all of B and C (4384 columns
    # at TP 2, 2320 at TP 4). JAX's P(None, MODEL) is a contiguous split
    # that GSPMD repairs; it is not copied here. The conv and its cache take
    # the rank's x channels and all of B | C.
    in_spans = [(rank * dl, dl), (Di + rank * dl, dl), (2 * Di, N), (2 * Di + N, N),
                (2 * Di + 2 * N + rank * hl, hl)]
    local = dict(layers)
    # Trap: qmm_int4 at TP 4 on the hybrid. The local width (2320 on the
    # flagship) is not a multiple of 32, which qmm_int4 needs: an int4 in_proj
    # is padded with zero columns and zero scales to 2336, on every device,
    # and the mixer drops the pad from its output. qmm_int8 needs 16: none.
    local["in_proj"] = _split_cols(layers["in_proj"], in_spans, pad_to=INT4_COLS)
    local["conv1d"] = _split_cols(layers["conv1d"], [(rank * dl, dl), (Di, 2 * N)])
    for k in ("dt_bias", "A_log", "D"):
        local[k] = layers[k][..., rank * hl: (rank + 1) * hl].contiguous()
    local["ssm_norm"] = _split_cols(layers["ssm_norm"], [(rank * dl, dl)])
    local["out_proj"] = _split_rows(layers["out_proj"], rank, n)
    return _mlp_slices(local, layers, F, rank, n)


def tp_slices(params: dict, cfg: BackboneConfig, rank: int, n: int) -> dict:
    """Rank ``rank`` of ``n``'s tensor-parallel slices of a full tree
    (stacked ``[L, ...]`` layers; on the hybrid stacked by kind, ``"mamba"``
    and ``"attn"``), the rest whole."""
    bb = dict(params["backbone"])
    if cfg.is_hybrid:
        hq, hkv, dh, _ = attention_geometry(cfg)
        if "attn" in bb:
            bb["attn"] = _attn_slices(bb["attn"], (hq, hkv), dh, cfg.attn_mlp_d_intermediate,
                                      rank, n)
        if "mamba" in bb:
            bb["mamba"] = _mamba_slices(bb["mamba"], Mamba2Spec(cfg.d_model, cfg.ssm_cfg_dict),
                                        cfg.d_intermediate, rank, n)
    else:
        bb["layers"] = _attn_slices(bb["layers"], (cfg.num_heads, cfg.num_heads_kv),
                                    cfg.head_dim, cfg.attn_mlp_d_intermediate, rank, n)
    heads = params["heads"]
    # Heads shard on the vocab: 1152 columns divide by 2, 4 and 8.
    V = next(iter(heads.values())).shape[-1]
    if V % n:
        raise ValueError(f"{V} head columns do not split over a model axis of {n}")
    return {**params, "backbone": bb, "heads": _split_cols(heads, [(rank * V // n, V // n)])}


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
    params_from_jax``, float or quantized projections): its stage's layers on
    ``pipe``, its tensor-parallel slices on ``model``; whole over ``data``
    and ``expert``."""
    n_model, n_pipe = axis_size(mesh, MODEL), axis_size(mesh, PIPE)
    check_supported(cfg, n_model)
    out = params  # an axis of one rank keeps the tree's own tensors
    if n_pipe > 1:
        out = pp_slices(out, mesh.get_local_rank(PIPE), n_pipe)
    if n_model > 1:
        out = tp_slices(out, cfg, mesh.get_local_rank(MODEL), n_model)
    return out


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _join_cols(leaves: list[dict], widths: list[int], shared=()) -> dict:
    """Inverse of :func:`_split_cols`: each rank's pieces of the given widths,
    piece by piece (all ranks' first pieces, then all ranks' second ...);
    a piece in ``shared`` (held whole by every rank) from rank 0 alone, and
    an int4 slice's pad columns dropped."""
    out = {}
    for k in leaves[0]:
        half = 2 if k == "weight_int4" else 1
        w = [x // half for x in widths]
        pieces = [leaf[k].split([*w, leaf[k].shape[-1] - sum(w)], dim=-1) for leaf in leaves]
        out[k] = torch.cat([p[i] for i in range(len(w))
                            for p in (pieces[:1] if i in shared else pieces)], dim=-1)
    return out


def _join_rows(leaves: list[dict], int4_group: int | None) -> dict:
    """Inverse of :func:`_split_rows`. The full int4 scale's groups follow
    JAX's rule (``ops/quant._groups``) for ``int4_group``: each rank's own
    groups, or one group from the first rank of each run that shares it."""
    wkey = next(k for k in leaves[0] if k != "scale")
    out = {wkey: torch.cat([leaf[wkey] for leaf in leaves], dim=-2)}
    if "scale" not in leaves[0]:
        return out
    if not _is_int4(leaves[0]):
        return {**out, "scale": leaves[0]["scale"]}
    if int4_group is None:
        raise ValueError("joining int4 row slices needs the quantization's int4_group")
    n, K = len(leaves), out[wkey].shape[-2]
    gs = int4_group if K % int4_group == 0 and K > int4_group else K
    owners = leaves if (K // n) % gs == 0 else leaves[:: gs // (K // n)]
    return {**out, "scale": torch.cat([leaf["scale"] for leaf in owners], dim=-3)}


def _join_attn(shards: list[dict], heads: tuple[int, int], Dh: int, F: int,
               int4_group: int | None) -> dict:
    n = len(shards)
    hq, hkv = heads[0] // n, heads[1] // n
    full = dict(shards[0])
    full["in_proj"] = _join_cols([s["in_proj"] for s in shards], [hq * Dh, hkv * Dh, hkv * Dh])
    full["out_proj"] = _join_rows([s["out_proj"] for s in shards], int4_group)
    return _join_mlp(full, shards, F, int4_group)


def _join_mlp(full: dict, shards: list[dict], F: int, int4_group: int | None) -> dict:
    if "fc1" in full:
        f = F // len(shards)
        full["fc1"] = _join_cols([s["fc1"] for s in shards], [f, f])
        full["fc2"] = _join_rows([s["fc2"] for s in shards], int4_group)
    return full


def _join_mamba(shards: list[dict], s: Mamba2Spec, F: int, int4_group: int | None) -> dict:
    n = len(shards)
    dl, hl, N = s.d_inner // n, s.nheads // n, s.d_state
    full = dict(shards[0])
    # B | C: every rank holds them whole; the join takes rank 0's.
    full["in_proj"] = _join_cols([x["in_proj"] for x in shards], [dl, dl, N, N, hl],
                                 shared=(2, 3))
    full["conv1d"] = _join_cols([x["conv1d"] for x in shards], [dl, 2 * N], shared=(1,))
    for k in ("dt_bias", "A_log", "D"):
        full[k] = torch.cat([x[k] for x in shards], dim=-1)
    full["ssm_norm"] = _join_cols([x["ssm_norm"] for x in shards], [dl])
    full["out_proj"] = _join_rows([x["out_proj"] for x in shards], int4_group)
    return _join_mlp(full, shards, F, int4_group)


def join_tp_layers(shards: list[dict], cfg: BackboneConfig,
                   int4_group: int | None = None) -> dict:
    """The transformer's full layer tree from every model rank's
    :func:`tp_slices` layer tree, in rank order (stacked ``[L, ...]``
    leaves or one layer's); ``int4_group`` as the tree was quantized with,
    for int4 leaves."""
    return _join_attn(shards, (cfg.num_heads, cfg.num_heads_kv), cfg.head_dim,
                      cfg.attn_mlp_d_intermediate, int4_group)


def unshard_tp(shards: list[dict], cfg: BackboneConfig, int4_group: int | None = None) -> dict:
    """The full tree from every model rank's :func:`tp_slices`, in rank order
    (``int4_group`` as :func:`join_tp_layers`)."""
    bb = dict(shards[0]["backbone"])
    parts = [s["backbone"] for s in shards]
    if cfg.is_hybrid:
        hq, hkv, dh, _ = attention_geometry(cfg)
        if "attn" in bb:
            bb["attn"] = _join_attn([p["attn"] for p in parts], (hq, hkv), dh,
                                    cfg.attn_mlp_d_intermediate, int4_group)
        if "mamba" in bb:
            bb["mamba"] = _join_mamba([p["mamba"] for p in parts],
                                      Mamba2Spec(cfg.d_model, cfg.ssm_cfg_dict),
                                      cfg.d_intermediate, int4_group)
    else:
        bb["layers"] = join_tp_layers([p["layers"] for p in parts], cfg, int4_group)
    heads = _join_cols([s["heads"] for s in shards],
                       [next(iter(shards[0]["heads"].values())).shape[-1]])
    return {**shards[0], "backbone": bb, "heads": heads}


def allocate_local_cache(cfg: BackboneConfig, batch: int, max_seqlen: int, dtype, device,
                         *, model: int = 1, layers: int | None = None) -> dict:
    """A rank's KV cache: ``[L, batch, T, (Hkv / model) * Dh]`` (and its
    stage) for ``batch`` rows (this data rank's), ``layers`` layers
    (default: all). A bf16 or fp32 cache: JAX's parallel engines never pass
    ``kv_int8`` (``parallel/engine.py``)."""
    return allocate_kv_cache(cfg, batch, max_seqlen, dtype, device,
                             layers=cfg.n_layer if layers is None else layers,
                             kv_heads=cfg.num_heads_kv // model)
