"""Carrying parameters from the JAX package into the port.

* :func:`params_from_jax` takes a JAX parameter tree after
  ``jax.device_get`` (nested dicts and lists of numpy arrays) and returns
  the port's tree of tensors. The Zonos model keeps the JAX tree and
  layouts unchanged (linear weights ``[in, out]``, stacked layers), except
  the hybrid backbone's list of per-layer dicts (Mamba-2 and attention
  layers interleaved): its layers are stacked by kind into
  ``{"mamba": {leaf: [M, ...]}, "attn": {leaf: [L_attn, ...]}}`` in layer
  order, the layout of ``models/mamba_backbone.py``. The DAC
  tree (recognised by its ``decoder`` and ``quantizers`` keys) changes
  layout: conv kernels ``[k, Cin, Cout]`` become PyTorch's
  ``[Cout, Cin, k]``; transposed-conv kernels, stored by JAX pre-flipped as
  ``[k, Cin, Cout]``, become ``conv_transpose1d``'s unflipped
  ``[Cin, Cout, k]``.
* :func:`speaker_params_from_jax` does the same for the speaker encoder:
  HWIO kernels ``[kh, kw, Cin, Cout]`` (``[n, kh, kw, Cin, Cout]`` in a
  stage's stacked tail) become ``[Cout, Cin, kh, kw]`` (``[n, Cout, Cin,
  kh, kw]``); the rest keeps its ``[in, out]`` layout.
* :func:`load_zonos_checkpoint` (with :func:`load_zonos_config` and
  :func:`convert_zonos_state_dict`) and :func:`convert_dac_state_dict`
  build the port's trees straight from the reference's state dicts, with
  the JAX package's converters' arithmetic (numpy fp32, then one cast), so
  that they equal ``params_from_jax`` of that package's converted trees.
* :func:`load_params_cache` reads the flat ``.npz`` that the JAX package's
  ``utils/checkpoint.save_params_cache`` writes: keys joined with ``::``,
  bf16 entries stored as a uint16 view under an ``@bf16`` suffix, int4
  weights widened to int8 under an ``@s4`` suffix, empty nodes marked
  ``@emptydict`` / ``@emptylist``. :func:`save_params_cache` writes the
  port's tree in the same format, int4 leaves in JAX's shapes, so JAX's
  loader reads it back (the hybrid's backbone as the port's stacked-by-kind
  tree).

Both carry the JAX package's int8 leaves (``ops/quant``) as they are:
``weight_int8`` int8, ``scale`` fp32, and the 0-d ``act_dtype`` marker of
an int8 embedding table in its bf16 (or fp32) dtype. JAX's int4 leaves
(``weight_int4`` as ``[..., G, K / G, N]`` with scale ``[..., G, 1, N]``
when grouped, ``[..., K, N]`` with ``[..., 1, N]`` when not; ml_dtypes
``int4`` or int8 values) become the port's packed leaves (``ops/quant``);
which of JAX's two shapes a leaf has is read from its place in the tree
(stacked transformer layers, or one hybrid layer).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import ZonosConfig
from ..ops.cuda.qmm import pack_int4, unpack_int4

_SEP = "::"


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as jax.device_get returns it
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype.name == "int4":  # ml_dtypes' int4 (a JAX s4 array)
        arr = arr.astype(np.int8)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _int4_from_jax(tree, lead: int):
    """JAX's int4 leaves under ``tree`` (``lead`` stacked axes) -> the port's."""
    if isinstance(tree, (list, tuple)):
        return [_int4_from_jax(v, lead) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if "weight_int4" not in tree:
        return {k: _int4_from_jax(v, lead) for k, v in tree.items()}
    q, scale = tree["weight_int4"].to(torch.int8), tree["scale"].float()
    if q.ndim == lead + 2:  # ungrouped [..., K, N], scale [..., 1, N]
        scale = scale.unsqueeze(-3)
    else:  # grouped [..., G, K / G, N]
        q = q.flatten(-3, -2)
    return {**tree, "weight_int4": pack_int4(q), "scale": scale}


def _int4_to_jax(tree):
    """The port's int4 leaves -> JAX's shapes, int8 values (for ``@s4``)."""
    if isinstance(tree, (list, tuple)):
        return [_int4_to_jax(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if "weight_int4" not in tree:
        return {k: _int4_to_jax(v) for k, v in tree.items()}
    q, scale = unpack_int4(tree["weight_int4"]), tree["scale"]
    G = scale.shape[-3]
    if G == 1:
        return {**tree, "weight_int4": q, "scale": scale.squeeze(-3)}
    return {**tree, "weight_int4": q.unflatten(-2, (G, -1)), "scale": scale}


def _backbone_int4_from_jax(backbone: dict) -> dict:
    """A backbone's int4 leaves: the transformer's stacked layers, the JAX
    hybrid's per-layer list or the port's stacked-by-kind hybrid."""
    out = dict(backbone)
    layers = backbone.get("layers")
    if isinstance(layers, list):
        out["layers"] = [_int4_from_jax(lp, 0) for lp in layers]
    elif isinstance(layers, dict):
        out["layers"] = _int4_from_jax(layers, 1)
    for kind in ("mamba", "attn"):
        if kind in backbone:
            out[kind] = _int4_from_jax(backbone[kind], 1)
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _dac_from_jax(tree: dict) -> dict:
    def conv(p):
        return {"weight": p["weight"].permute(2, 1, 0).contiguous(), "bias": p["bias"]}

    def conv_t(p):
        return {"weight": p["weight"].flip(0).permute(1, 2, 0).contiguous(),
                "bias": p["bias"]}

    def res_unit(p):
        return {"snake1": p["snake1"], "conv1": conv(p["conv1"]),
                "snake2": p["snake2"], "conv2": conv(p["conv2"])}

    enc, dec = tree["encoder"], tree["decoder"]
    return {
        "encoder": {
            "conv1": conv(enc["conv1"]),
            "blocks": [{"res1": res_unit(b["res1"]), "res2": res_unit(b["res2"]),
                        "res3": res_unit(b["res3"]), "snake": b["snake"],
                        "conv": conv(b["conv"])} for b in enc["blocks"]],
            "snake": enc["snake"],
            "conv2": conv(enc["conv2"]),
        },
        "quantizers": [{"in_proj": conv(q["in_proj"]), "out_proj": conv(q["out_proj"]),
                        "codebook": q["codebook"]} for q in tree["quantizers"]],
        "decoder": {
            "conv1": conv(dec["conv1"]),
            "blocks": [{"snake": b["snake"], "conv_t": conv_t(b["conv_t"]),
                        "res1": res_unit(b["res1"]), "res2": res_unit(b["res2"]),
                        "res3": res_unit(b["res3"])} for b in dec["blocks"]],
            "snake": dec["snake"],
            "conv2": conv(dec["conv2"]),
        },
    }


def stack_trees(trees: list[dict]) -> dict:
    """Same-structured trees -> one tree with each leaf stacked on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _hybrid_from_jax(backbone: dict) -> dict:
    """The hybrid's ``{"layers": [per-layer dict, ...], "norm_f"}`` -> layers
    stacked by kind (a Mamba-2 layer is the one with ``A_log``)."""
    layers = backbone["layers"]
    out = {k: v for k, v in backbone.items() if k != "layers"}
    for kind, pick in (("mamba", True), ("attn", False)):
        group = [lp for lp in layers if ("A_log" in lp) == pick]
        if group:
            out[kind] = stack_trees(group)
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """JAX parameter tree (numpy leaves) -> the port's tree on ``device``."""
    tree = _map(tree, _to_tensor)
    if isinstance(tree, dict) and "decoder" in tree and "quantizers" in tree:
        tree = _dac_from_jax(tree)
    if isinstance(tree, dict) and isinstance(tree.get("backbone"), dict):
        tree = {**tree, "backbone": _backbone_int4_from_jax(tree["backbone"])}
    elif isinstance(tree, dict) and ("layers" in tree or "mamba" in tree or "attn" in tree):
        tree = _backbone_int4_from_jax(tree)
    if isinstance(tree, dict) and isinstance(tree.get("layers"), list):
        tree = _hybrid_from_jax(tree)
    elif isinstance(tree, dict) and isinstance(tree.get("backbone", {}).get("layers"), list):
        tree = {**tree, "backbone": _hybrid_from_jax(tree["backbone"])}
    return _map(tree, lambda t: t.to(device))


def speaker_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX speaker encoder's tree (numpy leaves) -> the port's tree on
    ``device``."""
    tree = _map(tree, _to_tensor)

    def conv(p):  # [..., kh, kw, Cin, Cout] -> [..., Cout, Cin, kh, kw]
        w = p["weight"]
        lead = tuple(range(w.ndim - 4))
        n = len(lead)
        return {"weight": w.permute(*lead, n + 3, n + 2, n, n + 1).contiguous(),
                "bias": p["bias"]}

    def stage(p):
        return {part: {name: conv(c) for name, c in blk.items()} for part, blk in p.items()}

    out = dict(tree)
    out["conv1"] = conv(tree["conv1"])
    for name in ("layer1", "layer2", "layer3", "layer4"):
        out[name] = stage(tree[name])
    return _map(out, lambda t: t.to(device))


def _unflatten(flat: dict) -> dict:
    nested: dict = {}
    for key, value in flat.items():
        if key.endswith("@emptydict"):
            key, value = key[: -len("@emptydict")], {}
        elif key.endswith("@emptylist"):
            key, value = key[: -len("@emptylist")], []
        parts = key.split(_SEP)
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(nested)


def load_params_cache(path: str, device="cpu") -> dict:
    """Read a JAX ``save_params_cache`` file (or the port's) into the port's
    tree."""
    flat = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            if k.endswith("@bf16"):
                flat[k[: -len("@bf16")]] = torch.from_numpy(v.copy()).view(torch.bfloat16)
            elif k.endswith("@s4"):
                flat[k[: -len("@s4")]] = torch.from_numpy(v.astype(np.int8))
            else:
                flat[k] = torch.from_numpy(v.copy())
    return params_from_jax(_unflatten(flat), device)


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        if not tree:
            return {prefix + "@emptydict": np.zeros((), np.int8)}
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        if not tree:
            return {prefix + "@emptylist": np.zeros((), np.int8)}
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def save_params_cache(path: str, params: dict) -> None:
    """Write the port's tree as the JAX package's ``save_params_cache``
    does: keys joined with ``::``, bf16 as a uint16 view under ``@bf16``,
    int4 weights unpacked to int8 in JAX's shapes under ``@s4``, empty
    nodes as ``@emptydict`` / ``@emptylist``."""
    out = {}
    for k, v in _flatten(_int4_to_jax(params)).items():
        if k.endswith(_SEP + "weight_int4"):
            out[k + "@s4"] = v.cpu().numpy()
        elif isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            out[k + "@bf16"] = v.cpu().view(torch.uint16).numpy()
        else:
            out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# Reference checkpoints
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    """A state-dict value -> numpy (bf16 widened to fp32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _cast(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def load_zonos_config(config_path: str) -> ZonosConfig:
    with open(config_path) as f:
        return ZonosConfig.from_dict(json.load(f))


def convert_zonos_state_dict(sd: dict, config: ZonosConfig, dtype=torch.bfloat16) -> dict:
    """The reference transformer's state dict (tensors or arrays) -> the
    port's parameter tree (on the CPU): the 9 embeddings and heads stacked,
    the heads transposed to ``[D, 1025]`` and zero-padded to the head width,
    linear weights ``[in, out]`` and each layer's tensors stacked on a
    leading ``[n_layer]`` axis, the layer norms fp32, the rest ``dtype``.

    Reference names: ``embeddings.{k}.weight`` ``[1026, D]``,
    ``heads.{k}.weight`` ``[1025, D]``, ``backbone.layers.{i}.norm{,2}.*``,
    ``backbone.layers.{i}.mixer.{in,out}_proj.weight``,
    ``backbone.layers.{i}.mlp.fc{1,2}.weight``, ``backbone.norm_f.*``,
    ``prefix_conditioner.conditioners.{j}.*`` (in config order) and
    ``prefix_conditioner.{norm,project}.*``."""
    if config.backbone.is_hybrid:
        raise NotImplementedError("the reference converter covers the transformer only, as in "
                                  "the JAX package")
    L, K = config.backbone.n_layer, config.num_codebooks

    def cast(x):
        return _cast(x, dtype)

    def cast32(x):
        return _cast(x, torch.float32)

    def linear(key):
        return cast(_np(sd[key]).T)

    m, hv = config.head_pad_to_multiple, config.head_vocab_size
    head_pad = 0 if hv % m == 0 else m - hv % m
    emb = np.stack([_np(sd[f"embeddings.{k}.weight"]) for k in range(K)])
    heads = np.stack([np.pad(_np(sd[f"heads.{k}.weight"]).T, ((0, 0), (0, head_pad)))
                      for k in range(K)])

    def stack(fmt, transpose=False):
        return np.stack([_np(sd[fmt.format(i=i)]).T if transpose else _np(sd[fmt.format(i=i)])
                         for i in range(L)])

    lp = "backbone.layers.{i}"
    backbone = {
        "layers": {
            "norm1": {"weight": cast32(stack(f"{lp}.norm.weight")),
                      "bias": cast32(stack(f"{lp}.norm.bias"))},
            "in_proj": {"weight": cast(stack(f"{lp}.mixer.in_proj.weight", True))},
            "out_proj": {"weight": cast(stack(f"{lp}.mixer.out_proj.weight", True))},
            "norm2": {"weight": cast32(stack(f"{lp}.norm2.weight")),
                      "bias": cast32(stack(f"{lp}.norm2.bias"))},
            "fc1": {"weight": cast(stack(f"{lp}.mlp.fc1.weight", True))},
            "fc2": {"weight": cast(stack(f"{lp}.mlp.fc2.weight", True))},
        },
        "norm_f": {"weight": cast(_np(sd["backbone.norm_f.weight"])),
                   "bias": cast(_np(sd["backbone.norm_f.bias"]))},
    }

    def projection(base):
        if f"{base}.project.weight" in sd:
            return {"linear": {"weight": linear(f"{base}.project.weight"),
                               "bias": cast(_np(sd[f"{base}.project.bias"]))}}
        if f"{base}.project.0.weight" in sd:
            return {f"mlp{j}": {"weight": linear(f"{base}.project.{j}.weight"),
                                "bias": cast(_np(sd[f"{base}.project.{j}.bias"]))}
                    for j in (0, 2)}
        return {}

    conds = {}
    for j, cdict in enumerate(config.prefix_conditioner.conditioners_list):
        base = f"prefix_conditioner.conditioners.{j}"
        p: dict = {"project": projection(base)}
        if f"{base}.uncond_vector" in sd:
            p["uncond_vector"] = cast(_np(sd[f"{base}.uncond_vector"]))
        for table in ("phoneme_embedder", "int_embedder"):
            if f"{base}.{table}.weight" in sd:
                p[table] = {"weight": cast(_np(sd[f"{base}.{table}.weight"]))}
        if f"{base}.weight" in sd:  # the Fourier buffer (fp32, never trained)
            p["weight"] = cast32(_np(sd[f"{base}.weight"]))
        conds[cdict.get("name", cdict["type"])] = p

    return {
        "embeddings": {"weight": cast(emb)},
        "heads": {"weight": cast(heads)},
        "backbone": backbone,
        "prefix_conditioner": {
            "conditioners": conds,
            "project": projection("prefix_conditioner"),
            "norm": {"weight": cast(_np(sd["prefix_conditioner.norm.weight"])),
                     "bias": cast(_np(sd["prefix_conditioner.norm.bias"]))},
        },
    }


def load_zonos_checkpoint(config_path: str, model_path: str, dtype=torch.bfloat16):
    """A reference ``config.json`` and ``model.safetensors`` -> (config,
    parameter tree on the CPU)."""
    import safetensors.torch

    config = load_zonos_config(config_path)
    sd = safetensors.torch.load_file(model_path)
    return config, convert_zonos_state_dict(sd, config, dtype)


def _conv_w(sd: dict, key: str) -> np.ndarray:
    """A conv's ``[Cout, Cin, k]`` (or a transposed conv's ``[Cin, Cout,
    k]``) weight, weight norm fused: ``weight``, or the ``g`` and ``v`` of
    ``parametrizations.weight.original0/1``."""
    if key + ".weight" in sd:
        return _np(sd[key + ".weight"])
    g = _np(sd[key + ".parametrizations.weight.original0"])
    v = _np(sd[key + ".parametrizations.weight.original1"])
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def convert_dac_state_dict(sd: dict, config) -> dict:
    """HF ``transformers`` ``DacModel`` state dict -> the port's fp32 DAC tree
    (on the CPU), in PyTorch's conv layouts: ``encoder.conv1/2``,
    ``encoder.block.{i}.{res_unit1..3, snake1, conv1}``, ``encoder.snake1``,
    ``decoder.conv1/2``, ``decoder.block.{i}.{snake1, conv_t1,
    res_unit1..3}``, ``decoder.snake1``,
    ``quantizer.quantizers.{i}.{in_proj, out_proj, codebook}``."""

    f32 = torch.float32

    def snake_a(key):
        return _cast(_np(sd[key]).reshape(-1), f32)

    def conv(key):
        return {"weight": _cast(_conv_w(sd, key), f32), "bias": _cast(_np(sd[key + ".bias"]), f32)}

    def res_unit(base):
        return {"snake1": snake_a(f"{base}.snake1.alpha"), "conv1": conv(f"{base}.conv1"),
                "snake2": snake_a(f"{base}.snake2.alpha"), "conv2": conv(f"{base}.conv2")}

    def res_units(base):
        return {f"res{u}": res_unit(f"{base}.res_unit{u}") for u in (1, 2, 3)}

    n = len(config.downsampling_ratios)
    return {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "blocks": [{**res_units(f"encoder.block.{i}"),
                        "snake": snake_a(f"encoder.block.{i}.snake1.alpha"),
                        "conv": conv(f"encoder.block.{i}.conv1")} for i in range(n)],
            "snake": snake_a("encoder.snake1.alpha"),
            "conv2": conv("encoder.conv2"),
        },
        "quantizers": [{"in_proj": conv(f"quantizer.quantizers.{i}.in_proj"),
                        "out_proj": conv(f"quantizer.quantizers.{i}.out_proj"),
                        "codebook": _cast(_np(sd[f"quantizer.quantizers.{i}.codebook.weight"]),
                                          f32)}
                       for i in range(config.n_codebooks)],
        "decoder": {
            "conv1": conv("decoder.conv1"),
            "blocks": [{"snake": snake_a(f"decoder.block.{i}.snake1.alpha"),
                        "conv_t": conv(f"decoder.block.{i}.conv_t1"),
                        **res_units(f"decoder.block.{i}")} for i in range(n)],
            "snake": snake_a("decoder.snake1.alpha"),
            "conv2": conv("decoder.conv2"),
        },
    }
