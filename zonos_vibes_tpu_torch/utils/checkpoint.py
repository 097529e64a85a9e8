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
  ``[Cin, Cout, k]``. The encoder and the quantizers' input projections
  are dropped: the port decodes only.
* :func:`load_params_cache` reads the flat ``.npz`` that the JAX package's
  ``utils/checkpoint.save_params_cache`` writes: keys joined with ``::``,
  bf16 entries stored as a uint16 view under an ``@bf16`` suffix, empty
  nodes marked ``@emptydict`` / ``@emptylist``. An ``@s4`` (int4) entry
  raises ``NotImplementedError`` until the int4 slice is ported.

Both carry the JAX package's int8 leaves (``ops/quant``) as they are:
``weight_int8`` int8, ``scale`` fp32, and the 0-d ``act_dtype`` marker of
an int8 embedding table in its bf16 (or fp32) dtype.
"""

from __future__ import annotations

import numpy as np
import torch

_SEP = "::"


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as jax.device_get returns it
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


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

    dec = tree["decoder"]
    return {
        "quantizers": [{"out_proj": conv(q["out_proj"]), "codebook": q["codebook"]}
                       for q in tree["quantizers"]],
        "decoder": {
            "conv1": conv(dec["conv1"]),
            "blocks": [{"snake": b["snake"], "conv_t": conv_t(b["conv_t"]),
                        "res1": res_unit(b["res1"]), "res2": res_unit(b["res2"]),
                        "res3": res_unit(b["res3"])} for b in dec["blocks"]],
            "snake": dec["snake"],
            "conv2": conv(dec["conv2"]),
        },
    }


def _stack(trees: list[dict]) -> dict:
    """Same-structured trees -> one tree with each leaf stacked on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _hybrid_from_jax(backbone: dict) -> dict:
    """The hybrid's ``{"layers": [per-layer dict, ...], "norm_f"}`` -> layers
    stacked by kind (a Mamba-2 layer is the one with ``A_log``)."""
    layers = backbone["layers"]
    out = {k: v for k, v in backbone.items() if k != "layers"}
    for kind, pick in (("mamba", True), ("attn", False)):
        group = [lp for lp in layers if ("A_log" in lp) == pick]
        if group:
            out[kind] = _stack(group)
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """JAX parameter tree (numpy leaves) -> the port's tree on ``device``."""
    tree = _map(tree, _to_tensor)
    if isinstance(tree, dict) and "decoder" in tree and "quantizers" in tree:
        tree = _dac_from_jax(tree)
    if isinstance(tree, dict) and isinstance(tree.get("layers"), list):
        tree = _hybrid_from_jax(tree)
    elif isinstance(tree, dict) and isinstance(tree.get("backbone", {}).get("layers"), list):
        tree = {**tree, "backbone": _hybrid_from_jax(tree["backbone"])}
    return _map(tree, lambda t: t.to(device))


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
    """Read a JAX ``save_params_cache`` file into the port's tree."""
    flat = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            if k.endswith("@s4"):
                raise NotImplementedError(f"{k}: int4 weights are not ported yet")
            if k.endswith("@bf16"):
                flat[k[: -len("@bf16")]] = torch.from_numpy(v.copy()).view(torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(v.copy())
    return params_from_jax(_unflatten(flat), device)
