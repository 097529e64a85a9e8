"""Weight-only int8 quantization and the int8 KV cache: the port's own copy of
the 8-bit parts of the JAX package's ``ops/quant.py``.

Scheme: symmetric per-output-channel absmax. In fp32, ``s = absmax(col) /
127`` (1 for an all-zero column) and ``q = clip(round(w / s), -127, 127)``,
rounding half to even, so the int8 values and fp32 scales equal the JAX
package's bit for bit. A quantized leaf is ``{"weight_int8": [..., in, out]
int8, "scale": [..., 1, out] fp32}`` at the tree position of the ``weight``
it replaces; leading axes (layers, codebooks) are kept.

The JAX package quantizes on the host in numpy. The port quantizes one
slice of the leading axes at a time on the parameters' device, so the
flagship never holds an fp32 copy of more than one layer's weight.

Not ported yet (``NotImplementedError``): int4, grouped scales, the clip
search, GPTQ, the AWQ fold and mixed widths (``mlp_bits``, ``fc2_bits``).
"""

from __future__ import annotations

import itertools

import torch

from .cuda.qmm import qmm_int8

QMAX = 127.0
_QUANT_KEYS = ("in_proj", "out_proj", "fc1", "fc2")


def _absmax_quantize(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` -> int8 values and fp32 scales (``dim`` kept, size 1)."""
    absmax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(absmax > 0, absmax / QMAX, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8), scale


def quantize_weight(w: torch.Tensor, bits: int = 8) -> dict:
    """``[..., in, out]`` float -> ``{"weight_int8", "scale"}``, one slice of
    the leading axes at a time."""
    if bits != 8:
        raise NotImplementedError("only 8-bit weights are ported; int4 is queued")
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32, device=w.device)
    for idx in itertools.product(*map(range, w.shape[:-2])):
        q[idx], scale[idx] = _absmax_quantize(w[idx].float(), dim=-2)
    return {"weight_int8": q, "scale": scale}


def dequantize_weight(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight a quantized leaf stands for, in ``dtype``."""
    return (p["weight_int8"].float() * p["scale"]).to(dtype)


def proj_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ W`` for a float leaf ``{"weight"}`` or an int8 leaf
    ``{"weight_int8", "scale"}``. The int8 product runs ``qmm_int8``: fp32
    accumulation, the scale on the fp32 result, one rounding to ``x.dtype``."""
    if "weight_int4" in p:
        raise NotImplementedError("int4 weights are not ported yet")
    wq = p.get("weight_int8")
    if wq is None:
        return torch.matmul(x, p["weight"])
    if wq.ndim != 2:
        raise NotImplementedError("grouped scales are not ported yet")
    y = qmm_int8(x.reshape(-1, x.shape[-1]).contiguous(), wq[None], p["scale"][None], x.dtype)
    return y.reshape(*x.shape[:-1], wq.shape[-1])


def quantize_backbone_params(backbone_params: dict, bits: int = 8,
                             mlp_bits: int | None = None, fc2_bits: int | None = None,
                             gptq: bool = False, awq_energy=None) -> dict:
    """The transformer's four projections per layer to int8 (a new tree;
    norms untouched). Only the all-int8 configuration is ported."""
    if bits != 8 or mlp_bits not in (None, 8) or fc2_bits not in (None, 8):
        raise NotImplementedError("only the all-int8 configuration is ported; int4 and "
                                  "mixed widths are queued")
    if gptq or awq_energy is not None:
        raise NotImplementedError("GPTQ and the AWQ fold are not ported yet")
    if "layers" not in backbone_params:
        raise NotImplementedError("int8 weights on the hybrid backbone are not ported yet")
    layers = backbone_params["layers"]
    out_layers = dict(layers)
    for k in _QUANT_KEYS:
        if k in layers and "weight" in layers[k]:
            out_layers[k] = quantize_weight(layers[k]["weight"])
    return {**backbone_params, "layers": out_layers}


def quantize_zonos_params(params: dict, heads: bool = True, embeddings: bool = False,
                          bits: int = 8, mlp_bits: int | None = None,
                          fc2_bits: int | None = None, gptq: bool = False,
                          awq_energy=None) -> dict:
    """Backbone projections to int8, and the 9 heads (``heads``, scales on the
    fp32 logits) and the code embeddings (``embeddings``, scale ``[K, 1, D]``
    with a 0-d ``act_dtype`` marker of the table's dtype) if asked; the
    conditioners stay as they are."""
    out = dict(params)
    out["backbone"] = quantize_backbone_params(params["backbone"], bits=bits, mlp_bits=mlp_bits,
                                               fc2_bits=fc2_bits, gptq=gptq,
                                               awq_energy=awq_energy)
    if heads and "weight" in params["heads"]:
        out["heads"] = quantize_weight(params["heads"]["weight"])
    if embeddings and "weight" in params["embeddings"]:
        w = params["embeddings"]["weight"]  # [K, V, D]
        q = quantize_weight(w)
        q["act_dtype"] = torch.zeros((), dtype=w.dtype, device=w.device)
        out["embeddings"] = q
    return out


def quantize_kv(x: torch.Tensor, dh_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(position, head) int8 for KV columns: absmax over the
    head-dim axis. Returns int8 values and fp32 scales with ``dh_axis``
    squeezed."""
    q, scale = _absmax_quantize(x.float(), dim=dh_axis)
    return q, scale.squeeze(dh_axis)


def quantize_rows(x: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The port's time-major KV rows ``[..., Hkv*Dh]`` -> int8 rows and fp32
    scales ``[..., Hkv]``, one per (position, head)."""
    q, scale = quantize_kv(x.unflatten(-1, (n_heads, -1)), dh_axis=-1)
    return q.flatten(-2), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 KV rows ``[..., Hkv*Dh]`` with their scales ``[..., Hkv]`` -> fp32."""
    return (q.float().unflatten(-1, (scale.shape[-1], -1)) * scale[..., None]).flatten(-2)
