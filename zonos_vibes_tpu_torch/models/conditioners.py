"""Conditioner stack and ``PrefixConditioner`` (the JAX package's
``models/conditioners.py``).

Text work (normalization, phonemes, tokens) runs on the host in
``frontend/``; these functions take numeric tensors only. Each conditioner
has an optional projection (``none | linear | mlp``) and an optional learned
unconditional vector returned as ``[1, 1, D]`` when its input is absent.
``PrefixConditioner`` runs every conditioner, broadcasts the batch,
concatenates along the sequence and applies ``LayerNorm(project(cat))``.
Weights are stored ``[in, out]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import PrefixConditionerConfig
from ..frontend.text import VOCAB_SIZE as PHONEME_VOCAB_SIZE
from ..ops.norms import layer_norm


def _init_linear(gen, d_in, d_out, dtype, device):
    lim = 1.0 / math.sqrt(d_in)

    def uniform(shape):
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return ((u * 2 - 1) * lim).to(dtype)

    return {"weight": uniform((d_in, d_out)), "bias": uniform((d_out,))}


def _apply_linear(p, x):
    # Mixed inputs promote as in JAX (fp32 Fourier features x bf16 weights
    # compute in fp32).
    dt = torch.promote_types(x.dtype, p["weight"].dtype)
    return torch.matmul(x.to(dt), p["weight"].to(dt)) + p["bias"].to(dt)


def _init_projection(gen, projection, cond_dim, output_dim, dtype, device):
    if projection == "linear":
        return {"linear": _init_linear(gen, cond_dim, output_dim, dtype, device)}
    if projection == "mlp":
        return {"mlp0": _init_linear(gen, cond_dim, output_dim, dtype, device),
                "mlp2": _init_linear(gen, output_dim, output_dim, dtype, device)}
    return {}


def _apply_projection(p, x):
    if "linear" in p:
        return _apply_linear(p["linear"], x)
    if "mlp0" in p:
        return _apply_linear(p["mlp2"], F.silu(_apply_linear(p["mlp0"], x)))
    return x


class ConditionerSpec:
    """One conditioner's static description, parsed from the config dict."""

    def __init__(self, cfg: dict, output_dim: int):
        self.type = cfg["type"]
        self.name = cfg.get("name", self.type)
        self.output_dim = output_dim
        self.cond_dim = cfg.get("cond_dim") or output_dim
        self.projection = cfg.get("projection", "none")
        self.uncond_type = cfg.get("uncond_type", "none")
        self.input_dim = cfg.get("input_dim", 1)
        self.std = cfg.get("std", 1.0)
        self.min_val = cfg.get("min_val", 0.0)
        self.max_val = cfg.get("max_val", 1.0)

    @property
    def has_uncond(self) -> bool:
        return self.uncond_type == "learned"


def init_conditioner(gen, spec: ConditionerSpec, dtype, device) -> dict:
    params = {"project": _init_projection(gen, spec.projection, spec.cond_dim,
                                          spec.output_dim, dtype, device)}
    if spec.has_uncond:
        params["uncond_vector"] = torch.zeros((spec.output_dim,), dtype=dtype, device=device)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    if spec.type == "EspeakPhonemeConditioner":
        params["phoneme_embedder"] = {
            "weight": normal((PHONEME_VOCAB_SIZE, spec.output_dim)).to(dtype)}
    elif spec.type == "FourierConditioner":
        # Fixed random projection [D/2, input_dim] ~ N(0, std^2), kept fp32.
        params["weight"] = normal((spec.output_dim // 2, spec.input_dim)) * spec.std
    elif spec.type == "IntegerConditioner":
        n = int(spec.max_val) - int(spec.min_val) + 1
        params["int_embedder"] = {"weight": normal((n, spec.output_dim)).to(dtype)}
    elif spec.type != "PassthroughConditioner":
        raise ValueError(f"Unknown conditioner type {spec.type}")
    return params


def apply_conditioner(params: dict, spec: ConditionerSpec, value) -> torch.Tensor:
    """``value=None`` gives the learned uncond vector ``[1, 1, D]``; else
    ``project(cond(value))``. Numeric values are ``[B, S, dim]``; phoneme
    ids are int ``[B, L]``."""
    if value is None:
        if "uncond_vector" not in params:
            raise ValueError(f"Conditioner {spec.name} has no uncond vector")
        return params["uncond_vector"].reshape(1, 1, -1)
    if spec.type == "EspeakPhonemeConditioner":
        cond = params["phoneme_embedder"]["weight"][value.long()]
    elif spec.type == "FourierConditioner":
        x = (value.float() - spec.min_val) / (spec.max_val - spec.min_val)
        f = 2.0 * math.pi * torch.matmul(x, params["weight"].T)
        cond = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
    elif spec.type == "IntegerConditioner":
        idx = value[..., 0].long() - int(spec.min_val)
        cond = params["int_embedder"]["weight"][idx]
    elif spec.type == "PassthroughConditioner":
        cond = value
    else:
        raise ValueError(spec.type)
    return _apply_projection(params["project"], cond)


class PrefixConditioner:
    """The whole conditioner stack."""

    def __init__(self, config: PrefixConditionerConfig, output_dim: int):
        self.config = config
        self.output_dim = output_dim
        self.specs = [ConditionerSpec(c, output_dim) for c in config.conditioners_list]
        self.required_keys = {s.name for s in self.specs if not s.has_uncond}

    def init(self, gen, dtype, device) -> dict:
        return {
            "conditioners": {s.name: init_conditioner(gen, s, dtype, device)
                             for s in self.specs},
            "project": _init_projection(gen, self.config.projection, self.output_dim,
                                        self.output_dim, dtype, device),
            "norm": {"weight": torch.ones((self.output_dim,), dtype=dtype, device=device),
                     "bias": torch.zeros((self.output_dim,), dtype=dtype, device=device)},
        }

    def apply(self, params: dict, cond_dict: dict) -> torch.Tensor:
        missing = self.required_keys - set(cond_dict)
        if missing:
            raise ValueError(f"Missing required keys: {missing}")
        conds = [apply_conditioner(params["conditioners"][s.name], s, cond_dict.get(s.name))
                 for s in self.specs]
        max_b = max(c.shape[0] for c in conds)
        if any(c.shape[0] not in (max_b, 1) for c in conds):
            raise ValueError("conditioner batch sizes must match or be 1")
        dtype = params["norm"]["weight"].dtype
        conds = [c.expand((max_b,) + tuple(c.shape[1:])).to(dtype) for c in conds]
        out = _apply_projection(params["project"], torch.cat(conds, dim=-2))
        return layer_norm(out, params["norm"]["weight"], params["norm"]["bias"])
