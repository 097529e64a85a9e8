"""LayerNorm and RMSNorm computed in fp32 (the transformer backbone's
pre-norm and the hybrid backbone's, as in the JAX package's
``ops/norms.py``)."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(ms + eps))
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)
