"""Gated-SiLU ("SwiGLU") feed-forward, as in the JAX package's ``ops/mlp.py``:
``fc1: d_model -> 2*d_ff`` without bias, split into ``(y, gate)``, then
``y * silu(gate)`` feeds ``fc2``. Weights are stored ``[in, out]``, as float
``{"weight"}`` or int8 ``{"weight_int8", "scale"}`` leaves (``ops/quant``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import proj_matmul


def swiglu_mid(x: torch.Tensor, fc1: dict) -> torch.Tensor:
    """fc1 and the gate: the fc2 input ``y * silu(gate)``."""
    y, gate = proj_matmul(x, fc1).chunk(2, dim=-1)
    return y * F.silu(gate)
