"""Rotary position embeddings, interleaved-pair convention.

Same math as the JAX package's ``ops/rope.py``: the head dim is viewed as
``D/2`` pairs laid out interleaved (``x[..., 2i]`` real, ``x[..., 2i+1]``
imaginary), rotated by angles from ``theta = 10000`` over a table of 16,384
positions. Per output element the rotation is the same two fp32 products and
one add as in JAX.
"""

from __future__ import annotations

import torch

DEFAULT_ROPE_BASE = 10000.0
DEFAULT_MAX_POSITIONS = 16384


def rope_table(head_dim: int, max_positions: int = DEFAULT_MAX_POSITIONS,
               base: float = DEFAULT_ROPE_BASE, device=None) -> torch.Tensor:
    """``[P, 2, D]`` fp32 table: row 0 holds each pair's cos duplicated over
    the pair, row 1 holds ``(-sin, +sin)`` per pair (the rotation signs
    folded in), the JAX package's expanded form."""
    freqs = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))
    t = torch.arange(max_positions, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)  # [P, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    cos_dup = cos.repeat_interleave(2, dim=-1)
    sin_signed = torch.stack([-sin, sin], dim=-1).reshape(max_positions, -1)
    return torch.stack([cos_dup, sin_signed], dim=1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, S, H, D]`` by the angles of ``positions [B, S]``;
    computed in fp32, returned in ``x.dtype``."""
    cs = table[positions]  # [B, S, 2, D]
    cos = cs[:, :, None, 0, :]
    sin = cs[:, :, None, 1, :]
    xf = x.float()
    swapped = xf.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return (xf * cos + swapped * sin).to(x.dtype)
