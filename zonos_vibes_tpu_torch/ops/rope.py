"""Rotary position embeddings.

The transformer's interleaved-pair convention, the same math as the JAX
package's ``ops/rope.py``: the head dim is viewed as ``D/2`` pairs laid out
interleaved (``x[..., 2i]`` real, ``x[..., 2i+1]`` imaginary), rotated by
angles from ``theta = 10000`` over a table of 16,384 positions. Per output
element the rotation is the same two fp32 products and one add as in JAX.

The hybrid backbone's rotate-half convention (:func:`apply_rope_half`, the
JAX package's ``models/mamba_backbone.apply_rope_half``): the first
``rotary_dim`` features of each head split into two halves rotated against
each other; the rest pass through.
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


def apply_rope_half(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
                    base: float = DEFAULT_ROPE_BASE) -> torch.Tensor:
    """Rotate-half RoPE on the first ``rotary_dim`` features of each head of
    ``x [B, S, H, D]`` at ``positions [B, S]``; computed in fp32, returned
    in ``x.dtype``."""
    if rotary_dim == 0:
        return x
    inv = 1.0 / (base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device)
                          / rotary_dim))
    ang = positions.float()[..., None] * inv  # [B, S, rd/2]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)[:, :, None, :]
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)[:, :, None, :]
    xr = x[..., :rotary_dim].float()
    x1, x2 = xr.chunk(2, dim=-1)
    rotated = xr * cos + torch.cat([-x2, x1], dim=-1) * sin
    return torch.cat([rotated.to(x.dtype), x[..., rotary_dim:]], dim=-1)
