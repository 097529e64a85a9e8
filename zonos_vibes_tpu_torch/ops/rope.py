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

import functools

import numpy as np
import torch

DEFAULT_ROPE_BASE = 10000.0
DEFAULT_MAX_POSITIONS = 16384


def _freq_values(dim: int, base: float) -> list[float]:
    return [1.0 / base ** (i / dim) for i in range(0, dim, 2)]


@functools.lru_cache(maxsize=None)
def rope_freqs(dim: int, base: float = DEFAULT_ROPE_BASE, device=None) -> torch.Tensor:
    """``[dim / 2]`` fp32 frequencies ``1 / base ** (2i / dim)``, each taken
    in Python float64 and rounded once to fp32 on the host, then moved to
    ``device``: the same bits on the CPU and on the card, whatever fp32
    ``pow`` either would pick. Cached per device, so a decode step under
    CUDA-graph capture copies nothing from the host."""
    return torch.tensor(_freq_values(dim, base), dtype=torch.float32).to(device)


@functools.lru_cache(maxsize=None)
def rope_table(head_dim: int, max_positions: int = DEFAULT_MAX_POSITIONS,
               base: float = DEFAULT_ROPE_BASE, device=None) -> torch.Tensor:
    """``[P, 2, D]`` fp32 table: row 0 holds each pair's cos duplicated over
    the pair, row 1 holds ``(-sin, +sin)`` per pair (the rotation signs
    folded in), the JAX package's expanded form.

    Built once per device on the host, on one thread, in numpy: the fp32
    frequencies of :func:`rope_freqs`, fp32 angles (correctly rounded
    products), cos and sin of those angles in float64 rounded once to fp32;
    then moved to ``device``. So the CPU and the card hold the same bits on
    every host. (Built with torch's parallel CPU ops, the table's first
    build in a process now and then came out with one worker's chunk of
    2048 positions off by up to 1.5e-4.)"""
    freqs = np.array(_freq_values(head_dim, base), dtype=np.float64).astype(np.float32)
    angles = np.arange(max_positions, dtype=np.float32)[:, None] * freqs  # [P, D/2]
    a = angles.astype(np.float64)
    cos, sin = np.cos(a), np.sin(a)
    table = np.stack([np.repeat(cos, 2, -1),
                      np.stack([-sin, sin], -1).reshape(max_positions, -1)], 1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


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
    inv = rope_freqs(rotary_dim, base, x.device)
    ang = positions.float()[..., None] * inv  # [B, S, rd/2]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)[:, :, None, :]
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)[:, :, None, :]
    xr = x[..., :rotary_dim].float()
    x1, x2 = xr.chunk(2, dim=-1)
    rotated = xr * cos + torch.cat([-x2, x1], dim=-1) * sin
    return torch.cat([rotated.to(x.dtype), x[..., rotary_dim:]], dim=-1)
