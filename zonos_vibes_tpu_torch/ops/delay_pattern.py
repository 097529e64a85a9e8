"""Delay codebook pattern (the JAX package's ``ops/delay_pattern.py``): the
code grid ``[B, K, T]`` is padded with ``K`` MASK columns and codebook ``k``
is shifted right by ``k + 1``, so each decode step emits one token per
codebook with codebook ``k`` lagging ``k`` steps behind codebook 0."""

from __future__ import annotations

import torch


def apply_delay_pattern(codes: torch.Tensor, mask_token: int) -> torch.Tensor:
    """``[B, K, T] -> [B, K, T + K]``; the first ``k + 1`` columns of row
    ``k`` and the trailing ones carry ``mask_token``."""
    B, K, T = codes.shape
    out = torch.full((B, K, T + K), mask_token, dtype=codes.dtype, device=codes.device)
    for k in range(K):
        out[:, k, k + 1: k + 1 + T] = codes[:, k]
    return out


def revert_delay_pattern(delayed: torch.Tensor) -> torch.Tensor:
    """``[B, K, T + K] -> [B, K, T]``: row ``k`` is columns
    ``[k + 1, T + k + 1)``."""
    B, K, Td = delayed.shape
    T = Td - K
    return torch.stack([delayed[:, k, k + 1: k + 1 + T] for k in range(K)], dim=1)
