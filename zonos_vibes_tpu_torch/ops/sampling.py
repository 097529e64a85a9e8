"""Token sampling (the static pipeline of the JAX package's
``ops/sampling.py``) with an explicit ``torch.Generator``.

1. repetition penalty over the last ``window`` delayed frames (token ids
   clamped to ``V - 1``, so MASK lands on the top vocab slot);
2. if temperature > 0: ``softmax(logits / T)``, then in order the unified
   transform, top-p, top-k and min-p, and one draw by the exponential race
   ``argmax(probs / Exp(1))``;
3. else greedy argmax.

Logits are ``[B, K, V]``; tokens come back ``[B, K]`` int64. The JAX and
torch random streams differ, so tests compare :func:`sampling_probs` (the
distribution before the draw) and greedy tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_EPS = 1e-20


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 0
    min_p: float = 0.0
    linear: float = 0.0
    conf: float = 0.0
    quad: float = 0.0
    repetition_penalty: float = 3.0
    repetition_penalty_window: int = 2

    @classmethod
    def from_dict(cls, d: dict | None) -> "SamplingParams":
        return cls(**(d or {}))


def apply_repetition_penalty(logits, generated_tokens, penalty: float, window: int):
    """``factors[v] = penalty ** count(v in the last window tokens)``;
    ``logits * f`` where ``logits <= 0`` else ``logits / f`` (fp32).
    Negative ids (not yet generated) count for nothing, as a one-hot of a
    negative index is all zeros in JAX."""
    V = logits.shape[-1]
    window_tokens = generated_tokens[..., -window:].clamp(max=V - 1).long()
    seen = (window_tokens >= 0).float()
    counts = torch.zeros(logits.shape, dtype=torch.float32, device=logits.device)
    counts.scatter_add_(-1, window_tokens.clamp(min=0), seen)
    factors = torch.pow(torch.tensor(penalty, dtype=torch.float32, device=logits.device), counts)
    lf = logits.float()
    return torch.where(lf <= 0, lf * factors, lf / factors)


def apply_unified(probs, linear: float, conf: float, quad: float):
    logprobs = torch.log(probs.clamp(min=_EPS))
    entropy = -(probs * logprobs).sum(dim=-1, keepdim=True)
    raw = logprobs * (linear + entropy * conf) - logprobs.square() * quad
    return torch.softmax(raw, dim=-1)


def apply_top_p(probs, p: float):
    """Drop tokens whose preceding cumulative mass (sorted descending, ties
    in index order) already exceeds ``p``; renormalize."""
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)
    probs_sort = torch.gather(probs, -1, sort_idx)
    cum = torch.cumsum(probs_sort, dim=-1)
    probs_sort = torch.where(cum - probs_sort <= p, probs_sort, 0.0)
    out = torch.zeros_like(probs).scatter_(-1, sort_idx, probs_sort)
    return out / out.sum(dim=-1, keepdim=True)


def apply_top_k(probs, k: int):
    k = min(k, probs.shape[-1])
    pivot = torch.topk(probs, k, dim=-1).values[..., -1:]
    out = torch.where(probs < pivot, 0.0, probs)
    return out / out.sum(dim=-1, keepdim=True)


def apply_min_p(probs, min_p: float):
    top = probs.max(dim=-1, keepdim=True).values
    out = torch.where(probs < min_p * top, 0.0, probs)
    return out / out.sum(dim=-1, keepdim=True)


def sampling_probs(logits, params: SamplingParams, generated_tokens=None):
    """The distribution the draw uses (temperature > 0) or the penalized
    fp32 logits that greedy decoding takes the argmax of."""
    if params.repetition_penalty != 1.0 and generated_tokens is not None:
        logits = apply_repetition_penalty(logits, generated_tokens, params.repetition_penalty,
                                          params.repetition_penalty_window)
    logits = logits.float()
    if params.temperature <= 0:
        return logits
    probs = torch.softmax(logits / params.temperature, dim=-1)
    if params.linear > 0.0:
        probs = apply_unified(probs, params.linear, params.conf, params.quad)
    if params.top_p > 0:
        probs = apply_top_p(probs, params.top_p)
    if params.top_k > 0:
        probs = apply_top_k(probs, params.top_k)
    if params.min_p > 0:
        probs = apply_min_p(probs, params.min_p)
    return probs


def sample_from_logits(generator: torch.Generator | None, logits, params: SamplingParams,
                       generated_tokens=None) -> torch.Tensor:
    """Full sampling pipeline: ``logits [B, K, V] -> tokens [B, K]``."""
    probs = sampling_probs(logits, params, generated_tokens)
    if params.temperature <= 0:
        return probs.argmax(dim=-1)
    e = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / e).argmax(dim=-1)
