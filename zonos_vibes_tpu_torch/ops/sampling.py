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

The continuous-batching pool samples with runtime knobs instead
(:func:`sample_from_logits_dyn`): every knob is a per-row tensor, every
stage is computed for every row and ``where``-gated back to the identity
where its knob is off, so rows with different settings share one step and
each gets the static pipeline's distribution. Its draws come from
:func:`pool_noise`, a counter-based Exp(1) stream keyed by (base seed, row
seed, row step) and computed on the device.
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
    # A Python scalar base: no host-to-device copy, so the step stays
    # capturable in a CUDA graph.
    factors = torch.pow(float(penalty), counts)
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


# ---------------------------------------------------------------------------
# Runtime-knob sampler (continuous-batching pools)
# ---------------------------------------------------------------------------

KNOB_FIELDS = (
    "temperature", "top_p", "top_k", "min_p", "linear", "conf", "quad",
    "repetition_penalty", "repetition_penalty_window", "cfg_scale",
)
_INT_KNOBS = ("top_k", "repetition_penalty_window")


def knobs_from_params(params: SamplingParams, cfg_scale: float, device=None) -> dict:
    """``SamplingParams`` + CFG scale -> the knob dict of 0-d tensors (fp32,
    int64 for ``top_k`` and the window) that the pool stacks per row."""
    values = {f: getattr(params, f) for f in KNOB_FIELDS[:-1]}
    values["cfg_scale"] = cfg_scale
    return {f: torch.tensor(v, dtype=torch.int64 if f in _INT_KNOBS else torch.float32,
                            device=device) for f, v in values.items()}


def _row(knob: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` (or 0-d) knob broadcast against ``[B, K, V]``."""
    return knob.reshape(-1, 1, 1)


def sampling_probs_dyn(logits, knobs: dict, generated_tokens=None,
                       sorted_stages: bool = True):
    """The runtime-knob pipeline up to the draw. Returns ``(probs,
    penalized)``: the distribution a row with ``temperature > 0`` draws from
    and the fp32 penalized logits a greedy row takes the argmax of.

    ``generated_tokens [B, K, W]`` holds the static maximum window; only the
    last ``repetition_penalty_window`` columns of each row count (ids clamp
    to ``V - 1``; negative ids count for nothing). ``sorted_stages=False``
    leaves top-p and top-k (the stages that need a sort) out: legal only
    while every row has ``top_p == top_k == 0``.
    """
    lf = logits.float()
    V = lf.shape[-1]
    if generated_tokens is not None:
        W = generated_tokens.shape[-1]
        valid = torch.arange(W, device=lf.device) >= (W - knobs["repetition_penalty_window"].reshape(-1, 1, 1))
        wt = generated_tokens.clamp(max=V - 1).long()
        weight = (valid & (wt >= 0)).float().expand(wt.shape)
        counts = torch.zeros(lf.shape, dtype=torch.float32, device=lf.device)
        counts.scatter_add_(-1, wt.clamp(min=0), weight)
        pen = _row(knobs["repetition_penalty"])
        factors = torch.pow(pen, counts)
        penalized = torch.where(lf <= 0, lf * factors, lf / factors)
        lf = torch.where(pen != 1.0, penalized, lf)

    t = _row(knobs["temperature"])
    probs = torch.softmax(lf / torch.where(t > 0, t, torch.ones_like(t)), dim=-1)
    linear = _row(knobs["linear"])
    uni = apply_unified(probs, linear, _row(knobs["conf"]), _row(knobs["quad"]))
    probs = torch.where(linear > 0, uni, probs)

    if sorted_stages:
        # One descending sort serves both stages (ties in index order).
        top_p = _row(knobs["top_p"])
        sort_idx = torch.argsort(-probs, dim=-1, stable=True)
        probs_sort = torch.gather(probs, -1, sort_idx)
        cum = torch.cumsum(probs_sort, dim=-1)
        kept = torch.where(cum - probs_sort <= top_p, probs_sort, 0.0)
        topp = torch.zeros_like(probs).scatter_(-1, sort_idx, kept)
        topp = topp / topp.sum(dim=-1, keepdim=True)
        probs = torch.where(top_p > 0, topp, probs)
        # top-p zeroed a suffix of the sorted order and rescaled, so the
        # k-th largest of the current probs is still at sorted position k-1.
        top_k = _row(knobs["top_k"])
        k_eff = top_k.clamp(1, V).expand(*probs.shape[:-1], 1)
        pivot = torch.gather(torch.gather(probs, -1, sort_idx), -1, k_eff - 1)
        topk = torch.where(probs < pivot, 0.0, probs)
        topk = topk / topk.sum(dim=-1, keepdim=True)
        probs = torch.where(top_k > 0, topk, probs)

    min_p = _row(knobs["min_p"])
    probs = torch.where(min_p > 0, apply_min_p(probs, min_p), probs)
    return probs, lf


def sample_from_logits_dyn(logits, knobs: dict, noise: torch.Tensor, generated_tokens=None,
                           sorted_stages: bool = True) -> torch.Tensor:
    """Runtime-knob sampling: ``logits [B, K, V] -> tokens [B, K]``. Rows
    with ``temperature > 0`` take ``argmax(probs / noise)`` (the exponential
    race; ``noise`` holds Exp(1) draws of the logits' shape), the others the
    argmax of the penalized logits."""
    probs, lf = sampling_probs_dyn(logits, knobs, generated_tokens, sorted_stages)
    sampled = (probs / noise).argmax(dim=-1)
    greedy = lf.argmax(dim=-1)
    return torch.where(knobs["temperature"].reshape(-1, 1) > 0, sampled, greedy)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``, in two 16-bit
    halves so no product leaves the int64 range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, constants of Chris
    Wellons' ``lowbias32``), on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def pool_noise(base_seed: int, row_seed: torch.Tensor, step: torch.Tensor, K: int,
               V: int) -> torch.Tensor:
    """Exp(1) draws ``[S, K, V]`` fp32 for the pool's rows: element
    ``(s, k, v)`` is a hash of ``(base_seed, row_seed[s], step[s], k, v)``,
    so a row's draws depend on its own seed and step and never on the other
    rows. Computed on ``row_seed``'s device with integer tensor ops: no host
    value per step, no generator state."""
    dev = row_seed.device
    key = _mix32(torch.full_like(row_seed, base_seed & _M32, dtype=torch.int64))
    key = _mix32(key ^ (row_seed.long() & _M32))
    key = _mix32(key ^ (step.long() & _M32))
    idx = _mix32(torch.arange(K * V, dtype=torch.int64, device=dev).reshape(1, K, V) + 0x9E3779B9)
    h = _mix32(key.reshape(-1, 1, 1) ^ idx)
    # 23 bits into (0, 1) exactly in fp32, then the inverse CDF.
    u = ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(u)
