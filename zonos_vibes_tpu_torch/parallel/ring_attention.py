"""Sequence-parallel attention: ring attention, Ulysses, and decode over a
time-sharded cache (the JAX package's ``parallel/ring_attention.py``).

Each function runs on one rank of a :class:`..parallel.comm.Comm` and takes
that rank's contiguous chunk of the sequence (rank ``i`` holds positions
``[i * S / n, (i + 1) * S / n)``, RoPE already applied at the global
positions); the outputs are chunked like the queries.

* :func:`ring_attention_prefill`: queries stay; K/V chunks travel the ring,
  folded in by an fp32 online softmax. Causality between chunks is
  block-triangular (chunk ``j`` counts fully for chunk ``i > j``, causally
  for ``j == i``, not for ``j > i``), so the mask depends on ring positions
  only.
* :func:`ulysses_prefill`: one all-to-all turns sequence chunks into head
  groups over the whole sequence, ordinary causal attention runs on them,
  and a second all-to-all turns them back. Needs ``Hkv % n == 0``.
* :func:`sp_decode_attention`: one query over a time-sharded cache: a local
  partial, one max and two sums over the group.

The JAX package runs these in plain JAX (no Pallas kernel), so they are
plain PyTorch here, softmax in fp32 as there.
"""

from __future__ import annotations

import torch

from .comm import Comm

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``q [B,S,Hq,D] x k [B,T,Hkv,D] -> [B,Hkv,G,S,T]`` fp32."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D).float() * scale
    return torch.einsum("bikgd,bjkd->bkgij", qg, k.float())


def ring_attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           comm: Comm) -> torch.Tensor:
    """Causal attention of this rank's chunk: ``q [B, S_c, Hq, D]``, ``k``/``v``
    ``[B, S_c, Hkv, D]`` -> ``[B, S_c, Hq, D]`` in ``q``'s dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    n, me = comm.size, comm.rank
    scale = 1.0 / D ** 0.5
    m = torch.full((B, Hkv, G, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32, device=q.device)
    ii = torch.arange(S, device=q.device)
    intra = ii[:, None] >= ii[None, :]
    kv = torch.stack([k, v]).contiguous()
    for r in range(n):
        src = (me - r) % n  # the chunk this K/V block came from
        if src <= me:
            kb, vb = kv[0], kv[1]
            s = _scores(q, kb, scale)
            if src == me:
                s = s.masked_fill(~intra, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            pv = torch.einsum("bkgij,bjkd->bkgid", p, vb.float())
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pv
            m = m_new
        if r < n - 1:  # pass K/V on to the next rank
            kv = comm.shift_(kv, torch.empty_like(kv))
    out = acc / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, S, Hq, D = q.shape
    s = _scores(q, k, 1.0 / D ** 0.5)
    ii = torch.arange(S, device=q.device)
    s = s.masked_fill(~(ii[:, None] >= ii[None, :]), NEG_INF)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgij,bjkd->bikgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def ulysses_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    comm: Comm) -> torch.Tensor:
    """Causal attention of this rank's chunk through a sequence-to-heads
    all-to-all and back. Needs ``Hkv % comm.size == 0``."""
    if k.shape[2] % comm.size:
        raise ValueError(f"ulysses_prefill: {k.shape[2]} kv heads do not split over "
                         f"{comm.size} ranks")
    qh, kh, vh = (comm.all_to_all(t, split_dim=2, concat_dim=1) for t in (q, k, v))
    out = _causal_attention(qh, kh, vh)  # [B, S, Hq / n, D]: this rank's heads
    return comm.all_to_all(out, split_dim=1, concat_dim=2)


def sp_decode_attention(q: torch.Tensor, k_loc: torch.Tensor, v_loc: torch.Tensor,
                        seq_end: int, comm: Comm) -> torch.Tensor:
    """One query over a cache split along time: ``q [B, 1, Hq, D]`` (every
    rank's the same), ``k_loc``/``v_loc`` this rank's time shard ``[B, T_loc,
    Hkv * D]`` of the port's time-major cache (rank ``i`` holds positions
    ``[i * T_loc, (i + 1) * T_loc)``), attending positions ``[0, seq_end)``.
    The softmax combines over the group with one max and two sums: the same
    as :func:`..ops.attention.decode_attention` on the gathered cache."""
    B, S, Hq, D = q.shape
    T_loc = k_loc.shape[1]
    Hkv = k_loc.shape[2] // D
    k = k_loc.reshape(B, T_loc, Hkv, D)
    v = v_loc.reshape(B, T_loc, Hkv, D)
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / D ** 0.5
    pos = comm.rank * T_loc + torch.arange(T_loc, device=q.device)
    scores = scores.masked_fill(pos >= seq_end, NEG_INF)
    m = comm.all_reduce_(scores.amax(dim=-1, keepdim=True), op="max")
    p = torch.exp(scores - m)  # a shard with no valid position: all zeros
    num = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    den = p.sum(dim=-1, keepdim=True)
    comm.all_reduce_(num)
    comm.all_reduce_(den)
    out = num / den
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
