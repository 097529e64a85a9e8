"""Mamba-2 (SSD) ops in plain PyTorch: the chunked prefill scan, the
single-token recurrence and the short causal depthwise conv (the JAX
package's ``ops/mamba.py``, which runs them in XLA).

* **Prefill** uses the SSD chunked form: the sequence is cut into chunks;
  inside a chunk the work is dense attention-like products, and the state
  is carried from chunk to chunk in a short loop.
* **Decode** is the exact recurrence, one token per call. The persistent
  state is stored lane-transposed ``[B, N, H*P]`` (:func:`state_to_lanes`),
  the layout the fused decode kernel (``ops/cuda/mamba_step.py``) reads;
  :func:`ssd_step_t` is the unfused form and :func:`ssd_step` keeps the
  canonical ``[B, H, P, N]`` convention for tests.
* **Causal conv** keeps a rolling ``[B, d_conv - 1, C]`` buffer for decode.

Recurrence per head (``A < 0``): ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t
x_t^T``, ``y_t = C_t . h_t + D x_t``. Conventions: x ``[B, L, H, P]``, dt
``[B, L, H]`` (softplus and bias applied), A ``[H]``, B/C ``[B, L, G, N]``
(G groups, H / G heads each), D ``[H]``. State math is fp32 throughout.
"""

from __future__ import annotations

import torch


def _group_expand(bc: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``[..., G, N] -> [..., H, N]`` by repeating each group."""
    return bc.repeat_interleave(n_heads // bc.shape[-2], dim=-2)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int = 64, init_state=None):
    """Full-sequence SSD scan. Returns ``(y [B, L, H, P] in x.dtype,
    final_state [B, H, P, N] fp32)``. A length that is not a multiple of
    ``chunk`` is padded with ``dt = 0`` (decay 1, no contribution), which is
    exact."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = -L % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // chunk

    def chunked(a):
        return a.reshape((Bsz, nc, chunk) + tuple(a.shape[2:]))

    xc = chunked(x.float())
    dtc = chunked(dt.float())
    Bc = chunked(_group_expand(Bm.float(), H))  # [B, nc, Q, H, N]
    Cc = chunked(_group_expand(Cm.float(), H))
    dA = dtc * A.float()[None, None, None, :]  # [B, nc, Q, H]
    cs = torch.cumsum(dA, dim=2)  # inclusive, within the chunk

    # Intra-chunk: scores[b,c,h,i,j] = (C_i . B_j) exp(cs_i - cs_j) dt_j, i >= j.
    cb = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    csh = cs.permute(0, 1, 3, 2)  # [B, nc, H, Q]
    decay = torch.exp(csh[..., :, None] - csh[..., None, :])
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    scores = cb * torch.where(causal, decay, torch.zeros_like(decay)) \
        * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    last = cs[:, :, -1, :]  # [B, nc, H]
    seg = torch.exp(last[:, :, None, :] - cs)  # [B, nc, Q, H]
    state_chunk = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", seg * dtc, xc, Bc)
    total_decay = torch.exp(last)  # [B, nc, H]

    h_prevs = []  # the state before each chunk
    for c in range(nc):
        h_prevs.append(state)
        state = state * total_decay[:, c, :, None, None] + state_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # [B, nc, H, P, N]

    y_state = torch.einsum("bcihn,bchpn->bcihp", Cc * torch.exp(cs)[..., None], h_prev)
    y = (y_intra + y_state).reshape(Bsz, nc * chunk, H, P)
    y = y + xc.reshape(Bsz, nc * chunk, H, P) * D.float()[None, None, :, None]
    return y[:, :L].to(x.dtype), state


def ssd_step(state, x, dt, A, Bm, Cm, D):
    """One recurrent step in the canonical layout: ``state [B, H, P, N]``,
    x ``[B, H, P]``, dt ``[B, H]``, B/C ``[B, G, N]``. Returns ``(y
    [B, H, P] in x.dtype, new_state fp32)``."""
    H = x.shape[1]
    xf, dtf = x.float(), dt.float()
    Bh = _group_expand(Bm.float(), H)  # [B, H, N]
    Ch = _group_expand(Cm.float(), H)
    decay = torch.exp(dtf * A.float()[None, :])
    new_state = (state * decay[:, :, None, None]
                 + torch.einsum("bh,bhp,bhn->bhpn", dtf, xf, Bh))
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state) + xf * D.float()[None, :, None]
    return y.to(x.dtype), new_state


def state_to_lanes(h: torch.Tensor) -> torch.Tensor:
    """``[B, H, P, N] -> [B, N, H*P]``, the stored layout."""
    B, H, P, N = h.shape
    return h.permute(0, 3, 1, 2).reshape(B, N, H * P)


def state_from_lanes(st: torch.Tensor, nheads: int) -> torch.Tensor:
    """``[B, N, H*P] -> [B, H, P, N]`` (inverse of :func:`state_to_lanes`)."""
    B, N, HP = st.shape
    return st.reshape(B, N, nheads, HP // nheads).permute(0, 2, 3, 1)


def _head_to_lanes(a: torch.Tensor, P: int) -> torch.Tensor:
    """Per-head ``[B, H] -> [B, H*P]``, each head's value over its ``P``
    contiguous lanes."""
    return a.repeat_interleave(P, dim=-1)


def ssd_step_t(state_t, xs, dt, A, Bm, Cm, D, nheads: int):
    """One recurrent step on the stored layout ``state_t [B, N, H*P]`` (any
    float dtype; the math is fp32), ``xs [B, H*P]``, dt ``[B, H]``, B/C
    ``[B, G, N]``. Returns ``(y [B, H*P] in xs.dtype, new_state_t fp32)``."""
    B, N, HP = state_t.shape
    P, G = HP // nheads, Bm.shape[1]
    xf, dtf = xs.float(), dt.float()
    decay = _head_to_lanes(torch.exp(dtf * A.float()[None, :]), P)
    dtxs = _head_to_lanes(dtf, P) * xf

    def bc_lanes(bc):  # [B, G, N] -> [B, N, HP], each group over its heads' lanes
        return bc.float().transpose(1, 2).repeat_interleave(HP // G, dim=-1)

    new_state = state_t.float() * decay[:, None, :] + bc_lanes(Bm) * dtxs[:, None, :]
    y = (bc_lanes(Cm) * new_state).sum(dim=1)
    y = y + _head_to_lanes(D.float()[None].expand(B, nheads), P) * xf
    return y.to(xs.dtype), new_state


def ssd_naive(x, dt, A, Bm, Cm, D, init_state=None):
    """Sequential reference recurrence (slow; for tests)."""
    Bsz, L, H, P = x.shape
    state = (torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        y, state = ssd_step(state, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def causal_conv1d(x, w, b, conv_state=None):
    """Depthwise causal conv over ``x [B, L, C]`` with kernel ``w [K, C]``
    and bias ``b [C]``, each tap summed in fp32. ``conv_state [B, K-1, C]``
    holds the trailing inputs of a previous call. Returns ``(y [B, L, C] in
    x.dtype, new_conv_state)``."""
    K = w.shape[0]
    Bsz, L, C = x.shape
    if conv_state is None:
        conv_state = torch.zeros((Bsz, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    wf = w.float()
    y = b.float()[None, None, :].expand(Bsz, L, C)
    for k in range(K):
        y = y + xp[:, k: k + L].float() * wf[k]
    return y.to(x.dtype), xp[:, L:]


def causal_conv1d_step(x, w, b, conv_state):
    """Single-token causal conv: ``x [B, C]``, state ``[B, K-1, C]``.
    Returns ``(y [B, C] in x.dtype, new_state)``."""
    window = torch.cat([conv_state, x[:, None, :]], dim=1)  # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return (y + b.float()).to(x.dtype), window[:, 1:]
