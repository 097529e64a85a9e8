"""Fused Mamba-2 decode step: the CUDA kernel's wrappers and its plain version.

Counterparts of ``zonos_vibes_tpu/ops/pallas/mamba_step.py::
ssd_gate_step_pallas`` and ``ssd_gate_step_layered_pallas``: the state
update ``h = h * exp(dt A) + B (dt x)``, the readout ``y = C . h + D x``,
the gate ``g = y * silu(z)`` and the gated RMSNorm
``g * rsqrt(mean(g^2) + eps) * w`` in one kernel (``csrc/mamba_step.cu``),
on the lane-transposed state ``[B, N, H*P]`` (d_state rows, d_inner
columns), updated in place. ``y`` stays fp32 through the norm, as in the
fused Pallas kernel (JAX's unfused chain, which it runs below batch 8,
rounds ``y`` to the activation dtype before the gate).

The kernel takes per-head ``dt`` and ``decay = exp(dt A)`` ``[B, H]`` and
``D [H]``; JAX expands them over each head's ``P`` lanes for the TPU. One
kernel serves both Pallas functions: :func:`ssd_gate_step` is
:func:`ssd_gate_step_layered` on a one-plane view, and both count their
launches under ``ssd_gate_step``.

Each call is one launch: a block updates every state row of a tile of
columns (:func:`step_plan`), and the row's gated norm is taken by its last
block to arrive, from ``g`` and the tiles' sums of ``g^2`` in a per-device
fp32 workspace, under one int32 ticket per batch row, which that block
resets. Both are reused across calls, so every launch must stay on one
stream (the caller's current one).

The partial-norm mode (``partial=True``) serves a tensor-parallel rank that
holds ``HP / n`` of the columns, whose gated RMSNorm spans every rank's
heads: the same launch returns ``g * w`` unscaled and each row's fp32 sum of
``g^2``, which the caller reduces over the ranks together with the
row-parallel out_proj (``models/mamba_backbone``, the norm fold). It counts
its launches under ``ssd_gate_step_partial``;
:func:`ssd_gate_step_partial_plain` is its plain version.
"""

from __future__ import annotations

import torch

from . import build
from .qmm import _sm_count

# The kernel's plan: the widest column tile of TILES whose grid of
# (HP / tile) x B blocks puts a block on each of the card's SMs (else the
# narrowest). Each block updates all N state rows of its tile; a thread
# copies one 16-byte chunk of a state row per pass (4 fp32 or 8 bf16
# columns), so a pass covers 256 * 16 / (tile * state bytes) rows, and a
# block holds at most MAX_ROWS.
TILES = (128, 64, 32)
SMS = 132  # the H100 SXM's; a launch plans for its own card's count
MAX_ROWS = 256
_WORKSPACES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def step_plan(B: int, N: int, HP: int, state_bytes: int, sms: int = SMS) -> int:
    """The column tile of a launch on a card of ``sms`` SMs, from the shapes
    alone: the grid is ``(HP / tile, B)`` blocks."""
    tile = next((t for t in TILES if B * (HP // t) >= sms), TILES[-1])
    pass_rows = 256 * 16 // (tile * state_bytes)
    if HP % TILES[0] or N % pass_rows or N > MAX_ROWS:
        raise ValueError(f"step_plan: HP must be a multiple of {TILES[0]} and N of {pass_rows}, "
                         f"at most {MAX_ROWS}; got HP={HP}, N={N}")
    return tile


def _workspace(dev: torch.device, floats: int, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's fp32 workspace and zeroed tickets, grown on demand."""
    ws, tickets = _WORKSPACES.get(dev, (None, None))
    if ws is None or ws.numel() < floats or tickets.numel() < rows:
        ws = torch.empty(max(floats, 1 << 16), dtype=torch.float32, device=dev)
        tickets = torch.zeros(max(rows, 64), dtype=torch.int32, device=dev)
        _WORKSPACES[dev] = ws, tickets
    return ws, tickets


def _gate_plain(states, layer: int, xs, dt, decay, bm, cm, z, d_skip) -> torch.Tensor:
    """The state update of plane ``layer`` (in place), the readout and the
    gate: ``g`` ``[B, HP]`` fp32."""
    H = dt.shape[-1]
    P = states.shape[-1] // H
    xf = xs.float()
    dtx = dt.float().repeat_interleave(P, dim=-1) * xf  # [B, HP]
    new = (states[layer].float() * decay.float().repeat_interleave(P, dim=-1)[:, None, :]
           + bm.float()[:, :, None] * dtx[:, None, :])
    states[layer] = new.to(states.dtype)
    y = (cm.float()[:, :, None] * new).sum(dim=1) + d_skip.float().repeat_interleave(P) * xf
    zf = z.float()
    return y * (zf * torch.sigmoid(zf))


def ssd_gate_step_layered_plain(states, layer: int, xs, dt, decay, bm, cm, z, d_skip, norm_w,
                                eps: float = 1e-5) -> torch.Tensor:
    """Reference: the same fp32 arithmetic in plain tensor ops; plane
    ``layer`` of ``states`` is overwritten, the rest untouched."""
    g = _gate_plain(states, layer, xs, dt, decay, bm, cm, z, d_skip)
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps)
    return (g * norm_w.float()).to(z.dtype)


def ssd_gate_step_partial_plain(states, layer: int, xs, dt, decay, bm, cm, z, d_skip,
                                norm_w) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial-norm mode's reference: plane ``layer`` updated as by
    :func:`ssd_gate_step_layered_plain`; returns ``g * w`` rounded once to
    ``z``'s dtype and each row's fp32 sum of ``g^2`` ``[B]``."""
    g = _gate_plain(states, layer, xs, dt, decay, bm, cm, z, d_skip)
    return (g * norm_w.float()).to(z.dtype), (g * g).sum(dim=-1)


def ssd_gate_step_layered(states: torch.Tensor, layer: int, xs, dt, decay, bm, cm, z, d_skip,
                          norm_w, eps: float = 1e-5, *, partial: bool = False):
    """One decode step of a Mamba-2 mixer on plane ``layer`` of a stacked
    state, in place; returns the gated, normalised ``[B, HP]`` output, or
    with ``partial`` (a tensor-parallel rank's heads) ``(g * w [B, HP],
    sum of g^2 [B] fp32)`` (module docstring).

    Args:
      states: ``[R, B, N, HP]`` fp32 or bf16 (``HP = H * P``); only plane
        ``layer`` is written.
      layer: host int in ``[0, R)``.
      xs, z: ``[B, HP]`` (post-conv ``x`` and the gate input).
      dt, decay: ``[B, H]`` fp32: ``softplus(dt + dt_bias)`` and
        ``exp(dt * A)``.
      bm, cm: ``[B, N]`` fp32 (one group).
      d_skip: ``[H]`` fp32; norm_w: ``[HP]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16
    ``xs``, ``z``, ``norm_w``; ``HP`` a multiple of 128 up to 8192; ``P`` a
    multiple of 4 with an fp32 state, of 8 with a bf16 one; ``N`` at most
    256 and a multiple of the plan's rows a pass) or raise."""
    R, B, N, HP = states.shape
    H = dt.shape[-1]
    if (H <= 0 or HP % H or xs.shape != (B, HP) or z.shape != (B, HP)
            or dt.shape != (B, H) or decay.shape != (B, H) or bm.shape != (B, N)
            or cm.shape != (B, N) or d_skip.shape != (H,) or norm_w.shape != (HP,)):
        raise ValueError("ssd_gate_step: inconsistent shapes")
    if not 0 <= layer < R:
        raise ValueError(f"ssd_gate_step: layer {layer} outside [0, {R})")
    if states.device.type == "cpu":
        if partial:
            return ssd_gate_step_partial_plain(states, layer, xs, dt, decay, bm, cm, z, d_skip,
                                               norm_w)
        return ssd_gate_step_layered_plain(states, layer, xs, dt, decay, bm, cm, z, d_skip,
                                           norm_w, eps)
    dev = build.require_cuda("ssd_gate_step", states, xs, dt, decay, bm, cm, z, d_skip, norm_w)
    if states.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_gate_step: state must be fp32 or bf16, got {states.dtype}")
    for t in (xs, z, norm_w):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"ssd_gate_step: kernel takes bf16 activations, got {t.dtype}")
    for t in (dt, decay, bm, cm, d_skip):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_gate_step: dt, decay, B, C and D must be fp32, got {t.dtype}")
    tile = step_plan(B, N, HP, states.element_size(), _sm_count(dev))
    ws, tickets = _workspace(dev, B * HP + B * HP // tile, B)
    out = z.new_empty((B, HP))
    sumsq = dt.new_empty((B,)) if partial else None
    rc = build.load().zvt_ssd_gate_step(
        states.data_ptr(), int(states.dtype == torch.bfloat16), layer, xs.data_ptr(),
        dt.data_ptr(), decay.data_ptr(), bm.data_ptr(), cm.data_ptr(), z.data_ptr(),
        d_skip.data_ptr(), norm_w.data_ptr(), out.data_ptr(),
        None if sumsq is None else sumsq.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        R, B, N, HP, H, tile, float(eps), build.stream_handle(dev))
    build.check_status("ssd_gate_step", rc)
    name = "ssd_gate_step_partial" if partial else "ssd_gate_step"
    build.LAUNCHES[name] += 1
    return (out, sumsq) if partial else out


def ssd_gate_step(state: torch.Tensor, xs, dt, decay, bm, cm, z, d_skip, norm_w,
                  eps: float = 1e-5) -> torch.Tensor:
    """:func:`ssd_gate_step_layered` on one state ``[B, N, HP]``, updated in
    place (the kernel on a one-plane view)."""
    if state.dim() != 3:
        raise ValueError("ssd_gate_step: state must be [B, N, HP]")
    return ssd_gate_step_layered(state[None], 0, xs, dt, decay, bm, cm, z, d_skip, norm_w, eps)
