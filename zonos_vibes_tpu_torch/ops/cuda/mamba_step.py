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
"""

from __future__ import annotations

import torch

from . import build


def ssd_gate_step_layered_plain(states, layer: int, xs, dt, decay, bm, cm, z, d_skip, norm_w,
                                eps: float = 1e-5) -> torch.Tensor:
    """Reference: the same fp32 arithmetic in plain tensor ops; plane
    ``layer`` of ``states`` is overwritten, the rest untouched."""
    H = dt.shape[-1]
    P = states.shape[-1] // H
    xf = xs.float()
    dtx = dt.float().repeat_interleave(P, dim=-1) * xf  # [B, HP]
    new = (states[layer].float() * decay.float().repeat_interleave(P, dim=-1)[:, None, :]
           + bm.float()[:, :, None] * dtx[:, None, :])
    states[layer] = new.to(states.dtype)
    y = (cm.float()[:, :, None] * new).sum(dim=1) + d_skip.float().repeat_interleave(P) * xf
    zf = z.float()
    g = y * (zf * torch.sigmoid(zf))
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps)
    return (g * norm_w.float()).to(z.dtype)


def ssd_gate_step_layered(states: torch.Tensor, layer: int, xs, dt, decay, bm, cm, z, d_skip,
                          norm_w, eps: float = 1e-5) -> torch.Tensor:
    """One decode step of a Mamba-2 mixer on plane ``layer`` of a stacked
    state, in place; returns the gated, normalised ``[B, HP]`` output.

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
    ``xs``, ``z``, ``norm_w``; ``HP`` a multiple of 128, ``P`` of 4, ``N`` of
    64) or raise.
    """
    R, B, N, HP = states.shape
    H = dt.shape[-1]
    if (H <= 0 or HP % H or xs.shape != (B, HP) or z.shape != (B, HP)
            or dt.shape != (B, H) or decay.shape != (B, H) or bm.shape != (B, N)
            or cm.shape != (B, N) or d_skip.shape != (H,) or norm_w.shape != (HP,)):
        raise ValueError("ssd_gate_step: inconsistent shapes")
    if not 0 <= layer < R:
        raise ValueError(f"ssd_gate_step: layer {layer} outside [0, {R})")
    if states.device.type == "cpu":
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
    lib = build.load()
    g = torch.empty((B, HP), dtype=torch.float32, device=dev)
    part = torch.empty((B, max(lib.zvt_ssd_gate_step_tiles(HP), 1)), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, HP), dtype=z.dtype, device=dev)
    rc = lib.zvt_ssd_gate_step(
        states.data_ptr(), int(states.dtype == torch.bfloat16), layer, xs.data_ptr(),
        dt.data_ptr(), decay.data_ptr(), bm.data_ptr(), cm.data_ptr(), z.data_ptr(),
        d_skip.data_ptr(), norm_w.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
        R, B, N, HP, H, float(eps), build.stream_handle(dev))
    build.check_status("ssd_gate_step", rc)
    build.LAUNCHES["ssd_gate_step"] += 1
    return out


def ssd_gate_step(state: torch.Tensor, xs, dt, decay, bm, cm, z, d_skip, norm_w,
                  eps: float = 1e-5) -> torch.Tensor:
    """:func:`ssd_gate_step_layered` on one state ``[B, N, HP]``, updated in
    place (the kernel on a one-plane view)."""
    if state.dim() != 3:
        raise ValueError("ssd_gate_step: state must be [B, N, HP]")
    return ssd_gate_step_layered(state[None], 0, xs, dt, decay, bm, cm, z, d_skip, norm_w, eps)
