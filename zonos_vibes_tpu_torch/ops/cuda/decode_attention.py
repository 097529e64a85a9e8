"""Staged single-query decode attention: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``zonos_vibes_tpu/ops/pallas/decode_attention.py::
decode_attention_pallas_layered``. For layer ``layer`` of the stacked cache
it attends over three parts: the flushed prefix ``[0, flushed_end)`` of the
time-major cache, the first ``stage_len`` rows of the time-major stage, and
the current token's column. The kernel (``csrc/decode_attention.cu``) reads
the three scalars from a device int32 tensor, so the launch does not depend
on host values.
"""

from __future__ import annotations

import torch

from ..attention import decode_attention
from . import build


def decode_attention_layered_plain(q, k_cache, v_cache, k_stage, v_stage, k_cur,
                                   v_cur, scalars) -> torch.Tensor:
    """Dense reference: gather the three parts and attend over all of them."""
    flushed_end, stage_len, layer = (int(x) for x in scalars.tolist())
    k = torch.cat([k_cache[layer, :, :flushed_end], k_stage[layer, :, :stage_len],
                   k_cur[:, None]], dim=1)
    v = torch.cat([v_cache[layer, :, :flushed_end], v_stage[layer, :, :stage_len],
                   v_cur[:, None]], dim=1)
    return decode_attention(q, k, v, flushed_end + stage_len + 1)


def decode_attention_layered(q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur,
                             scalars) -> torch.Tensor:
    """Decode attention for one layer of the stacked cache.

    Args:
      q: ``[B, 1, Hq, D]``.
      k_cache, v_cache: ``[L, B, T, Hkv*D]`` flushed prefix (read only).
      k_stage, v_stage: ``[L, B, STAGE, Hkv*D]`` unflushed tail.
      k_cur, v_cur: ``[B, Hkv*D]`` this step's column.
      scalars: int32 ``[3]``: ``(flushed_end, stage_len, layer)``.
    Returns ``[B, 1, Hq, D]``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16, D = 64) or raise.
    """
    B, S, Hq, D = q.shape
    L, Bc, T, W = k_cache.shape
    STAGE = k_stage.shape[2]
    if (S != 1 or Bc != B or W % D or Hq % (W // D) or v_cache.shape != k_cache.shape
            or k_stage.shape != (L, B, STAGE, W) or v_stage.shape != k_stage.shape
            or k_cur.shape != (B, W) or v_cur.shape != k_cur.shape
            or scalars.shape != (3,) or scalars.dtype != torch.int32):
        raise ValueError("decode_attention_layered: inconsistent shapes")
    if q.device.type == "cpu":
        return decode_attention_layered_plain(q, k_cache, v_cache, k_stage, v_stage,
                                              k_cur, v_cur, scalars)
    dev = build.require_cuda("decode_attention_layered", q, k_cache, v_cache, k_stage,
                             v_stage, k_cur, v_cur)
    if scalars.device != dev or not scalars.is_contiguous():
        raise ValueError("decode_attention_layered: scalars must be contiguous on the card")
    for t in (q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention_layered: kernel takes bf16, got {t.dtype}")
    Hkv = W // D
    lib = build.load()
    nsplit = lib.zvt_decode_attention_nsplit(T)
    part = torch.empty((B, Hkv, nsplit, Hq // Hkv, D + 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    rc = lib.zvt_decode_attention_layered(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_stage.data_ptr(),
        v_stage.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(), scalars.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, STAGE, D,
        build.stream_handle(dev),
    )
    build.check_status("decode_attention_layered", rc)
    build.LAUNCHES["decode_attention"] += 1
    return out
