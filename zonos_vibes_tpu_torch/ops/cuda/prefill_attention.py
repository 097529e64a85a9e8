"""Causal prefill attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``zonos_vibes_tpu/ops/pallas/prefill_attention.py::
prefill_attention_pallas``: causal GQA flash-attention of a chunk of ``S``
queries at ``offset`` in one layer of the time-major cache. The JAX package
takes its kernel only for chunks of 512 or more on a TPU; the port sends
every prefill on the card through ``csrc/prefill_attention.cu``.

The launch plans its row tiles for the SM count of the card it runs on
(:func:`_sm_count`, as the decode-attention and int8 plans do), and the
kernel sets its shared-memory attribute once per device.
"""

from __future__ import annotations

import functools

import torch

from ..attention import prefill_attention as prefill_attention_plain
from . import build

__all__ = ["prefill_attention", "prefill_attention_plain"]


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      offset: int) -> torch.Tensor:
    """Query ``i`` (absolute ``offset + i``) attends ``[0, offset + i]``.

    ``q [B, S, Hq, D]``, caches ``[B, T, Hkv*D]`` holding the chunk at
    ``[offset, offset + S)``; cache rows at or past ``offset + S`` are never
    read. Returns ``[B, S, Hq, D]``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16, D = 64 or 128) or raise.
    """
    B, S, Hq, D = q.shape
    Bc, T, W = k_cache.shape
    if (Bc != B or W % D or Hq % (W // D) or v_cache.shape != k_cache.shape
            or S < 1 or offset < 0 or offset + S > T):
        raise ValueError("prefill_attention: inconsistent shapes or offset")
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_cache, v_cache, offset)
    dev = build.require_cuda("prefill_attention", q, k_cache, v_cache)
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"prefill_attention: kernel takes bf16, got {t.dtype}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):  # the kernel's attribute flag is the current device's
        rc = build.load().zvt_prefill_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            B, S, Hq, W // D, T, D, int(offset), _sm_count(dev), build.stream_handle(dev),
        )
    build.check_status("prefill_attention", rc)
    build.LAUNCHES["prefill_attention"] += 1
    return out
