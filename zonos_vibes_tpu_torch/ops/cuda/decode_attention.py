"""Single-query decode attention: the CUDA kernels' wrappers and their plain
versions.

Counterparts of ``zonos_vibes_tpu/ops/pallas/decode_attention.py::
decode_attention_pallas_layered`` and ``decode_attention_pallas_layered_q``.
For layer ``layer`` of the stacked cache they attend over three parts: the
flushed prefix ``[0, flushed_end)`` of the time-major cache (bf16, or int8
with per-(position, kv head) scales), the first ``stage_len`` rows of the
time-major stage, and the current token's column. The kernels
(``csrc/decode_attention.cu``) read the three scalars from a device int32
tensor, so the launch does not depend on host values.

The pool's counterparts, ``decode_attention_pallas_pooled_staged`` and
``decode_attention_pallas_pooled_staged_q``, are the same kernels with a
``(flushed_end, stage_len)`` pair per row: row ``b`` attends its prefix
``[0, bases[b])``, its ring stage rows ``[0, lens[b])`` and its column.

The stage-less counterparts, ``decode_attention_pallas`` (every row attends
``[0, seq_end)`` of one layer, its current column already written: the
hybrid backbone's solo decode) and ``decode_attention_pallas_pooled`` (row
``b`` attends ``[0, prefix_ends[b])`` and its current column: the pooled
decode of either backbone on a cache without a ring), are the same kernels
with no stage rows. Every kernel takes head dim 64 or 128.
"""

from __future__ import annotations

import torch

from ..attention import decode_attention
from ..quant import dequantize_rows
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
    tensors launch the kernel (bf16, D = 64 or 128) or raise.
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


def decode_attention_layered_q_plain(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                                     k_cur, v_cur, scalars) -> torch.Tensor:
    """Dense reference: the layer's prefix dequantized to fp32, the stage
    rows and the current column widened to fp32, attention in fp32 with the
    probabilities kept fp32 (as the Pallas ``_kernel_layered_q`` does)."""
    flushed_end, stage_len, layer = (int(x) for x in scalars.tolist())
    k = torch.cat([dequantize_rows(k_cache[layer, :, :flushed_end],
                                   k_scale[layer, :, :flushed_end]),
                   k_stage[layer, :, :stage_len].float(), k_cur.float()[:, None]], dim=1)
    v = torch.cat([dequantize_rows(v_cache[layer, :, :flushed_end],
                                   v_scale[layer, :, :flushed_end]),
                   v_stage[layer, :, :stage_len].float(), v_cur.float()[:, None]], dim=1)
    return decode_attention(q, k, v, flushed_end + stage_len + 1)


def decode_attention_layered_q(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                               k_cur, v_cur, scalars) -> torch.Tensor:
    """Decode attention for one layer of the stacked int8 cache.

    Counterpart of ``decode_attention_pallas_layered_q``. As
    :func:`decode_attention_layered`, but ``k_cache``/``v_cache`` are int8
    ``[L, B, T, Hkv*D]`` with fp32 per-(position, kv head) scales
    ``k_scale``/``v_scale`` ``[L, B, T, Hkv]``; key scales multiply the
    scores after q.k, value scales the probabilities before p.v. The stage
    and the current column are exact (bf16 on the card). Only positions below
    ``flushed_end`` of the prefix and its scales are read. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
    """
    B, S, Hq, D = q.shape
    L, Bc, T, W = k_cache.shape
    STAGE = k_stage.shape[2]
    Hkv = max(W // D, 1)
    if (S != 1 or Bc != B or W != Hkv * D or Hq % Hkv or v_cache.shape != k_cache.shape
            or k_scale.shape != (L, B, T, Hkv) or v_scale.shape != k_scale.shape
            or k_stage.shape != (L, B, STAGE, W) or v_stage.shape != k_stage.shape
            or k_cur.shape != (B, W) or v_cur.shape != k_cur.shape
            or scalars.shape != (3,) or scalars.dtype != torch.int32):
        raise ValueError("decode_attention_layered_q: inconsistent shapes")
    if (k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("decode_attention_layered_q: int8 cache and fp32 scales expected")
    if q.device.type == "cpu":
        return decode_attention_layered_q_plain(q, k_cache, v_cache, k_scale, v_scale,
                                                k_stage, v_stage, k_cur, v_cur, scalars)
    dev = build.require_cuda("decode_attention_layered_q", q, k_cache, v_cache, k_scale,
                             v_scale, k_stage, v_stage, k_cur, v_cur)
    if scalars.device != dev or not scalars.is_contiguous():
        raise ValueError("decode_attention_layered_q: scalars must be contiguous on the card")
    for t in (q, k_stage, v_stage, k_cur, v_cur):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention_layered_q: kernel takes a bf16 query and "
                             f"stage, got {t.dtype}")
    lib = build.load()
    nsplit = lib.zvt_decode_attention_nsplit(T)
    part = torch.empty((B, Hkv, nsplit, Hq // Hkv, D + 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    rc = lib.zvt_decode_attention_layered_q(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), k_stage.data_ptr(), v_stage.data_ptr(), k_cur.data_ptr(),
        v_cur.data_ptr(), scalars.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, T, STAGE, D, build.stream_handle(dev),
    )
    build.check_status("decode_attention_layered_q", rc)
    build.LAUNCHES["decode_attention_q"] += 1
    return out


def _pooled_bounds(bases, lens, T: int, STAGE: int):
    """Per-row ``(flushed_end, stage_len)`` on the host, clamped to the
    buffers as the kernel clamps them."""
    return [(min(max(int(b), 0), T), min(max(int(n), 0), STAGE))
            for b, n in zip(bases.tolist(), lens.tolist())]


def decode_attention_pooled_staged_plain(q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur,
                                         bases, lens, layer: int) -> torch.Tensor:
    """Dense reference: for each row gather its prefix, ring rows and column
    and attend over them (as :func:`decode_attention_layered_plain`)."""
    outs = []
    for b, (fe, sl) in enumerate(_pooled_bounds(bases, lens, k_cache.shape[2],
                                                k_stage.shape[2])):
        k = torch.cat([k_cache[layer, b, :fe], k_stage[layer, b, :sl], k_cur[b, None]])
        v = torch.cat([v_cache[layer, b, :fe], v_stage[layer, b, :sl], v_cur[b, None]])
        outs.append(decode_attention(q[b, None], k[None], v[None], fe + sl + 1))
    return torch.cat(outs)


def decode_attention_pooled_staged_q_plain(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                           v_stage, k_cur, v_cur, bases, lens,
                                           layer: int) -> torch.Tensor:
    """Dense reference per row: the prefix dequantized to fp32, ring rows and
    column widened to fp32, attention in fp32 with the probabilities kept
    fp32 (as the Pallas ``_kernel_pooled_staged_q`` does)."""
    outs = []
    for b, (fe, sl) in enumerate(_pooled_bounds(bases, lens, k_cache.shape[2],
                                                k_stage.shape[2])):
        k = torch.cat([dequantize_rows(k_cache[layer, b, :fe], k_scale[layer, b, :fe]),
                       k_stage[layer, b, :sl].float(), k_cur[b, None].float()])
        v = torch.cat([dequantize_rows(v_cache[layer, b, :fe], v_scale[layer, b, :fe]),
                       v_stage[layer, b, :sl].float(), v_cur[b, None].float()])
        outs.append(decode_attention(q[b, None], k[None], v[None], fe + sl + 1))
    return torch.cat(outs)


def _check_pooled(name, q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur, bases, lens,
                  layer):
    B, S, Hq, D = q.shape
    L, Bc, T, W = k_cache.shape
    STAGE = k_stage.shape[2]
    Hkv = max(W // D, 1)
    if (S != 1 or Bc != B or W != Hkv * D or Hq % Hkv or v_cache.shape != k_cache.shape
            or k_stage.shape != (L, B, STAGE, W) or v_stage.shape != k_stage.shape
            or k_cur.shape != (B, W) or v_cur.shape != k_cur.shape
            or bases.shape != (B,) or lens.shape != (B,)
            or bases.dtype != torch.int32 or lens.dtype != torch.int32):
        raise ValueError(f"{name}: inconsistent shapes")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    return B, Hq, Hkv, T, STAGE, D


def _launch_pooled(name, entry, launch_key, q, tensors, bases, lens, dims, layer):
    """Allocates the split partials and the output, launches ``entry`` on
    ``q``'s device and counts the launch."""
    B, Hq, Hkv, T, STAGE, D = dims
    dev = build.require_cuda(name, q, *tensors)
    for t in (bases, lens):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: bases and lens must be contiguous on the card")
    lib = build.load()
    nsplit = lib.zvt_decode_attention_nsplit(T)
    part = torch.empty((B, Hkv, nsplit, Hq // Hkv, D + 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    rc = getattr(lib, entry)(
        q.data_ptr(), *(t.data_ptr() for t in tensors), bases.data_ptr(), lens.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, STAGE, D, layer,
        build.stream_handle(dev),
    )
    build.check_status(name, rc)
    build.LAUNCHES[launch_key] += 1
    return out


def decode_attention_pooled_staged(q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur,
                                   bases, lens, layer: int) -> torch.Tensor:
    """Pooled decode attention for layer ``layer`` of the stacked cache.

    Args:
      q: ``[B, 1, Hq, D]``.
      k_cache, v_cache: ``[L, B, T, Hkv*D]`` flushed prefixes (read only).
      k_stage, v_stage: ``[L, B, STAGE, Hkv*D]`` per-row ring stages.
      k_cur, v_cur: ``[B, Hkv*D]`` this step's columns.
      bases: int32 ``[B]``, row ``b``'s flushed watermark: it attends prefix
        positions ``[0, bases[b])`` and nothing of the prefix past them.
      lens: int32 ``[B]``, row ``b``'s valid ring rows ``[0, lens[b])``.
      layer: host int in ``[0, L)``.
    Returns ``[B, 1, Hq, D]``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16, D = 64 or 128) or raise.
    """
    dims = _check_pooled("decode_attention_pooled_staged", q, k_cache, v_cache, k_stage,
                         v_stage, k_cur, v_cur, bases, lens, layer)
    if q.device.type == "cpu":
        return decode_attention_pooled_staged_plain(q, k_cache, v_cache, k_stage, v_stage,
                                                    k_cur, v_cur, bases, lens, layer)
    tensors = (k_cache, v_cache, k_stage, v_stage, k_cur, v_cur)
    for t in (q, *tensors):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention_pooled_staged: kernel takes bf16, got {t.dtype}")
    return _launch_pooled("decode_attention_pooled_staged", "zvt_decode_attention_pooled",
                          "decode_attention_pooled", q, tensors, bases, lens, dims, layer)


def decode_attention_pooled_staged_q(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                                     k_cur, v_cur, bases, lens, layer: int) -> torch.Tensor:
    """Pooled decode attention over an int8 prefix.

    Counterpart of ``decode_attention_pallas_pooled_staged_q``. As
    :func:`decode_attention_pooled_staged`, but ``k_cache``/``v_cache`` are
    int8 ``[L, B, T, Hkv*D]`` with fp32 per-(position, kv head) scales
    ``k_scale``/``v_scale`` ``[L, B, T, Hkv]`` (key scales multiply the
    scores after q.k, value scales the probabilities before p.v); the ring
    stages and the columns are exact (bf16 on the card). Nothing of the
    prefix or its scales at or past ``bases[b]`` is read. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
    """
    dims = _check_pooled("decode_attention_pooled_staged_q", q, k_cache, v_cache, k_stage,
                         v_stage, k_cur, v_cur, bases, lens, layer)
    B, _, Hkv, T, _, _ = dims
    L = k_cache.shape[0]
    if (k_scale.shape != (L, B, T, Hkv) or v_scale.shape != k_scale.shape
            or k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("decode_attention_pooled_staged_q: int8 cache and fp32 scales "
                         "[L, B, T, Hkv] expected")
    if q.device.type == "cpu":
        return decode_attention_pooled_staged_q_plain(q, k_cache, v_cache, k_scale, v_scale,
                                                      k_stage, v_stage, k_cur, v_cur, bases,
                                                      lens, layer)
    for t in (q, k_stage, v_stage, k_cur, v_cur):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention_pooled_staged_q: kernel takes a bf16 query "
                             f"and stage, got {t.dtype}")
    tensors = (k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, k_cur, v_cur)
    return _launch_pooled("decode_attention_pooled_staged_q", "zvt_decode_attention_pooled_q",
                          "decode_attention_pooled_q", q, tensors, bases, lens, dims, layer)


def decode_attention_unstaged_plain(q, k_cache, v_cache, seq_end, layer: int) -> torch.Tensor:
    """Dense reference over layer ``layer``'s positions ``[0, seq_end)``
    (clamped to the cache, as the kernel clamps it)."""
    n = min(max(int(seq_end.item()), 0), k_cache.shape[2])
    return decode_attention(q, k_cache[layer, :, :n], v_cache[layer, :, :n], n)


def decode_attention_unstaged(q, k_cache, v_cache, seq_end, layer: int) -> torch.Tensor:
    """Decode attention over one layer of a cache without a stage.

    Counterpart of ``decode_attention_pallas``. Every row attends positions
    ``[0, seq_end)`` of layer ``layer``; the current token's column is
    already written at ``seq_end - 1``. Nothing at or past ``seq_end`` is
    read.

    Args:
      q: ``[B, 1, Hq, D]``.
      k_cache, v_cache: ``[L, B, T, Hkv*D]``.
      seq_end: int32 ``[1]`` on the cache's device.
      layer: host int in ``[0, L)``.
    Returns ``[B, 1, Hq, D]``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16, D = 64 or 128) or raise.
    """
    B, S, Hq, D = q.shape
    L, Bc, T, W = k_cache.shape
    Hkv = max(W // D, 1)
    if (S != 1 or Bc != B or W != Hkv * D or Hq % Hkv or v_cache.shape != k_cache.shape
            or seq_end.shape != (1,) or seq_end.dtype != torch.int32):
        raise ValueError("decode_attention_unstaged: inconsistent shapes")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attention_unstaged: layer {layer} outside [0, {L})")
    if q.device.type == "cpu":
        return decode_attention_unstaged_plain(q, k_cache, v_cache, seq_end, layer)
    dev = build.require_cuda("decode_attention_unstaged", q, k_cache, v_cache)
    if seq_end.device != dev:
        raise ValueError("decode_attention_unstaged: seq_end must be on the card")
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention_unstaged: kernel takes bf16, got {t.dtype}")
    lib = build.load()
    nsplit = lib.zvt_decode_attention_nsplit(T)
    part = torch.empty((B, Hkv, nsplit, Hq // Hkv, D + 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    rc = lib.zvt_decode_attention_unstaged(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), seq_end.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, D, layer, build.stream_handle(dev))
    build.check_status("decode_attention_unstaged", rc)
    build.LAUNCHES["decode_attention_unstaged"] += 1
    return out


def decode_attention_pooled_unstaged_plain(q, k_cache, v_cache, k_cur, v_cur, prefix_ends,
                                           layer: int) -> torch.Tensor:
    """Dense reference per row: its prefix ``[0, prefix_ends[b])`` (clamped
    to the cache, as the kernel clamps it) and its column."""
    T = k_cache.shape[2]
    outs = []
    for b, pe in enumerate(prefix_ends.tolist()):
        pe = min(max(int(pe), 0), T)
        k = torch.cat([k_cache[layer, b, :pe], k_cur[b, None]])
        v = torch.cat([v_cache[layer, b, :pe], v_cur[b, None]])
        outs.append(decode_attention(q[b, None], k[None], v[None], pe + 1))
    return torch.cat(outs)


def decode_attention_pooled_unstaged(q, k_cache, v_cache, k_cur, v_cur, prefix_ends,
                                     layer: int) -> torch.Tensor:
    """Pooled decode attention for layer ``layer`` of a cache without a stage.

    Counterpart of ``decode_attention_pallas_pooled``: row ``b`` attends its
    own prefix ``[0, prefix_ends[b])`` and its current column, folded in at
    the end. Nothing of the prefix at or past ``prefix_ends[b]`` is read; the
    caller writes the column at ``prefix_ends[b]`` afterwards.

    Args:
      q: ``[B, 1, Hq, D]``.
      k_cache, v_cache: ``[L, B, T, Hkv*D]`` (read only).
      k_cur, v_cur: ``[B, Hkv*D]`` this step's columns.
      prefix_ends: int32 ``[B]`` on the cache's device.
      layer: host int in ``[0, L)``.
    Returns ``[B, 1, Hq, D]``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16, D = 64 or 128) or raise.
    """
    B, S, Hq, D = q.shape
    L, Bc, T, W = k_cache.shape
    Hkv = max(W // D, 1)
    if (S != 1 or Bc != B or W != Hkv * D or Hq % Hkv or v_cache.shape != k_cache.shape
            or k_cur.shape != (B, W) or v_cur.shape != k_cur.shape
            or prefix_ends.shape != (B,) or prefix_ends.dtype != torch.int32):
        raise ValueError("decode_attention_pooled_unstaged: inconsistent shapes")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attention_pooled_unstaged: layer {layer} outside [0, {L})")
    if q.device.type == "cpu":
        return decode_attention_pooled_unstaged_plain(q, k_cache, v_cache, k_cur, v_cur,
                                                      prefix_ends, layer)
    dev = build.require_cuda("decode_attention_pooled_unstaged", q, k_cache, v_cache, k_cur,
                             v_cur)
    if prefix_ends.device != dev or not prefix_ends.is_contiguous():
        raise ValueError("decode_attention_pooled_unstaged: prefix_ends must be contiguous "
                         "on the card")
    for t in (q, k_cache, v_cache, k_cur, v_cur):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention_pooled_unstaged: kernel takes bf16, got "
                             f"{t.dtype}")
    lib = build.load()
    nsplit = lib.zvt_decode_attention_nsplit(T)
    part = torch.empty((B, Hkv, nsplit, Hq // Hkv, D + 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    rc = lib.zvt_decode_attention_pooled_unstaged(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_cur.data_ptr(),
        v_cur.data_ptr(), prefix_ends.data_ptr(), part.data_ptr(), out.data_ptr(), B, Hq, Hkv,
        T, D, layer, build.stream_handle(dev))
    build.check_status("decode_attention_pooled_unstaged", rc)
    build.LAUNCHES["decode_attention_pooled_unstaged"] += 1
    return out
