"""Single-query decode attention: the CUDA kernel's wrappers and their plain
versions.

Counterparts of ``zonos_vibes_tpu/ops/pallas/decode_attention.py::
decode_attention_pallas_layered`` and ``decode_attention_pallas_layered_q``.
For layer ``layer`` of the stacked cache they attend over three parts: the
flushed prefix ``[0, flushed_end)`` of the time-major cache (bf16, or int8
with per-(position, kv head) scales), the first ``stage_len`` rows of the
time-major stage, and the current token's column. The kernel
(``csrc/decode_attention.cu``) reads the three scalars from a device int32
tensor, so the launch does not depend on host values; it clamps
``flushed_end`` to ``[0, T]`` and ``stage_len`` to ``[0, STAGE]``, and for a
layer outside ``[0, L)`` reads nothing and writes NaN.

The pool's counterparts, ``decode_attention_pallas_pooled_staged`` and
``decode_attention_pallas_pooled_staged_q``, are the same kernel with a
``(flushed_end, stage_len)`` pair per row: row ``b`` attends its prefix
``[0, bases[b])``, its ring stage rows ``[0, lens[b])`` and its column.

The stage-less counterparts, ``decode_attention_pallas`` (every row attends
``[0, seq_end)`` of one layer, its current column already written: the
hybrid backbone's solo decode) and ``decode_attention_pallas_pooled`` (row
``b`` attends ``[0, prefix_ends[b])`` and its current column: the pooled
decode of either backbone on a cache without a ring), are the same kernel
with no stage rows. Every variant takes head dim 64 or 128.

Each call is one launch: the kernel's split blocks meet in a per-device fp32
workspace under one int32 ticket per (row, kv head), which the last block
resets. Both are reused across calls, so every launch must stay on one
stream (the caller's current one), as ``qmm_int8``'s counters must.

The staged variants also do the decode step's stage write
(``stage_splice_pallas`` / ``stage_splice_rows_pallas``, which the JAX
package runs after the layer scan) for this call's layer, in the kernel's
block that already holds the column (``csrc/decode_attention.cu``) with no
launch of its own: ``stage[layer, :, stage_len] = column`` for the
one-position variants, ``stage[layer, b, lens[b]] = column[b]`` for the
pooled ones, from the unclamped device scalars; a slot outside
``[0, STAGE)`` is not written. The columns may be strided row views (the
last dimension contiguous, rows 16-byte aligned), such as the V slice of
the fused qkv projection's output.
"""

from __future__ import annotations

import functools

import torch

from ..attention import decode_attention
from ..quant import dequantize_rows
from . import build
from .stage_write import stage_splice_plain, stage_splice_rows_plain

# Split lengths the plan picks from, longest first; the kernel's tiles are 32
# positions and its merge holds at most MAX_SPLITS splits of a row. The plan
# takes the longest that still puts BLOCKS_PER_SM blocks on each SM, else
# the shortest within MAX_SPLITS. A split holds at most SPLIT_DIMS position
# dims (128 positions at head dim 64, 64 at 128): a pool's rows at mid depth
# leave most splits empty, and the few active blocks then set the time by
# their serial tiles. On an H100 (tools/time_torch_kernels.py --chunks), the
# 8-slot pool's bf16 call at bases 112-434 took 0.0200 ms with 256-position
# splits, 0.0172 with 128 and 0.0196 with 64 at head dim 64 (near 3000
# positions: 0.059, 0.064, 0.076), and the hybrid's at head dim 128 0.0248,
# 0.0197 and 0.0170.
CHUNKS = (128, 64, 32)
SPLIT_DIMS = 128 * 64
MAX_SPLITS = 64
SMS = 132  # the H100 SXM's; a launch plans for its own card's count
BLOCKS_PER_SM = 2
_WORKSPACES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def decode_plan(T: int, stage: int, B: int, Hkv: int, D: int,
                sms: int = SMS) -> tuple[int, int, int]:
    """``(chunk, n_prefix_splits, n_stage_splits)`` of a launch over a cache of
    ``T`` positions and a stage of ``stage`` rows (0: none) at head dim
    ``D`` on a card of ``sms`` SMs, from the shapes alone: ``ceil(T /
    chunk)`` prefix splits and ``ceil(stage / chunk)`` stage splits, one
    block each per (row, kv head)."""
    def splits(chunk):
        return -(-T // chunk), -(-stage // chunk)

    chunks = [c for c in CHUNKS if c * D <= SPLIT_DIMS] or [CHUNKS[-1]]
    fitting = [c for c in chunks if sum(splits(c)) <= MAX_SPLITS]
    if not fitting:  # a cache deeper than MAX_SPLITS * chunks[0]
        chunk = chunks[0]
        while sum(splits(chunk)) > MAX_SPLITS:
            chunk += 32
        fitting = [chunk]
    for chunk in fitting:
        if sum(splits(chunk)) * B * Hkv >= BLOCKS_PER_SM * sms:
            break
    return (chunk, *splits(chunk))


def _workspace(dev: torch.device, floats: int, pairs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's split workspace and zeroed tickets, grown on demand."""
    ws, tickets = _WORKSPACES.get(dev, (None, None))
    if ws is None or ws.numel() < floats or tickets.numel() < pairs:
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32, device=dev)
        tickets = torch.zeros(max(pairs, 1024), dtype=torch.int32, device=dev)
        _WORKSPACES[dev] = ws, tickets
    return ws, tickets


def _row_stride(name: str, col: torch.Tensor | None, dev: torch.device) -> int:
    """The row stride, in elements, of a column ``[B, W]`` on ``dev``: its
    last dimension contiguous and every row 16-byte aligned, for the
    kernel's 16-byte copies."""
    if col is None:
        return 0
    if col.device != dev:
        raise ValueError(f"{name}: tensors must share one CUDA device, got {col.device}")
    stride = col.stride(0) if col.shape[0] > 1 else col.shape[1]
    if col.stride(1) != 1 or stride < col.shape[1] or stride % 8 or col.data_ptr() % 16:
        raise ValueError(f"{name}: a column must be rows of contiguous elements at a stride "
                         f"of a multiple of 8, 16-byte aligned; got strides {col.stride()}")
    return stride


def _launch(name: str, launch_key: str, *, quant: bool, pooled: bool, q, k_cache, v_cache,
            k_scale=None, v_scale=None, k_stage=None, v_stage=None, k_cur=None, v_cur=None,
            scalars, lens=None, layer: int = 0) -> torch.Tensor:
    """Launches the kernel for ``q [B, 1, Hq, D]`` on ``q``'s device and
    counts the launch. ``scalars`` (and ``lens``) are device int32 tensors;
    ``k_cur``/``v_cur`` may be strided row views."""
    B, _, Hq, D = q.shape
    L, _, T, W = k_cache.shape
    Hkv = W // D
    staged = k_stage is not None
    STAGE = k_stage.shape[2] if staged else 0
    if quant and STAGE < 1:
        raise ValueError(f"{name}: the int8 kernels take a stage of at least one row")
    tensors = [t for t in (k_cache, v_cache, k_scale, v_scale, k_stage, v_stage) if t is not None]
    dev = build.require_cuda(name, q, *tensors)
    k_stride, v_stride = _row_stride(name, k_cur, dev), _row_stride(name, v_cur, dev)
    exact = [q, k_stage, v_stage, k_cur, v_cur] + ([] if quant else [k_cache, v_cache])
    for t in exact:
        if t is not None and t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: kernel takes a bf16 query, cache, stage and column "
                             f"(int8 prefix aside), got {t.dtype}")
    for t in (scalars, lens):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name}: device scalars must be contiguous on the card")
    chunk, n_prefix, n_stage = decode_plan(T, STAGE, B, Hkv, D, _sm_count(dev))
    ws, tickets = _workspace(dev, B * Hkv * (n_prefix + n_stage) * (Hq // Hkv) * (D + 2),
                             B * Hkv)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = build.load().zvt_decode_attention(
        int(quant), int(pooled), int(staged), q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), ptr(k_scale), ptr(v_scale), ptr(k_stage), ptr(v_stage), ptr(k_cur),
        ptr(v_cur), scalars.data_ptr(), ptr(lens), ws.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, L, T, STAGE, D, layer, chunk, n_prefix, n_stage, k_stride,
        v_stride, build.stream_handle(dev))
    build.check_status(name, rc)
    build.LAUNCHES[launch_key] += 1
    return out


def _layered_bounds(scalars, T: int, STAGE: int, L: int, name: str) -> tuple[int, int, int]:
    """``(flushed_end, stage_len, layer)`` on the host, clamped to the buffers
    as the kernel clamps them; a layer outside ``[0, L)`` raises (the kernel
    writes NaN for it)."""
    flushed_end, stage_len, layer = (int(x) for x in scalars.tolist())
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    return min(max(flushed_end, 0), T), min(max(stage_len, 0), STAGE), layer


def _write_stage_plain(k_stage, v_stage, k_cur, v_cur, layer: int, slot: int) -> None:
    """The one-position stage write's plain version: ``stage_splice_plain``
    on layer ``layer``'s plane; a slot outside ``[0, STAGE)`` writes
    nothing, as in the kernel."""
    if 0 <= slot < k_stage.shape[2]:
        for stage, col in ((k_stage, k_cur), (v_stage, v_cur)):
            stage_splice_plain(stage[layer:layer + 1], col[None], slot)


def _write_rows_plain(k_stage, v_stage, k_cur, v_cur, layer: int, lens) -> None:
    """The pooled stage write's plain version: ``stage_splice_rows_plain``
    on layer ``layer``'s plane (row ``b`` at slot ``lens[b]``)."""
    for stage, col in ((k_stage, k_cur), (v_stage, v_cur)):
        stage_splice_rows_plain(stage[layer:layer + 1], col[None], lens)


def decode_attention_layered_plain(q, k_cache, v_cache, k_stage, v_stage, k_cur,
                                   v_cur, scalars) -> torch.Tensor:
    """Dense reference: gather the three parts and attend over all of them;
    then the stage write."""
    flushed_end, stage_len, layer = _layered_bounds(scalars, k_cache.shape[2], k_stage.shape[2],
                                                    k_cache.shape[0], "decode_attention_layered")
    k = torch.cat([k_cache[layer, :, :flushed_end], k_stage[layer, :, :stage_len],
                   k_cur[:, None]], dim=1)
    v = torch.cat([v_cache[layer, :, :flushed_end], v_stage[layer, :, :stage_len],
                   v_cur[:, None]], dim=1)
    out = decode_attention(q, k, v, flushed_end + stage_len + 1)
    _write_stage_plain(k_stage, v_stage, k_cur, v_cur, layer, int(scalars[1]))
    return out


def decode_attention_layered(q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur,
                             scalars) -> torch.Tensor:
    """Decode attention for one layer of the stacked cache, and the stage
    write of its column.

    Args:
      q: ``[B, 1, Hq, D]``.
      k_cache, v_cache: ``[L, B, T, Hkv*D]`` flushed prefix (read only).
      k_stage, v_stage: ``[L, B, STAGE, Hkv*D]`` unflushed tail.
      k_cur, v_cur: ``[B, Hkv*D]`` this step's column (row views allowed).
      scalars: int32 ``[3]``: ``(flushed_end, stage_len, layer)``.
    The column is also stored at ``stage[layer, :, stage_len]`` (unclamped;
    nothing outside ``[0, STAGE)``). Returns ``[B, 1, Hq, D]``. CPU tensors
    take the plain version; CUDA tensors launch the kernel (bf16, D = 64 or
    128) or raise.
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
    return _launch("decode_attention_layered", "decode_attention", quant=False, pooled=False,
                   q=q, k_cache=k_cache, v_cache=v_cache, k_stage=k_stage, v_stage=v_stage,
                   k_cur=k_cur, v_cur=v_cur, scalars=scalars)


def decode_attention_layered_q_plain(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                                     k_cur, v_cur, scalars) -> torch.Tensor:
    """Dense reference: the layer's prefix dequantized to fp32, the stage
    rows and the current column widened to fp32, attention in fp32 with the
    probabilities kept fp32 (as the Pallas ``_kernel_layered_q`` does); then
    the stage write."""
    flushed_end, stage_len, layer = _layered_bounds(scalars, k_cache.shape[2], k_stage.shape[2],
                                                    k_cache.shape[0], "decode_attention_layered_q")
    k = torch.cat([dequantize_rows(k_cache[layer, :, :flushed_end],
                                   k_scale[layer, :, :flushed_end]),
                   k_stage[layer, :, :stage_len].float(), k_cur.float()[:, None]], dim=1)
    v = torch.cat([dequantize_rows(v_cache[layer, :, :flushed_end],
                                   v_scale[layer, :, :flushed_end]),
                   v_stage[layer, :, :stage_len].float(), v_cur.float()[:, None]], dim=1)
    out = decode_attention(q, k, v, flushed_end + stage_len + 1)
    _write_stage_plain(k_stage, v_stage, k_cur, v_cur, layer, int(scalars[1]))
    return out


def decode_attention_layered_q(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                               k_cur, v_cur, scalars) -> torch.Tensor:
    """Decode attention for one layer of the stacked int8 cache.

    Counterpart of ``decode_attention_pallas_layered_q``. As
    :func:`decode_attention_layered`, but ``k_cache``/``v_cache`` are int8
    ``[L, B, T, Hkv*D]`` with fp32 per-(position, kv head) scales
    ``k_scale``/``v_scale`` ``[L, B, T, Hkv]``; key scales multiply the
    scores after q.k, value scales the probabilities before p.v. The stage
    and the current column are exact (bf16 on the card). Only positions below
    ``flushed_end`` of the prefix and its scales are read; the stage write
    as there. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.
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
    return _launch("decode_attention_layered_q", "decode_attention_q", quant=True, pooled=False,
                   q=q, k_cache=k_cache, v_cache=v_cache, k_scale=k_scale, v_scale=v_scale,
                   k_stage=k_stage, v_stage=v_stage, k_cur=k_cur, v_cur=v_cur, scalars=scalars)


def _pooled_bounds(bases, lens, T: int, STAGE: int):
    """Per-row ``(flushed_end, stage_len)`` on the host, clamped to the
    buffers as the kernel clamps them."""
    return [(min(max(int(b), 0), T), min(max(int(n), 0), STAGE))
            for b, n in zip(bases.tolist(), lens.tolist())]


def decode_attention_pooled_staged_plain(q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur,
                                         bases, lens, layer: int) -> torch.Tensor:
    """Dense reference: for each row gather its prefix, ring rows and column
    and attend over them (as :func:`decode_attention_layered_plain`); then
    the stage write."""
    outs = []
    for b, (fe, sl) in enumerate(_pooled_bounds(bases, lens, k_cache.shape[2],
                                                k_stage.shape[2])):
        k = torch.cat([k_cache[layer, b, :fe], k_stage[layer, b, :sl], k_cur[b, None]])
        v = torch.cat([v_cache[layer, b, :fe], v_stage[layer, b, :sl], v_cur[b, None]])
        outs.append(decode_attention(q[b, None], k[None], v[None], fe + sl + 1))
    _write_rows_plain(k_stage, v_stage, k_cur, v_cur, layer, lens)
    return torch.cat(outs)


def decode_attention_pooled_staged_q_plain(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                           v_stage, k_cur, v_cur, bases, lens,
                                           layer: int) -> torch.Tensor:
    """Dense reference per row: the prefix dequantized to fp32, ring rows and
    column widened to fp32, attention in fp32 with the probabilities kept
    fp32 (as the Pallas ``_kernel_pooled_staged_q`` does); then the stage
    write."""
    outs = []
    for b, (fe, sl) in enumerate(_pooled_bounds(bases, lens, k_cache.shape[2],
                                                k_stage.shape[2])):
        k = torch.cat([dequantize_rows(k_cache[layer, b, :fe], k_scale[layer, b, :fe]),
                       k_stage[layer, b, :sl].float(), k_cur[b, None].float()])
        v = torch.cat([dequantize_rows(v_cache[layer, b, :fe], v_scale[layer, b, :fe]),
                       v_stage[layer, b, :sl].float(), v_cur[b, None].float()])
        outs.append(decode_attention(q[b, None], k[None], v[None], fe + sl + 1))
    _write_rows_plain(k_stage, v_stage, k_cur, v_cur, layer, lens)
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


def decode_attention_pooled_staged(q, k_cache, v_cache, k_stage, v_stage, k_cur, v_cur,
                                   bases, lens, layer: int) -> torch.Tensor:
    """Pooled decode attention for layer ``layer`` of the stacked cache, and
    the stage write of each row's column.

    Args:
      q: ``[B, 1, Hq, D]``.
      k_cache, v_cache: ``[L, B, T, Hkv*D]`` flushed prefixes (read only).
      k_stage, v_stage: ``[L, B, STAGE, Hkv*D]`` per-row ring stages.
      k_cur, v_cur: ``[B, Hkv*D]`` this step's columns (row views allowed).
      bases: int32 ``[B]``, row ``b``'s flushed watermark: it attends prefix
        positions ``[0, bases[b])`` and nothing of the prefix past them.
      lens: int32 ``[B]``, row ``b``'s valid ring rows ``[0, lens[b])``.
      layer: host int in ``[0, L)``.
    Row ``b``'s column is also stored at ``stage[layer, b, lens[b]]``
    (unclamped; nothing outside ``[0, STAGE)``). Returns ``[B, 1, Hq, D]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, D = 64 or 128) or raise.
    """
    _check_pooled("decode_attention_pooled_staged", q, k_cache, v_cache, k_stage, v_stage,
                  k_cur, v_cur, bases, lens, layer)
    if q.device.type == "cpu":
        return decode_attention_pooled_staged_plain(q, k_cache, v_cache, k_stage, v_stage,
                                                    k_cur, v_cur, bases, lens, layer)
    return _launch("decode_attention_pooled_staged", "decode_attention_pooled", quant=False,
                   pooled=True, q=q, k_cache=k_cache, v_cache=v_cache, k_stage=k_stage,
                   v_stage=v_stage, k_cur=k_cur, v_cur=v_cur, scalars=bases, lens=lens,
                   layer=layer)


def decode_attention_pooled_staged_q(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                                     k_cur, v_cur, bases, lens, layer: int) -> torch.Tensor:
    """Pooled decode attention over an int8 prefix.

    Counterpart of ``decode_attention_pallas_pooled_staged_q``. As
    :func:`decode_attention_pooled_staged`, but ``k_cache``/``v_cache`` are
    int8 ``[L, B, T, Hkv*D]`` with fp32 per-(position, kv head) scales
    ``k_scale``/``v_scale`` ``[L, B, T, Hkv]`` (key scales multiply the
    scores after q.k, value scales the probabilities before p.v); the ring
    stages and the columns are exact (bf16 on the card). Nothing of the
    prefix or its scales at or past ``bases[b]`` is read; the stage write as
    there. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.
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
    return _launch("decode_attention_pooled_staged_q", "decode_attention_pooled_q", quant=True,
                   pooled=True, q=q, k_cache=k_cache, v_cache=v_cache, k_scale=k_scale,
                   v_scale=v_scale, k_stage=k_stage, v_stage=v_stage, k_cur=k_cur, v_cur=v_cur,
                   scalars=bases, lens=lens, layer=layer)


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
    return _launch("decode_attention_unstaged", "decode_attention_unstaged", quant=False,
                   pooled=False, q=q, k_cache=k_cache, v_cache=v_cache, scalars=seq_end,
                   layer=layer)


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
    return _launch("decode_attention_pooled_unstaged", "decode_attention_pooled_unstaged",
                   quant=False, pooled=True, q=q, k_cache=k_cache, v_cache=v_cache, k_cur=k_cur,
                   v_cur=v_cur, scalars=prefix_ends, layer=layer)
