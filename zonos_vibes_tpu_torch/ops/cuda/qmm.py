"""int8 and packed-int4 weight-streaming matmuls: the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``zonos_vibes_tpu/ops/pallas/qmm.py::qmm_int8_pallas``:
``x @ W_int8`` with fp32 accumulation, the per-output-channel fp32 scale
applied to the fp32 product, and one rounding to the output type. The JAX
package leaves this to XLA, which fuses the int8 -> bf16 convert into the
dot on the TPU; on the card no library call multiplies bf16 activations by
int8 weights without first writing a bf16 copy of the weights, so the port's
``ops/quant.proj_matmul`` and its int8 heads run ``csrc/qmm_int8.cu``.

One launch covers ``G`` weights of one shape against the same ``x``: ``G = 1``
for a projection, ``G = 9`` for the nine heads in their ``[K, D, V]`` layout.
At ``M <= 2`` (the solo decode step) a block walks a long stretch of the
contraction for a narrow tile of columns, and only a contraction too long
for one block is split between the blocks of a thread-block cluster, whose
partials meet in distributed shared memory (:func:`decode_plan`): nothing
is allocated but the output, and nothing is kept between calls. At
``M > 2`` (tensor cores) the splits' partials meet in an fp32 workspace
(allocated per call) under one int32 counter per output tile (a zeroed
buffer kept per device, which the kernel leaves zeroed), so those launches
must stay on one stream.

``qmm_int4`` (``csrc/qmm_int4.cu``) is the counterpart of the XLA ``s4`` dot
of the JAX package's ``ops/quant.proj_matmul`` (not a Pallas kernel):
``x @ W_int4`` with the weight packed two values to a byte (``uint8 [K, N /
2]``, the even column in the low nibble, two's complement in [-7, 7]) and
fp32 scales per group of ``K / NG`` rows and column (``[NG, 1, N]``; NG = 1
for an ungrouped weight). The kernel runs on the tensor cores (``mma.sync``,
the packed weight widened to bf16 in registers): each group's products are
summed in fp32 and multiplied by the group's scale, the groups (and the
splits of K, which meet in a thread-block cluster) summed in fp32 in a fixed
order, and the result rounds once. The plain version
(:func:`qmm_int4_plain`) scales each finished group sum: the two differ by
fp32 rounding only. :func:`int4_plan` fits the row tile to M (x as mma's n8
operand up to 8 rows, its m16 operand beyond) and sizes the splits from the
shapes and the SM count; nothing is allocated but the output.
"""

from __future__ import annotations

import functools

import torch

from . import build

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_COUNTERS: dict[torch.device, torch.Tensor] = {}

# The M <= 2 kernel's plan, from sweeps of tile width, cluster size and
# ring depth at the decode shapes on an H100 (`PERF.md`, row 4): a block
# does best walking up to BLOCK_BYTES of weights; clusters, which split a
# tile's rows between blocks, only where a tile's rows exceed that (a
# cluster launch costs scheduling time); and the narrowest tile that keeps
# the grid within MAX_PER_SM blocks per SM.
TILES = (32, 64)
MAX_CLUSTER = 8
SMS = 132  # the H100 SXM's; a launch plans for its own card's count
MAX_PER_SM = 3
BLOCK_BYTES = 128 * 1024
STAGE_BYTES = 4096

# The int4 kernel's plan (`csrc/qmm_int4.cu`): a block is 2 tn / 32 warps over
# tn columns (one of INT4_TILES) and a tile of bm rows of x: 8 where x is
# mma's n8 operand (M <= INT4_XB_M), 16 or 64 where it is the m16 operand
# (one row tile up to 16 rows, four beyond). Tiles of 128 columns unless even
# clusters of MAX_CLUSTER blocks would leave SMs idle; K is then split inside
# a cluster, in whole stages of INT4_BK rows, until the grid holds a block
# per SM, while each split keeps at least INT4_MIN_ROWS rows. From a sweep of
# every row tile, tile width and cluster size at the int4 shapes on an H100
# (`tools/sweep_decode_plans.py --only qmm4`, `PERF.md`, the `qmm_int4` row):
# within 5% of the best plan at every shape at M = 2-16, and within 7% at the
# prefill's M; splitting on to two blocks per SM or more was slower at every M.
INT4_XB_M = 8
INT4_TILES = (64, 128, 256)
INT4_BK = 64
INT4_MIN_ROWS = 256


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def decode_plan(M: int, K: int, N: int, G: int, sms: int = SMS) -> tuple[int, int, int]:
    """``(tile width, cluster size, rows per block)`` of an ``M <= 2`` launch on
    a card of ``sms`` SMs, from the shapes alone: ``G * ceil(N / tile)``
    clusters of ``cluster`` blocks, block ``r`` of a cluster summing rows
    ``[r * rows, (r + 1) * rows)`` of ``K`` (a multiple of a stage's rows)."""
    if not 0 < M <= 2:
        raise ValueError(f"decode_plan: M must be 1 or 2, got {M}")
    tn = next((t for t in TILES if -(-N // t) * G <= MAX_PER_SM * sms), TILES[-1])
    cs = 1
    while cs < MAX_CLUSTER and tn * -(-K // cs) > BLOCK_BYTES:
        cs *= 2
    stage_rows = STAGE_BYTES // tn
    per_block = -(-K // cs)
    return tn, cs, -(-per_block // stage_rows) * stage_rows


def int4_plan(M: int, K: int, N: int, sms: int = SMS) -> tuple[int, int, int, int]:
    """``(rows of x per block, tile width, cluster size, rows of K per block)``
    of a ``qmm_int4`` launch on a card of ``sms`` SMs: ``ceil(M / bm) *
    ceil(N / tile)`` clusters of ``cluster`` blocks, block ``r`` of a cluster
    summing rows ``[r * rows, (r + 1) * rows)`` of ``K`` (whole stages), no
    block of a cluster without rows. A pure function of its arguments."""
    if M <= 0 or K <= 0 or N <= 0:
        raise ValueError(f"int4_plan: positive shapes expected, got {(M, K, N)}")
    bm = 8 if M <= INT4_XB_M else 16 if M <= 16 else 64
    tiles = -(-M // bm)
    tn = INT4_TILES[1]
    if -(-N // tn) * tiles * MAX_CLUSTER < sms:
        tn = INT4_TILES[0]
    cs = 1
    while (cs < MAX_CLUSTER and -(-N // tn) * tiles * cs < sms
           and K // (2 * cs) >= INT4_MIN_ROWS):
        cs *= 2
    per_block = -(-K // cs)
    rows = -(-per_block // INT4_BK) * INT4_BK
    return bm, tn, -(-K // rows), rows


@functools.cache
def _plan(M: int, K: int, N: int, G: int, sms: int) -> tuple[int, int]:
    """(output tiles, workspace floats) of an ``M > 2`` launch."""
    lib = build.load()
    return (lib.zvt_qmm_int8_tiles(M, K, N, G, sms),
            lib.zvt_qmm_int8_workspace(M, K, N, G, sms))


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = c
    return c


def qmm_int8_plain(x, w, scale, out_dtype) -> torch.Tensor:
    """The same arithmetic in PyTorch: an fp32 product of ``x`` and the
    widened int8 weight (every bf16 x int8 product is exact in fp32), the
    scale on the fp32 result, one rounding."""
    y = torch.einsum("mk,gkn->mgn", x.float(), w.float())
    return (y * scale[:, 0]).to(out_dtype)


def qmm_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``out[m, g] = (x[m] @ w[g]) * scale[g]``.

    Args:
      x: ``[M, K]`` activations.
      w: ``[G, K, N]`` int8 weights.
      scale: ``[G, 1, N]`` fp32 per-output-channel scales.
      out_dtype: bf16 or fp32 (default: ``x.dtype``).
    Returns ``[M, G, N]``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``x`` bf16, ``N`` a multiple of 16) or raise.
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"qmm_int8: x [M, K] and w [G, K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    G, K, N = w.shape
    M = x.shape[0]
    if w.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (G, 1, N):
        raise ValueError("qmm_int8: w must be int8 and scale fp32 [G, 1, N]")
    if out_dtype not in _OUT_DTYPES or not x.dtype.is_floating_point:
        raise ValueError(f"qmm_int8: float x and a bf16 or fp32 output expected, got "
                         f"{x.dtype} -> {out_dtype}")
    if x.device.type == "cpu":
        return qmm_int8_plain(x, w, scale, out_dtype)
    dev = build.require_cuda("qmm_int8", x, w, scale)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"qmm_int8: kernel takes bf16 x, got {x.dtype}")
    if N % 16:
        raise ValueError(f"qmm_int8: kernel takes N a multiple of 16, got {N}")
    out = torch.empty((M, G, N), dtype=out_dtype, device=dev)
    out_f32 = int(out_dtype == torch.float32)
    sms = _sm_count(dev)
    if M <= 2:
        rc = build.load().zvt_qmm_int8_decode(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, G, out_f32,
            *decode_plan(M, K, N, G, sms), build.stream_handle(dev))
    else:
        tiles, ws_floats = _plan(M, K, N, G, sms)
        ws = torch.empty((max(ws_floats, 1),), dtype=torch.float32, device=dev)
        rc = build.load().zvt_qmm_int8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
            _counters(dev, tiles).data_ptr(), M, K, N, G, out_f32, sms,
            build.stream_handle(dev))
    build.check_status("qmm_int8", rc)
    build.LAUNCHES["qmm_int8"] += 1
    return out


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] ``[..., N]`` (N even) -> ``uint8 [..., N / 2]``,
    column ``2j`` in the low nibble of byte ``j``, ``2j + 1`` in the high."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4: an even last axis expected, got {tuple(q.shape)}")
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(w: torch.Tensor) -> torch.Tensor:
    """``uint8 [..., N / 2]`` -> the int8 values ``[..., N]`` (:func:`pack_int4`'s
    inverse)."""
    nib = torch.stack([w & 0xF, w >> 4], dim=-1).flatten(-2).to(torch.int8)
    return nib - 16 * (nib >= 8).to(torch.int8)


def qmm_int4_plain(x, w, scale, out_dtype) -> torch.Tensor:
    """The same function in PyTorch: per group, the fp32 product of ``x``'s
    slice and the unpacked weight (every bf16 x int4 product is exact in
    fp32), times the group's scale; the groups summed in fp32; one rounding.
    (The kernel scales partials over slices of a group instead: fp32
    rounding apart, the same sum.)"""
    q = unpack_int4(w).float()  # [K, N]
    NG, K, N = scale.shape[0], q.shape[0], q.shape[1]
    y = torch.einsum("mgk,gkn->mgn", x.float().reshape(-1, NG, K // NG),
                     q.reshape(NG, K // NG, N))
    return (y * scale[:, 0]).sum(dim=1).to(out_dtype)


def qmm_int4(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``out[m] = sum_g (x[m, group g] @ q[group g]) * scale[g]``.

    Args:
      x: ``[M, K]`` activations.
      w: ``uint8 [K, N / 2]`` packed int4 weights (:func:`pack_int4`).
      scale: ``[NG, 1, N]`` fp32 scales of NG groups of ``K / NG`` rows.
      out_dtype: bf16 or fp32 (default: ``x.dtype``).
    Returns ``[M, N]``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``x`` bf16, ``N`` a multiple of 32) or raise.
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"qmm_int4: x [M, K] and w [K, N/2] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = 2 * w.shape[1]
    if (w.dtype != torch.uint8 or scale.dtype != torch.float32 or scale.ndim != 3
            or scale.shape[1:] != (1, N) or K % scale.shape[0]):
        raise ValueError(f"qmm_int4: w must be uint8 and scale fp32 [NG, 1, {N}] with NG "
                         f"dividing K = {K}, got {w.dtype}, {scale.dtype} {tuple(scale.shape)}")
    if out_dtype not in _OUT_DTYPES or not x.dtype.is_floating_point:
        raise ValueError(f"qmm_int4: float x and a bf16 or fp32 output expected, got "
                         f"{x.dtype} -> {out_dtype}")
    if all(t.device.type == "cpu" for t in (x, w, scale)):
        return qmm_int4_plain(x, w, scale, out_dtype)
    dev = build.require_cuda("qmm_int4", x, w, scale)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"qmm_int4: kernel takes bf16 x, got {x.dtype}")
    if N % 32:
        raise ValueError(f"qmm_int4: kernel takes N a multiple of 32 (a 16-byte row copy), "
                         f"got {N}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    rc = build.load().zvt_qmm_int4(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, scale.shape[0],
        int(out_dtype == torch.float32), *int4_plan(M, K, N, _sm_count(dev)),
        build.stream_handle(dev))
    build.check_status("qmm_int4", rc)
    build.LAUNCHES["qmm_int4"] += 1
    return out
