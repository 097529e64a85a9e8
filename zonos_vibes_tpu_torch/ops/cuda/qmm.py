"""int8 weight-streaming matmul: the CUDA kernel's wrapper and its plain
version.

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
SMS = 132
MAX_PER_SM = 3
BLOCK_BYTES = 128 * 1024
STAGE_BYTES = 4096


def decode_plan(M: int, K: int, N: int, G: int) -> tuple[int, int, int]:
    """``(tile width, cluster size, rows per block)`` of an ``M <= 2`` launch,
    from the shapes alone: ``G * ceil(N / tile)`` clusters of ``cluster``
    blocks, block ``r`` of a cluster summing rows ``[r * rows, (r + 1) *
    rows)`` of ``K`` (a multiple of a stage's rows)."""
    if not 0 < M <= 2:
        raise ValueError(f"decode_plan: M must be 1 or 2, got {M}")
    tn = next((t for t in TILES if -(-N // t) * G <= MAX_PER_SM * SMS), TILES[-1])
    cs = 1
    while cs < MAX_CLUSTER and tn * -(-K // cs) > BLOCK_BYTES:
        cs *= 2
    stage_rows = STAGE_BYTES // tn
    per_block = -(-K // cs)
    return tn, cs, -(-per_block // stage_rows) * stage_rows


@functools.cache
def _plan(M: int, K: int, N: int, G: int) -> tuple[int, int]:
    """(output tiles, workspace floats) of an ``M > 2`` launch."""
    lib = build.load()
    return lib.zvt_qmm_int8_tiles(M, K, N, G), lib.zvt_qmm_int8_workspace(M, K, N, G)


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
    if M <= 2:
        rc = build.load().zvt_qmm_int8_decode(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, G, out_f32,
            *decode_plan(M, K, N, G), build.stream_handle(dev))
    else:
        tiles, ws_floats = _plan(M, K, N, G)
        ws = torch.empty((max(ws_floats, 1),), dtype=torch.float32, device=dev)
        rc = build.load().zvt_qmm_int8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
            _counters(dev, tiles).data_ptr(), M, K, N, G, out_f32, build.stream_handle(dev))
    build.check_status("qmm_int8", rc)
    build.LAUNCHES["qmm_int8"] += 1
    return out
