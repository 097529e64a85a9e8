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
The kernel splits the contraction over blocks; their partials meet in an
fp32 workspace (allocated per call) under one int32 counter per output tile
(a zeroed buffer kept per device, which the kernel leaves zeroed).
"""

from __future__ import annotations

import functools

import torch

from . import build

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_COUNTERS: dict[torch.device, torch.Tensor] = {}


@functools.cache
def _plan(M: int, K: int, N: int, G: int) -> tuple[int, int]:
    """(output tiles, workspace floats) of a launch."""
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
    tiles, ws_floats = _plan(M, K, N, G)
    ws = torch.empty((max(ws_floats, 1),), dtype=torch.float32, device=dev)
    rc = build.load().zvt_qmm_int8(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
        _counters(dev, tiles).data_ptr(), M, K, N, G, int(out_dtype == torch.float32),
        build.stream_handle(dev),
    )
    build.check_status("qmm_int8", rc)
    build.LAUNCHES["qmm_int8"] += 1
    return out
