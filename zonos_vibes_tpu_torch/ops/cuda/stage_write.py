"""In-place stage splices: the CUDA kernels' wrappers and their plain versions.

Counterparts of ``zonos_vibes_tpu/ops/pallas/stage_write.py::
stage_splice_pallas``: each decode step writes its fresh K (or V) columns of
every layer into slot ``slot`` of the time-major stage ``[L, B, STAGE, W]``,
in place, touching no other byte; and of ``stage_splice_rows_pallas``, the
pool's ring write, where row ``b`` lands in its own slot ``slots[b]``. The
kernels (``csrc/stage_write.cu``) read the slots from device int32 tensors.
"""

from __future__ import annotations

import torch

from . import build


def stage_splice_plain(stage, cols, slot) -> torch.Tensor:
    stage[:, :, int(slot)] = cols
    return stage


def stage_splice(stage: torch.Tensor, cols: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``stage[:, :, slot, :] = cols`` in place; returns ``stage``.

    ``stage [L, B, STAGE, W]``, ``cols [L, B, W]`` of the same dtype,
    ``slot`` a one-element int32 tensor with ``0 <= slot < STAGE`` (the
    kernel writes nothing for a slot out of range). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    L, B, STAGE, W = stage.shape
    if cols.shape != (L, B, W) or cols.dtype != stage.dtype:
        raise ValueError("stage_splice: cols must be [L, B, W] of the stage's dtype")
    if slot.numel() != 1 or slot.dtype != torch.int32:
        raise ValueError("stage_splice: slot must be one int32 element")
    if stage.device.type == "cpu":
        return stage_splice_plain(stage, cols, slot)
    dev = build.require_cuda("stage_splice", stage, cols)
    if slot.device != dev:
        raise ValueError("stage_splice: slot must lie on the stage's device")
    row_bytes = W * stage.element_size()
    if row_bytes % 16:
        raise ValueError("stage_splice: a stage row must be a multiple of 16 bytes")
    rc = build.load().zvt_stage_splice(
        stage.data_ptr(), cols.data_ptr(), slot.data_ptr(), L * B, STAGE, row_bytes,
        build.stream_handle(dev),
    )
    build.check_status("stage_splice", rc)
    build.LAUNCHES["stage_splice"] += 1
    return stage


def stage_splice_rows_plain(stage, cols, slots) -> torch.Tensor:
    """Rows whose slot lies outside ``[0, STAGE)`` are left untouched, as in
    the kernel."""
    valid = (slots >= 0) & (slots < stage.shape[2])
    rows = torch.arange(stage.shape[1], device=stage.device)[valid.to(stage.device)]
    stage[:, rows, slots.to(stage.device)[rows].long()] = cols[:, rows]
    return stage


def stage_splice_rows(stage: torch.Tensor, cols: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """``stage[:, b, slots[b], :] = cols[:, b, :]`` for every row ``b``, in
    place; returns ``stage``.

    ``stage [L, B, STAGE, W]``, ``cols [L, B, W]`` of the same dtype,
    ``slots`` int32 ``[B]`` (a row whose slot is outside ``[0, STAGE)`` is
    not written). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.
    """
    L, B, STAGE, W = stage.shape
    if cols.shape != (L, B, W) or cols.dtype != stage.dtype:
        raise ValueError("stage_splice_rows: cols must be [L, B, W] of the stage's dtype")
    if slots.shape != (B,) or slots.dtype != torch.int32:
        raise ValueError("stage_splice_rows: slots must be int32 [B]")
    if stage.device.type == "cpu":
        return stage_splice_rows_plain(stage, cols, slots)
    dev = build.require_cuda("stage_splice_rows", stage, cols)
    if slots.device != dev or not slots.is_contiguous():
        raise ValueError("stage_splice_rows: slots must be contiguous on the stage's device")
    row_bytes = W * stage.element_size()
    if row_bytes % 16:
        raise ValueError("stage_splice_rows: a stage row must be a multiple of 16 bytes")
    rc = build.load().zvt_stage_splice_rows(
        stage.data_ptr(), cols.data_ptr(), slots.data_ptr(), L * B, B, STAGE, row_bytes,
        build.stream_handle(dev),
    )
    build.check_status("stage_splice_rows", rc)
    build.LAUNCHES["stage_splice_rows"] += 1
    return stage
