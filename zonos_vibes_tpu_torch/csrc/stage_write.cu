// In-place stage splices: stage[:, :, slot, :] = cols[:, :, :] for every
// (layer, batch row) plane, or with a slot per batch row (the pool's ring
// write), stage[:, b, slots[b], :] = cols[:, b, :].
//
// Replaces: zonos_vibes_tpu/ops/pallas/stage_write.py::stage_splice_pallas
//   (an aliased TPU kernel that rewrites the one 8-row sublane tile holding
//   the slot in each plane, so the stage is not copied every decode step)
//   and stage_splice_rows_pallas (the same, one grid step per batch row,
//   with the row's slot from scalar prefetch).
//
// What bounds it on the H100: the launch. The bytes are one row of
// Hkv * 64 bf16 per plane read from cols and written to the stage: at the
// flagship (26 layers, CFG batch 2, row of 1 KB) that is 53 KB each way per
// call, a few hundredths of a microsecond at 3.35 TB/s, against a few
// microseconds to launch any kernel. The pool's per-row splice moves
// 26 x 16 rows of 1 KB each way at 8 slots: 0.25 us of bytes.
//
// What the design does about it: nothing can make a lone launch cheaper, so
// the kernel stays minimal. One block per plane copies the row with 16-byte
// loads and stores, touches no other byte of the stage, and reads the slot
// from device memory so the launch is fit for graph capture. A slot outside
// [0, stage_depth) writes nothing; callers keep it in range by construction.
// The per-row kernel is the same copy; plane (l, b) reads slots[b].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_splice_kernel(uint4* __restrict__ stage, const uint4* __restrict__ cols,
                                    const int* __restrict__ slot, int stage_depth,
                                    int row_vecs) {
  const int s = *slot;
  if (s < 0 || s >= stage_depth) return;
  const size_t plane = blockIdx.x;
  uint4* dst = stage + (plane * stage_depth + s) * row_vecs;
  const uint4* src = cols + plane * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

__global__ void stage_splice_rows_kernel(uint4* __restrict__ stage,
                                         const uint4* __restrict__ cols,
                                         const int* __restrict__ slots, int rows,
                                         int stage_depth, int row_vecs) {
  const size_t plane = blockIdx.x;  // layer * rows + row
  const int s = slots[plane % rows];
  if (s < 0 || s >= stage_depth) return;
  uint4* dst = stage + (plane * stage_depth + s) * row_vecs;
  const uint4* src = cols + plane * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

int splice_threads(int row_vecs) {
  return row_vecs < 256 ? ((row_vecs + 31) / 32) * 32 : 256;
}

}  // namespace

// row_bytes must be a multiple of 16 and both buffers 16-byte aligned.
extern "C" int zvt_stage_splice(void* stage, const void* cols, const void* slot, int planes,
                                int stage_depth, int row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || planes <= 0) return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  stage_splice_kernel<<<planes, splice_threads(row_vecs), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(stage), static_cast<const uint4*>(cols),
      static_cast<const int*>(slot), stage_depth, row_vecs);
  return (int)cudaGetLastError();
}

// planes = layers * rows; slots is device int32 [rows].
extern "C" int zvt_stage_splice_rows(void* stage, const void* cols, const void* slots,
                                     int planes, int rows, int stage_depth, int row_bytes,
                                     void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || rows <= 0 || planes <= 0 || planes % rows != 0)
    return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  stage_splice_rows_kernel<<<planes, splice_threads(row_vecs), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(stage), static_cast<const uint4*>(cols),
      static_cast<const int*>(slots), rows, stage_depth, row_vecs);
  return (int)cudaGetLastError();
}
