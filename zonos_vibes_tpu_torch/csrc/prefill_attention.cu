// Causal GQA flash-attention for a prefill chunk already written into one
// layer of the time-major KV cache.
//
// Replaces: zonos_vibes_tpu/ops/pallas/prefill_attention.py::
//   prefill_attention_pallas (a TPU grid (B, Hq, nQ, nK) with the key-block
//   axis innermost, causal block pruning through a clamped index map and the
//   fp32 online softmax in VMEM scratch).
//
// What bounds it on the H100: at the lengths the text path gives it (tens
// to a few hundred positions) neither bytes nor flops are near the card's
// limits; the work is small and the launch and the serial key loop set the
// time. At long chunks the score and value products (4 * S * T * 64 flops
// per query head, half of them pruned) would be the limit.
//
// What the design does about it:
//  * One block per (tile of 32 query rows, kv head, batch row). A query row
//    is one (position, head of the group) pair, so the G query heads of a
//    group share every K/V tile loaded into shared memory.
//  * Key tiles of 32 positions are walked in order up to the last one the
//    tile's highest position may attend; rows skip tiles wholly above their
//    own diagonal.
//  * Each warp owns 8 query rows. For a tile, lane j scores key j against
//    the row (the K tile's rows are padded to 65 floats so the 32 lanes hit
//    32 banks), the warp reduces the max and sum with shuffles, and lane d
//    accumulates output dims d and d + 32 from the shuffled probabilities.
//    Running max, sum and accumulator stay in fp32 registers.
//  * Plain CUDA cores, no tensor cores: simple and right first.
//
// Layouts (row-major, bf16): q [B, S, Hq, 64], k and v [B, T, Hkv * 64]
// (one layer of the cache), out [B, S, Hq, 64].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HEAD_DIM = 64;
constexpr int ROWS = 32;
constexpr int KEYS = 32;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int Hkv,
    int G, int T, int offset, float scale) {
  __shared__ float q_sm[ROWS][HEAD_DIM];
  __shared__ float k_sm[KEYS][HEAD_DIM + 1];
  __shared__ float v_sm[KEYS][HEAD_DIM];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = Hkv * G;
  const int W = Hkv * HEAD_DIM;
  const int total_rows = S * G;
  const int row0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < ROWS * HEAD_DIM; e += THREADS) {
    const int r = e / HEAD_DIM;
    const int d = e % HEAD_DIM;
    const int row = row0 + r;
    float val = 0.f;
    if (row < total_rows) {
      const int pos = row / G;
      const int g = row % G;
      val = __bfloat162float(q[(((size_t)b * S + pos) * Hq + h * G + g) * HEAD_DIM + d]) * scale;
    }
    q_sm[r][d] = val;
  }

  const int last_row = min(row0 + ROWS, total_rows) - 1;
  const int max_pos = offset + last_row / G;
  const int n_tiles = max_pos / KEYS + 1;

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc0[ROWS_PER_WARP], acc1[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();
    for (int e = threadIdx.x; e < KEYS * HEAD_DIM; e += THREADS) {
      const int j = e / HEAD_DIM;
      const int d = e % HEAD_DIM;
      const int t = tile * KEYS + j;
      float kv = 0.f, vv = 0.f;
      if (t < T) {
        const size_t idx = ((size_t)b * T + t) * W + h * HEAD_DIM + d;
        kv = __bfloat162float(k[idx]);
        vv = __bfloat162float(v[idx]);
      }
      k_sm[j][d] = kv;
      v_sm[j][d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int lr = warp * ROWS_PER_WARP + r;
      const int row = row0 + lr;
      if (row >= total_rows) continue;
      const int qpos = offset + row / G;
      // Tile 0 always holds key 0 <= qpos, so m is finite after it and a
      // fully masked later tile contributes exp(-inf) = 0.
      if (tile * KEYS > qpos) continue;
      const int key = tile * KEYS + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HEAD_DIM; ++d) s = fmaf(q_sm[lr][d], k_sm[lane][d], s);
      if (key > qpos) s = -INFINITY;
      const float mn = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - mn);
      const float p = expf(s - mn);
      l[r] = l[r] * alpha + warp_sum(p);
      float a0 = acc0[r] * alpha;
      float a1 = acc1[r] * alpha;
#pragma unroll 8
      for (int j = 0; j < KEYS; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        a0 = fmaf(pj, v_sm[j][lane], a0);
        a1 = fmaf(pj, v_sm[j][lane + 32], a1);
      }
      acc0[r] = a0;
      acc1[r] = a1;
      m[r] = mn;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + warp * ROWS_PER_WARP + r;
    if (row >= total_rows) continue;
    const int pos = row / G;
    const int g = row % G;
    __nv_bfloat16* o = out + (((size_t)b * S + pos) * Hq + h * G + g) * HEAD_DIM;
    const float inv = 1.f / l[r];
    o[lane] = __float2bfloat16(acc0[r] * inv);
    o[lane + 32] = __float2bfloat16(acc1[r] * inv);
  }
}

}  // namespace

extern "C" int zvt_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int Hq, int Hkv, int T, int head_dim,
                                     int offset, void* stream) {
  if (head_dim != HEAD_DIM || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || offset < 0 ||
      offset + S > T)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const dim3 grid((S * G + ROWS - 1) / ROWS, Hkv, B);
  prefill_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Hkv, G, T,
      offset, 1.0f / sqrtf((float)HEAD_DIM));
  return (int)cudaGetLastError();
}
