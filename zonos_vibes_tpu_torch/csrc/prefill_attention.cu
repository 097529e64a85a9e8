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
// time. At long chunks the score and value products (4 * S * T * D flops
// per query head, half of them pruned) would be the limit.
//
// What the design does about it:
//  * One block per (tile of ROWS query rows, kv head, batch row): 32 rows at
//    head dim 64, 16 at head dim 128, so the three fp32 shared tiles (q, K
//    padded by one column, V) stay under the 48 KB of static shared memory
//    (24.3 KB and 40.5 KB). A query row is one (position, head of the group)
//    pair, so the G query heads of a group share every K/V tile loaded into
//    shared memory.
//  * Key tiles of 32 positions are walked in order up to the last one the
//    tile's highest position may attend; rows skip tiles wholly above their
//    own diagonal.
//  * Each warp owns ROWS / 4 query rows. For a tile, lane j scores key j
//    against the row (the K tile's rows are padded to D + 1 floats so the 32
//    lanes hit 32 banks), the warp reduces the max and sum with shuffles,
//    and lane d accumulates output dims d, d + 32, ... from the shuffled
//    probabilities.
//    Running max, sum and accumulator stay in fp32 registers.
//  * Plain CUDA cores, no tensor cores: simple and right first.
//
// Layouts (row-major, bf16): q [B, S, Hq, D], k and v [B, T, Hkv * D]
// (one layer of the cache), out [B, S, Hq, D]; D is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KEYS = 32;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Query rows per block at head dim D.
template <int D>
struct Rows {
  static constexpr int value = 2048 / D;
};

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

template <int HEAD_DIM>
__global__ void __launch_bounds__(THREADS) prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int Hkv,
    int G, int T, int offset, float scale) {
  constexpr int ROWS = Rows<HEAD_DIM>::value;
  constexpr int ROWS_PER_WARP = ROWS / WARPS;
  constexpr int NACC = HEAD_DIM / 32;  // output dims per lane
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

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][NACC];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int a = 0; a < NACC; ++a) acc[r][a] = 0.f;
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
      float av[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) av[a] = acc[r][a] * alpha;
#pragma unroll 8
      for (int j = 0; j < KEYS; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int a = 0; a < NACC; ++a) av[a] = fmaf(pj, v_sm[j][lane + 32 * a], av[a]);
      }
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[r][a] = av[a];
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
#pragma unroll
    for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = __float2bfloat16(acc[r][a] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Hkv,
           int G, int T, int offset, cudaStream_t s) {
  constexpr int ROWS = Rows<D>::value;
  const dim3 grid((S * G + ROWS - 1) / ROWS, Hkv, B);
  prefill_kernel<D><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Hkv, G, T,
      offset, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zvt_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int Hq, int Hkv, int T, int head_dim,
                                     int offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || offset < 0 || offset + S > T)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(q, k, v, out, B, S, Hkv, G, T, offset, s);
  if (head_dim == 128) return launch<128>(q, k, v, out, B, S, Hkv, G, T, offset, s);
  return (int)cudaErrorInvalidValue;
}
