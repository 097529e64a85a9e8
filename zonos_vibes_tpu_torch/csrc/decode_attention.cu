// Single-query GQA flash-decode for one layer of the stacked KV cache, with a
// bf16 or an int8 flushed prefix, with or without a stage, for one sequence
// position shared by every row or for per-row positions (the
// continuous-batching pool), at head dim 64 or 128.
//
// Replaces: zonos_vibes_tpu/ops/pallas/decode_attention.py::
//   decode_attention_pallas_layered (a TPU grid (B, nT) that walks the
//   time-minor cache block by block in order, carries the online softmax in
//   VMEM scratch, and folds the stage and the current column into the last
//   grid step), and decode_attention_pallas_layered_q, the same kernel over
//   an int8 prefix with fp32 per-(position, kv head) scales: key scales
//   multiply the scores after q.k, value scales the probabilities before
//   p.v. The stage and the current column stay exact bf16 in both.
//   Also decode_attention_pallas_pooled_staged and
//   decode_attention_pallas_pooled_staged_q, the pool's versions: row b
//   attends its own flushed prefix [0, base_b), the first len_b rows of its
//   own ring stage and its current column. The pool's ring stage is the
//   same [L, B, STAGE, W] buffer as the solo stage (ring slot pos - base),
//   so they are the same kernels with per-row (flushed_end, stage_len).
//   And the two kernels without a stage: decode_attention_pallas (plain
//   flash-decode over [0, seq_end) of one layer, the current column already
//   written: the hybrid backbone's solo decode) and
//   decode_attention_pallas_pooled (row b attends [0, prefix_end_b) and its
//   current column, folded in at the end: the stage-less pooled decode of
//   either backbone). They are the same kernels with no stage rows.
//
// What bounds it on the H100: device-memory bytes. One call must read the
// flushed prefix [0, flushed_end) and the stage rows [0, stage_len) of one
// layer, K and V, B * Hkv * D bf16 values per position, plus the current
// column. It does 4 * Hq * D flops per position, about one flop per byte,
// far below the ~295 flops per byte where the tensor cores become the limit.
// At 5 s of audio the bytes are ~1 MB a layer, so the launch itself dominates.
// The int8 prefix halves the prefix bytes and adds 8 bytes of scales per
// position and kv head. In the 8-slot pool (B = 16 CFG rows) near a
// 3000-position prefix one layer's call reads ~98 MB (bf16) or ~52 MB
// (int8 and scales): 29 us or 16 us at 3.35 TB/s.
//
// What the design does about it (flash-decoding):
//  * One block per (split, kv head, batch row): the G query heads of a group
//    share every K/V load. B * Hkv is only 16 at CFG batch 2, so the flushed
//    prefix is also cut into fixed chunks of CHUNK positions, one block each,
//    to put enough blocks on the 132 SMs at 30 s depth. The last split takes
//    the stage rows and the current column (nothing, for the plain
//    stage-less kernel, whose current column is in the prefix).
//  * The grid depends only on the cache length T, never on flushed_end or
//    stage_len, which are read from device memory: the launch is fit for
//    graph capture. Chunks at or past flushed_end return at once, so the
//    padded tail of the cache is never read. With per-row positions
//    (template flag POOLED) a block reads its row's (base_b, len_b) from two
//    device int32 [B] tensors and the layer is a launch argument; a chunk at
//    or past base_b writes a neutral partial (the empty max, sum 0) and
//    reads nothing, so rows at different depths share one launch.
//  * Inside a block every warp holds 32 / (D / 8) independent decoders
//    (4 at D = 64, 2 at D = 128): a lane holds 8 of the D dims of one
//    position (one 16-byte load of K and of V), a few shuffles finish a dot
//    product, and each decoder keeps its own fp32 running max, sum and
//    accumulator. The decoders of a block merge in shared memory into one
//    partial (acc, max, sum) per query head; a second small kernel merges
//    the splits and writes bf16.
//  * The int8 variant (template flag QUANT) differs only in the prefix
//    splits: a lane loads 8 int8 values (8 bytes) of K and of V, and its
//    decoder loads the position's two fp32 scales; all math stays fp32.
//    Scales are read only for positions below flushed_end.
//
// Layouts (row-major, bf16 unless noted):
//   q       [B, Hq, D]               k_cache, v_cache [L, B, T, Hkv * D]
//   k_stage, v_stage [L, B, STAGE, Hkv * D]
//   int8 variant: k_cache, v_cache int8 [L, B, T, Hkv * D],
//                 k_scale, v_scale fp32 [L, B, T, Hkv]
//   k_cur, v_cur [B, Hkv * D]
//   one position for every row: scalars int32 [3]: flushed_end, stage_len,
//     layer (without a stage: [2]: seq_end, layer)
//   per-row positions: bases (prefix ends), lens int32 [B]; layer a launch
//     argument
//   part    fp32 [B, Hkv, nsplit, G, D + 2]   out [B, Hq, D]

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int DIMS_PER_LANE = 8;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 256;
constexpr int MAX_G = 8;
// Finite sentinel for an empty running max: exp(NEG_BIG - NEG_BIG) is 1 and
// multiplies a zero sum, so merging empty states never produces NaN.
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

// D is the head dim (64 or 128). PrefixT is __nv_bfloat16 for the exact
// cache and int8_t for the int8 one (then k_scale and v_scale are read;
// otherwise they may be null). STAGED kernels attend stage rows and the
// current column in their last split; without a stage the pooled kernel
// attends only the current column there and the one-position kernel nothing
// (its scalars are (seq_end)). Without POOLED, scalars holds the position
// shared by every row and lens is unused; with POOLED, scalars holds the
// per-row bases and lens the per-row stage lengths (unused without a stage),
// clamped to the buffers. Every kernel but the staged one-position kernels
// (whose scalars carry the layer) takes the layer as layer_arg.
template <int D, int G, typename PrefixT, bool POOLED, bool STAGED>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,
    const PrefixT* __restrict__ k_cache,
    const PrefixT* __restrict__ v_cache,
    const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    const __nv_bfloat16* __restrict__ k_stage,
    const __nv_bfloat16* __restrict__ v_stage,
    const __nv_bfloat16* __restrict__ k_cur,
    const __nv_bfloat16* __restrict__ v_cur,
    const int* __restrict__ scalars,
    const int* __restrict__ lens,
    float* __restrict__ part,
    int B, int Hkv, int T, int stage_depth, int nsplit, float scale, int layer_arg) {
  constexpr bool QUANT = std::is_same<PrefixT, int8_t>::value;
  constexpr bool HAS_CUR = STAGED || POOLED;
  constexpr int LANES = D / DIMS_PER_LANE;  // lanes per position
  constexpr int ROWS_PER_WARP = 32 / LANES;
  constexpr int PART = D + 2;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int W = Hkv * D;
  int flushed_end, stage_len = 0, layer;
  if constexpr (POOLED) {
    flushed_end = min(max(scalars[b], 0), T);
    if constexpr (STAGED) stage_len = min(max(lens[b], 0), stage_depth);
    layer = layer_arg;
  } else if constexpr (STAGED) {
    flushed_end = scalars[0];
    stage_len = scalars[1];
    layer = scalars[2];
  } else {
    flushed_end = min(max(scalars[0], 0), T);
    layer = layer_arg;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / LANES;
  const int dim0 = (lane % LANES) * DIMS_PER_LANE;

  // Rows this split attends: a prefix chunk, or the stage plus the current
  // column (row index n of the last split).
  const bool prefix = split < nsplit - 1;
  int n;
  size_t row0;  // element offset of the split's first row (prefix or stage)
  size_t srow0 = 0;  // scale index of the first prefix row, this kv head
  if (prefix) {
    const int start = split * CHUNK;
    n = max(0, min(CHUNK, flushed_end - start));
    const size_t pos0 = ((size_t)layer * B + b) * (size_t)T + start;
    row0 = pos0 * W;
    srow0 = pos0 * Hkv + h;
  } else {
    n = stage_len;
    row0 = ((size_t)layer * B + b) * (size_t)stage_depth * W;
  }
  const int total = n + ((prefix || !HAS_CUR) ? 0 : 1);
  const int col = h * D + dim0;

  float qr[G][DIMS_PER_LANE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((size_t)b * Hkv * G + h * G + g) * D + dim0, qr[g]);
#pragma unroll
    for (int d = 0; d < DIMS_PER_LANE; ++d) qr[g][d] *= scale;
  }

  float m[G], l[G], acc[G][DIMS_PER_LANE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_BIG;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DIMS_PER_LANE; ++d) acc[g][d] = 0.f;
  }

  // The loop bound is the same for every lane of a warp, so the shuffles
  // below always run with the full mask; lanes past the end load nothing.
  for (int base = warp * ROWS_PER_WARP; base < total; base += WARPS * ROWS_PER_WARP) {
    const int i = base + sub;
    const bool valid = i < total;
    float kr[DIMS_PER_LANE], vr[DIMS_PER_LANE];
    float ks = 1.f, vs = 1.f;
    if (valid) {
      const size_t off = row0 + (size_t)i * W + col;
      if (prefix) {
        load8(k_cache + off, kr);
        load8(v_cache + off, vr);
        if constexpr (QUANT) {
          ks = k_scale[srow0 + (size_t)i * Hkv];
          vs = v_scale[srow0 + (size_t)i * Hkv];
        }
      } else if (STAGED && i < n) {
        load8(k_stage + off, kr);
        load8(v_stage + off, vr);
      } else {
        load8(k_cur + (size_t)b * W + col, kr);
        load8(v_cur + (size_t)b * W + col, vr);
      }
    } else {
#pragma unroll
      for (int d = 0; d < DIMS_PER_LANE; ++d) kr[d] = vr[d] = 0.f;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float acc_s = 0.f;
#pragma unroll
      for (int d = 0; d < DIMS_PER_LANE; ++d) acc_s = fmaf(qr[g][d], kr[d], acc_s);
      s[g] = acc_s;
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sg = s[g] * ks;
        const float mn = fmaxf(m[g], sg);
        const float alpha = expf(m[g] - mn);
        const float p = expf(sg - mn);
        const float pv = p * vs;
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int d = 0; d < DIMS_PER_LANE; ++d) acc[g][d] = fmaf(acc[g][d], alpha, pv * vr[d]);
        m[g] = mn;
      }
    }
  }

  // Merge the decoders of the warp (lanes with the same dims).
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int d = 0; d < DIMS_PER_LANE; ++d) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][d], off);
        acc[g][d] = acc[g][d] * a + ao * c;
      }
      m[g] = mn;
    }
  }

  // Merge the warps in shared memory and write this split's partial.
  __shared__ float sm_acc[WARPS][MAX_G][D];
  __shared__ float sm_m[WARPS][MAX_G];
  __shared__ float sm_l[WARPS][MAX_G];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int d = 0; d < DIMS_PER_LANE; ++d) sm_acc[warp][g][dim0 + d] = acc[g][d];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  float* dst = part + (((size_t)b * Hkv + h) * nsplit + split) * G * PART;
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float mx = NEG_BIG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      a += sm_acc[w][g][d] * f;
      sum += sm_l[w][g] * f;
    }
    dst[g * PART + d] = a;
    if (d == 0) {
      dst[g * PART + D] = mx;
      dst[g * PART + D + 1] = sum;
    }
  }
}

// Merges the splits of one (kv head, batch row): thread (g, d) of G * D.
template <int D>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      __nv_bfloat16* __restrict__ out,
                                      int Hkv, int G, int nsplit) {
  constexpr int PART = D + 2;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x / D;
  const int d = threadIdx.x % D;
  const float* src = part + ((size_t)b * Hkv + h) * nsplit * G * PART;
  float mx = NEG_BIG;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, src[(s * G + g) * PART + D]);
  float a = 0.f, sum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* p = src + (s * G + g) * PART;
    const float f = expf(p[D] - mx);
    a += p[d] * f;
    sum += p[D + 1] * f;
  }
  out[((size_t)b * Hkv * G + h * G + g) * D + d] = __float2bfloat16(a / sum);
}

}  // namespace

extern "C" int zvt_decode_attention_nsplit(int T) { return (T + CHUNK - 1) / CHUNK + 1; }

namespace {

template <int D, typename PrefixT, bool POOLED, bool STAGED>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* k_stage, const void* v_stage, const void* k_cur,
           const void* v_cur, const void* scalars, const void* lens, void* part, void* out,
           int B, int Hq, int Hkv, int T, int stage_depth, int layer, cudaStream_t s) {
  const int G = Hq / Hkv;
  const int nsplit = zvt_decode_attention_nsplit(T);
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(nsplit, Hkv, B);
#define ZVT_SPLIT(GV)                                                                       \
  decode_split_kernel<D, GV, PrefixT, POOLED, STAGED><<<grid, THREADS, 0, s>>>(             \
      static_cast<const __nv_bfloat16*>(q), static_cast<const PrefixT*>(k_cache),           \
      static_cast<const PrefixT*>(v_cache), static_cast<const float*>(k_scale),             \
      static_cast<const float*>(v_scale), static_cast<const __nv_bfloat16*>(k_stage),       \
      static_cast<const __nv_bfloat16*>(v_stage), static_cast<const __nv_bfloat16*>(k_cur), \
      static_cast<const __nv_bfloat16*>(v_cur), static_cast<const int*>(scalars),           \
      static_cast<const int*>(lens), static_cast<float*>(part), B, Hkv, T, stage_depth,     \
      nsplit, scale, layer)
  switch (G) {
    case 1: ZVT_SPLIT(1); break;
    case 2: ZVT_SPLIT(2); break;
    case 4: ZVT_SPLIT(4); break;
    case 8: ZVT_SPLIT(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZVT_SPLIT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<D><<<dim3(Hkv, B), G * D, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), Hkv, G, nsplit);
  return (int)cudaGetLastError();
}

// Dispatch on the head dim (64 or 128).
template <typename PrefixT, bool POOLED, bool STAGED>
int launch_any(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
               const void* v_scale, const void* k_stage, const void* v_stage, const void* k_cur,
               const void* v_cur, const void* scalars, const void* lens, void* part, void* out,
               int B, int Hq, int Hkv, int T, int stage_depth, int head_dim, int layer,
               void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64, PrefixT, POOLED, STAGED>(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                               v_stage, k_cur, v_cur, scalars, lens, part, out,
                                               B, Hq, Hkv, T, stage_depth, layer, s);
  if (head_dim == 128)
    return launch<128, PrefixT, POOLED, STAGED>(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                                v_stage, k_cur, v_cur, scalars, lens, part, out,
                                                B, Hq, Hkv, T, stage_depth, layer, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int zvt_decode_attention_layered(
    const void* q, const void* k_cache, const void* v_cache, const void* k_stage,
    const void* v_stage, const void* k_cur, const void* v_cur, const void* scalars,
    void* part, void* out, int B, int Hq, int Hkv, int T, int stage_depth,
    int head_dim, void* stream) {
  return launch_any<__nv_bfloat16, false, true>(
      q, k_cache, v_cache, nullptr, nullptr, k_stage, v_stage, k_cur, v_cur, scalars, nullptr,
      part, out, B, Hq, Hkv, T, stage_depth, head_dim, 0, stream);
}

extern "C" int zvt_decode_attention_layered_q(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* k_stage, const void* v_stage, const void* k_cur,
    const void* v_cur, const void* scalars, void* part, void* out, int B, int Hq, int Hkv,
    int T, int stage_depth, int head_dim, void* stream) {
  return launch_any<int8_t, false, true>(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                         v_stage, k_cur, v_cur, scalars, nullptr, part, out, B,
                                         Hq, Hkv, T, stage_depth, head_dim, 0, stream);
}

// Per-row positions: bases and lens are device int32 [B]; layer must lie in
// [0, L) (the wrapper checks it).
extern "C" int zvt_decode_attention_pooled(
    const void* q, const void* k_cache, const void* v_cache, const void* k_stage,
    const void* v_stage, const void* k_cur, const void* v_cur, const void* bases,
    const void* lens, void* part, void* out, int B, int Hq, int Hkv, int T, int stage_depth,
    int head_dim, int layer, void* stream) {
  return launch_any<__nv_bfloat16, true, true>(
      q, k_cache, v_cache, nullptr, nullptr, k_stage, v_stage, k_cur, v_cur, bases, lens, part,
      out, B, Hq, Hkv, T, stage_depth, head_dim, layer, stream);
}

extern "C" int zvt_decode_attention_pooled_q(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* k_stage, const void* v_stage, const void* k_cur,
    const void* v_cur, const void* bases, const void* lens, void* part, void* out, int B,
    int Hq, int Hkv, int T, int stage_depth, int head_dim, int layer, void* stream) {
  return launch_any<int8_t, true, true>(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage,
                                        k_cur, v_cur, bases, lens, part, out, B, Hq, Hkv, T,
                                        stage_depth, head_dim, layer, stream);
}

// No stage, one position: every row attends [0, seq_end) of layer `layer`,
// the current column already written there; seq_end is device int32 [1];
// layer must lie in [0, L) (the wrapper checks it).
extern "C" int zvt_decode_attention_unstaged(
    const void* q, const void* k_cache, const void* v_cache, const void* seq_end, void* part,
    void* out, int B, int Hq, int Hkv, int T, int head_dim, int layer, void* stream) {
  return launch_any<__nv_bfloat16, false, false>(
      q, k_cache, v_cache, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, seq_end,
      nullptr, part, out, B, Hq, Hkv, T, 1, head_dim, layer, stream);
}

// No stage, per-row positions: row b attends [0, prefix_ends[b]) of layer
// `layer` and its current column; prefix_ends is device int32 [B].
extern "C" int zvt_decode_attention_pooled_unstaged(
    const void* q, const void* k_cache, const void* v_cache, const void* k_cur,
    const void* v_cur, const void* prefix_ends, void* part, void* out, int B, int Hq, int Hkv,
    int T, int head_dim, int layer, void* stream) {
  return launch_any<__nv_bfloat16, true, false>(
      q, k_cache, v_cache, nullptr, nullptr, nullptr, nullptr, k_cur, v_cur, prefix_ends,
      nullptr, part, out, B, Hq, Hkv, T, 1, head_dim, layer, stream);
}
