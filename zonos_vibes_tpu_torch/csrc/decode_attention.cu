// Single-query GQA flash-decode for one layer of the stacked KV cache, with a
// bf16 or an int8 flushed prefix, with or without a stage, for one sequence
// position shared by every row or for per-row positions (the
// continuous-batching pool), at head dim 64 or 128. One launch per call.
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
//   so they are the same kernel with per-row (flushed_end, stage_len).
//   And the two kernels without a stage: decode_attention_pallas (plain
//   flash-decode over [0, seq_end) of one layer, the current column already
//   written: the hybrid backbone's solo decode) and
//   decode_attention_pallas_pooled (row b attends [0, prefix_end_b) and its
//   current column, folded in at the end: the stage-less pooled decode of
//   either backbone). They are the same kernel with no stage rows.
//
// What bounds it on the H100: device-memory bytes. One call must read the
// flushed prefix [0, flushed_end) and the stage rows [0, stage_len) of one
// layer, K and V, B * Hkv * D bf16 values per position, plus the current
// column. It does 4 * Hq * D flops per position, about one flop per byte,
// far below the ~295 flops per byte where the tensor cores become the limit.
// At 5 s of audio the bytes are ~1 MB a layer, so latency dominates: the
// launch, the depth of the dependent chain in a block, and the merge. The
// int8 prefix halves the prefix bytes and adds 8 bytes of scales per
// position and kv head. In the 8-slot pool (B = 16 CFG rows) near a
// 3000-position prefix one layer's call reads ~98 MB (bf16) or ~52 MB
// (int8 and scales): 29 us or 16 us at 3.35 TB/s.
//
// What the design does about it:
//  * One block per (split, kv head, batch row): the G query heads of a group
//    share every K/V load. The positions of a row are cut into splits of
//    `chunk` positions: ceil(T / chunk) prefix splits, then
//    ceil(STAGE / chunk) stage splits, at most 64; the current column is the
//    last row of the grid's last split. The host picks chunk from the shapes
//    alone (ops/cuda/decode_attention.py::decode_plan: the largest of 128,
//    64 and 32, at most 128 x 64 position dims, that puts two blocks on
//    each of the 132 SMs, else the shortest within 64 splits), so the
//    grid never depends on flushed_end or stage_len, which are read from
//    device memory: the launch is fit for graph capture. A split at or past
//    its row's end (and not holding the column) exits at once: every block
//    of a row derives from the same device scalars which splits are active.
//  * One launch: each active block writes its partial (acc, max, sum) to a
//    workspace; the last active block of a (row, kv head) to arrive (an
//    int32 ticket per pair, counted to the active splits) merges them in
//    split order, the threads loading the partials in parallel (the splits'
//    maxima and sums in one round into shared memory, then each output's
//    partials with many loads in flight), writes bf16
//    and resets its ticket to 0. The order of the merge does not depend on
//    which block arrives last, so the output is deterministic and a pooled
//    row's output does not depend on the other rows.
//  * Two phases per tile of 32 positions, not a serial online softmax. Each
//    warp owns query heads (warp, warp + 4, ...); in phase 1 each lane takes
//    one position of the tile and computes its full score for the head from
//    the K row in shared memory (no shuffles), with log2(e) folded into the
//    fp32 query scale; phase 2 takes the warp's max and one exp2f per
//    (position, head); phase 3 rescales each lane's D / 32 accumulated value
//    dims once per tile and adds p * v over the tile's 32 positions. A
//    block's heads never meet inside the block, so its partial needs no
//    reduction.
//  * K and V reach shared memory through a ring of 4 tiles (3 at D = 128)
//    filled by cp.async in 16-byte chunks, zero-filled past the rows' end
//    (reading nothing there), so the next tiles' loads are in flight while
//    one is reduced; rows are padded by 16 bytes so the 32 lanes reading 32
//    rows hit distinct banks. One barrier per tile hands a landed tile to
//    every warp and frees the previous slot.
//  * int8 prefix (template flag QUANT): rows of D bytes, and one thread per
//    position copies each of its two fp32 scales; the key scale multiplies
//    the score and the value scale the probability. int8 values widen to
//    fp32 by a byte permutation and one subtraction, and all math stays
//    fp32.
//  * The ticket: the block's barrier, then one thread's acq_rel atomic
//    (release of the block's partial, acquire of the others'), as CUTLASS's
//    split-K semaphore does, instead of a fence in every thread.
//  * Bounds: every kernel clamps its prefix end to [0, T] and its stage
//    length to [0, STAGE]. A layer outside [0, L) (read from the device by
//    the staged one-position kernels) reads nothing and writes NaN to the
//    output, so a bad value is seen rather than silently clamped.
//
// The stage write (every kernel with a stage): the decode step must also
// store its column into the stage slot it belongs in, which the TPU
// program does after the layer scan with a stage splice
// (stage_write.py::stage_splice_pallas and stage_splice_rows_pallas; the
// standalone counterparts stay in csrc/stage_write.cu). Here the block that
// holds the grid's last split of a (row, kv head) has already landed the
// column in shared memory, and no block of the call reads the slot: the
// one-position kernel reads stage rows [0, stage_len) and its slot is
// stage_len, a pooled row reads rows [0, lens[b]) and its slot is lens[b].
// So that block stores its D-wide slice of K and V into
// stage[layer, b, slot, h * D:(h + 1) * D] after its last tile, with no
// race and no launch of its own: on the decode step this takes the 2 * L
// column copies into a gather buffer and the two splice launches off the
// stream. What bounds it: nothing, 2 * D * 2 bytes a block (a few KB a
// call). The slot is the unclamped device scalar (scalars[1], lens[b]); a
// slot outside [0, STAGE) writes nothing, as the splice kernels, and so
// does a layer outside [0, L). The write lands before any later launch on
// the stream (the stage flush, the next step's read).
//
// Layouts (row-major, bf16 unless noted):
//   q       [B, Hq, D]               k_cache, v_cache [L, B, T, Hkv * D]
//   k_stage, v_stage [L, B, STAGE, Hkv * D]
//   int8 variant: k_cache, v_cache int8 [L, B, T, Hkv * D],
//                 k_scale, v_scale fp32 [L, B, T, Hkv]
//   k_cur, v_cur [B, Hkv * D], row b at k_cur + b * k_cur_stride (a
//     multiple of 8 elements: a view into a wider projection output)
//   one position for every row: scalars int32 [3]: flushed_end, stage_len,
//     layer (without a stage: [1]: seq_end; layer a launch argument)
//   per-row positions: bases (prefix ends), lens int32 [B]; layer a launch
//     argument
//   ws      fp32 [B, Hkv, nsplit, G, D + 2]   tickets int32 [B * Hkv], zero
//   out     [B, Hq, D]

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int DIMS_PER_LANE = 8;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;  // positions per tile: one per lane
constexpr int MAX_SPLITS = 64;  // splits of a row (bounds the host plan)

// The cp.async ring: STAGES tiles, each K then V as TILE rows of D bf16
// values padded by 16 bytes (so the 32 lanes reading 32 rows hit distinct
// banks; an int8 row uses the first D bytes of its slot), then the rows' key
// and value scales.
template <int D>
struct Ring {
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int ROW = 2 * D + 16;
  static constexpr int STAGE_BYTES = 2 * TILE * ROW + 2 * TILE * 4;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
};
constexpr float LOG2E = 1.4426950408889634f;
// Finite sentinel for an empty running max: exp2(NEG_BIG - NEG_BIG) is 1 and
// multiplies a zero sum, so merging empty states never produces NaN.
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ void bf16x8(const uint4& u, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Four int8 values packed in a word to fp32, exactly, without the
// quarter-rate integer-to-float conversion: each byte with its sign bit
// flipped becomes the low mantissa byte of 2^23, and one subtraction of
// 2^23 + 128 leaves its value.
__device__ __forceinline__ void int8x4(unsigned w, float* out) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.f;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes 0 zero-fills and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// D is the head dim (64 or 128), G the query heads per kv head. PrefixT is
// __nv_bfloat16 for the exact cache and int8_t for the int8 one (then
// k_scale and v_scale are read; otherwise they may be null). Without POOLED,
// scalars holds the position shared by every row (STAGED: flushed_end,
// stage_len, layer; otherwise seq_end) and lens is unused; with POOLED,
// scalars holds the per-row prefix ends and lens the per-row stage lengths
// (unused without a stage). Kernels with a stage or per-row positions
// attend the current column as the last row of split nsplit - 1. Every
// kernel but the staged one-position one takes the layer as layer_arg.
template <int D, int G, typename PrefixT, bool POOLED, bool STAGED>
__global__ void __launch_bounds__(THREADS, 4) decode_kernel(
    const __nv_bfloat16* __restrict__ q,
    const PrefixT* __restrict__ k_cache,
    const PrefixT* __restrict__ v_cache,
    const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    __nv_bfloat16* __restrict__ k_stage,
    __nv_bfloat16* __restrict__ v_stage,
    const __nv_bfloat16* __restrict__ k_cur,
    const __nv_bfloat16* __restrict__ v_cur,
    const int* __restrict__ scalars,
    const int* __restrict__ lens,
    float* __restrict__ ws,
    int* __restrict__ tickets,
    __nv_bfloat16* __restrict__ out,
    int B, int Hkv, int L, int T, int stage_depth, int layer_arg, int chunk, int n_prefix,
    int nsplit, int k_cur_stride, int v_cur_stride, float qscale) {
  constexpr bool QUANT = std::is_same<PrefixT, int8_t>::value;
  constexpr bool HAS_CUR = STAGED || POOLED;
  constexpr int PART = D + 2;
  constexpr int HEADS_PER_WARP = (G + WARPS - 1) / WARPS;
  constexpr int DPL = D / 32;  // value dims per lane in phase 3
  using RingT = Ring<D>;
  constexpr int STAGES = RingT::STAGES;
  constexpr int ROW = RingT::ROW;
  static_assert(TILE == 32, "one position per lane");

  // With per-row positions the grid is (Hkv * B, nsplit), dispatched in
  // order of y then x: every row's stage splits (which hold the column)
  // first, then the prefix splits from position 0, so the splits a pool's
  // rows use start in the first wave and the empty ones at the prefix's deep
  // end come last (on an H100: 0.0174 -> 0.0136 ms for the 8-slot pool's
  // bf16 call at bases 112-434, tools/time_torch_kernels.py). With one
  // position for every row a row's splits stay adjacent, (nsplit, Hkv, B),
  // which was faster there (row 11: 0.0087 against 0.0099 ms). The merge
  // order is by split either way.
  const int n_stage = nsplit - n_prefix;
  int split, h, b;
  if constexpr (POOLED) {
    const int y = blockIdx.y;
    split = y < n_stage ? n_prefix + y : y - n_stage;
    h = blockIdx.x % Hkv;
    b = blockIdx.x / Hkv;
  } else {
    split = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  const int W = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t out0 = ((size_t)b * Hkv + h) * G * D;

  int flushed_end, stage_len = 0, layer;
  if constexpr (POOLED) {
    flushed_end = min(max(scalars[b], 0), T);
    if constexpr (STAGED) stage_len = min(max(lens[b], 0), stage_depth);
    layer = layer_arg;
  } else if constexpr (STAGED) {
    flushed_end = min(max(scalars[0], 0), T);
    stage_len = min(max(scalars[1], 0), stage_depth);
    layer = scalars[2];
  } else {
    flushed_end = min(max(scalars[0], 0), T);
    layer = layer_arg;
  }
  // Split 0 of a (row, kv head) that attends nothing writes NaN; no block
  // reads anything or takes a ticket.
  auto write_nan = [&]() {
    if (split == 0)
      for (int e = tid; e < G * D; e += THREADS)
        out[out0 + e] = __float2bfloat16(__int_as_float(0x7fc00000));
  };
  if (layer < 0 || layer >= L) {  // a bad layer is seen, not clamped
    write_nan();
    return;
  }

  // The splits that hold rows of this row b: prefix splits below
  // ceil(flushed_end / chunk), stage splits below ceil(stage_len / chunk),
  // and the last split when it holds the current column. Only they take
  // part: the others exit at once, and the ticket counts the active ones.
  const bool prefix = split < n_prefix;
  const bool last = split == nsplit - 1;
  const int pre_active = (flushed_end + chunk - 1) / chunk;
  const int stage_active = (stage_len + chunk - 1) / chunk;
  const bool last_counted = n_stage > 0 ? stage_active == n_stage : pre_active == n_prefix;
  const int n_active = pre_active + stage_active + ((HAS_CUR && !last_counted) ? 1 : 0);
  const bool active = prefix ? split < pre_active
                             : split - n_prefix < stage_active;
  if (n_active == 0) {  // nothing to attend: 0 / 0, as the plain version
    write_nan();
    return;
  }
  if (!active && !(HAS_CUR && last)) return;

  // The split's rows: prefix positions [start, start + n) or stage rows
  // [start, start + n), plus the current column as row n of the last split.
  int n;
  size_t row0;  // index of the split's first row in its buffer's [rows, W] view
  if (prefix) {
    const int start = split * chunk;
    n = max(0, min(chunk, flushed_end - start));
    row0 = ((size_t)layer * B + b) * (size_t)T + start;
  } else {
    const int start = (split - n_prefix) * chunk;
    n = max(0, min(chunk, stage_len - start));
    row0 = ((size_t)layer * B + b) * (size_t)stage_depth + start;
  }
  const int total = n + ((HAS_CUR && last) ? 1 : 0);

  __shared__ __align__(16) float s_q[G][D];  // the scaled query heads
  __shared__ __align__(16) float s_pw[WARPS][TILE];  // a warp's probabilities
  __shared__ bool s_last;
  extern __shared__ __align__(16) unsigned char ring[];
  const bool q8_split = QUANT && prefix;
  // 16-byte chunks of one row of K (or V): D * 2 bytes bf16, D bytes int8.
  const int chunks_per_row = (q8_split ? D : 2 * D) / 16;

  // Issue the copies of the tile at t0 into its slot as one commit group
  // (empty past the split's rows): the threads take the tile's 16-byte
  // chunks in turn; rows past the split's end are zero-filled, reading
  // nothing, and so are their scales. An int8 split's rows are all int8 (a
  // kernel with an int8 prefix always has a stage, which holds the column).
  auto issue = [&](int t0) {
    if (t0 < total) {
      unsigned char* st = ring + ((t0 / TILE) % STAGES) * RingT::STAGE_BYTES;
      for (int c = tid; c < 2 * TILE * chunks_per_row; c += THREADS) {
        const bool is_v = c >= TILE * chunks_per_row;
        const int cc = is_v ? c - TILE * chunks_per_row : c;
        const int r = cc / chunks_per_row;
        const int x = cc % chunks_per_row;
        const int i = t0 + r;
        unsigned char* dst = st + (is_v ? TILE * ROW : 0) + r * ROW + x * 16;
        if (i < n) {
          const size_t off = (row0 + i) * W + h * D;
          if (q8_split) {
            cp_async16(dst, (is_v ? v_cache : k_cache) + off + x * 16, 16);
          } else if (prefix) {
            cp_async16(dst, (is_v ? v_cache : k_cache) + off + x * 8, 16);
          } else {
            cp_async16(dst, (is_v ? v_stage : k_stage) + off + x * 8, 16);
          }
        } else if (HAS_CUR && last && i == n) {
          const __nv_bfloat16* col = is_v ? v_cur + (size_t)b * v_cur_stride
                                          : k_cur + (size_t)b * k_cur_stride;
          cp_async16(dst, col + h * D + x * 8, 16);
        } else {
          cp_async16(dst, q, 0);
        }
      }
      if (q8_split && tid < 2 * TILE) {
        const int r = tid % TILE;
        const int i = t0 + r;
        float* sc = reinterpret_cast<float*>(st + 2 * TILE * ROW) + tid;
        const float* src = (tid < TILE ? k_scale : v_scale) + (row0 + min(i, n - 1)) * Hkv + h;
        cp_async4(sc, src, i < n ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // Each warp owns the query heads g = warp, warp + WARPS, ...: phase 1
  // (lane = position) and phase 2 (the warp's max) need no barrier, phase 3
  // has each lane accumulate DPL value dims over the tile's positions.
  float acc[HEADS_PER_WARP][DPL];
  float m_run[HEADS_PER_WARP], l_run[HEADS_PER_WARP];
#pragma unroll
  for (int k = 0; k < HEADS_PER_WARP; ++k) {
    m_run[k] = NEG_BIG;
    l_run[k] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[k][d] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t * TILE);
  for (int e = tid; e < G * D / DIMS_PER_LANE; e += THREADS) {
    const int g = e / (D / DIMS_PER_LANE);
    const int c = (e % (D / DIMS_PER_LANE)) * DIMS_PER_LANE;
    float f[DIMS_PER_LANE];
    bf16x8(*reinterpret_cast<const uint4*>(q + out0 + (size_t)g * D + c), f);
#pragma unroll
    for (int d = 0; d < DIMS_PER_LANE; ++d) s_q[g][c + d] = f[d] * qscale;
  }
  for (int t0 = 0; t0 < total; t0 += TILE) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t0 have landed
    __syncthreads();  // everyone's have, and the previous tile's slot is free
    issue(t0 + (STAGES - 1) * TILE);
    const unsigned char* st = ring + ((t0 / TILE) % STAGES) * RingT::STAGE_BYTES;
    const float* sc = reinterpret_cast<const float*>(st + 2 * TILE * ROW);
    const unsigned char* krow = st + lane * ROW;
    const bool valid = t0 + lane < total;
#pragma unroll
    for (int k = 0; k < HEADS_PER_WARP; ++k) {
      const int g = warp + k * WARPS;
      if (g >= G) break;
      // Phase 1: this lane's position's score for head g.
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < D / DIMS_PER_LANE; ++c) {
        float kf[DIMS_PER_LANE];
        if (q8_split) {
          const uint2 u = *reinterpret_cast<const uint2*>(krow + c * 8);
          int8x4(u.x, kf);
          int8x4(u.y, kf + 4);
        } else {
          bf16x8(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
        }
        const float4 q0 = *reinterpret_cast<const float4*>(&s_q[g][c * 8]);
        const float4 q1 = *reinterpret_cast<const float4*>(&s_q[g][c * 8 + 4]);
        part[c % 4] += q0.x * kf[0] + q0.y * kf[1] + q0.z * kf[2] + q0.w * kf[3] +
                       q1.x * kf[4] + q1.y * kf[5] + q1.z * kf[6] + q1.w * kf[7];
      }
      float sg = (part[0] + part[1]) + (part[2] + part[3]);
      if (q8_split) sg *= sc[lane];
      sg = valid ? sg : NEG_BIG;
      // Phase 2: the tile's max for head g, one exp2f per position.
      const float mn = fmaxf(m_run[k], warp_max(sg));
      const float p = exp2f(sg - mn);
      const float alpha = exp2f(m_run[k] - mn);
      l_run[k] = l_run[k] * alpha + p;
      m_run[k] = mn;
      s_pw[warp][lane] = q8_split ? p * sc[TILE + lane] : p;
      __syncwarp();
      // Phase 3: rescale and accumulate p * v over the tile's positions.
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[k][d] *= alpha;
      const unsigned char* vbase = st + TILE * ROW;
#pragma unroll 4
      for (int r = 0; r < TILE; r += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&s_pw[warp][r]);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned char* vrow = vbase + (r + u) * ROW;
          float vf[DPL];
          if (q8_split) {
            float f[4];
            if constexpr (DPL == 2) {
              int8x4(*reinterpret_cast<const unsigned short*>(vrow + lane * 2), f);
            } else {
              int8x4(*reinterpret_cast<const unsigned*>(vrow + lane * 4), f);
            }
#pragma unroll
            for (int d = 0; d < DPL; ++d) vf[d] = f[d];
          } else {
#pragma unroll
            for (int d = 0; d < DPL; d += 2) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(vrow + (lane * DPL + d) * 2));
              vf[d] = f.x;
              vf[d + 1] = f.y;
            }
          }
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[k][d] = fmaf(pr[u], vf[d], acc[k][d]);
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();

  // The stage write: the column's K and V rows (row n of the split, in the
  // ring slot of the last tile, which the barrier of that tile published
  // and no later copy overwrote) stored into the column's stage slot.
  if constexpr (STAGED) {
    const int slot = last ? (POOLED ? lens[b] : scalars[1]) : -1;
    if (slot >= 0 && slot < stage_depth) {
      constexpr int VECS = 2 * D / 16;  // 16-byte chunks of a bf16 row
      const unsigned char* st = ring + ((n / TILE) % STAGES) * RingT::STAGE_BYTES;
      const size_t dst0 = (((size_t)layer * B + b) * stage_depth + slot) * W + h * D;
      for (int c = tid; c < 2 * VECS; c += THREADS) {
        const bool is_v = c >= VECS;
        const int x = is_v ? c - VECS : c;
        const uint4 val = *reinterpret_cast<const uint4*>(
            st + (is_v ? TILE * ROW : 0) + (n % TILE) * ROW + x * 16);
        *reinterpret_cast<uint4*>((is_v ? v_stage : k_stage) + dst0 + x * 8) = val;
      }
    }
  }

  // The block's partial: each warp writes its heads' accumulators, running
  // maxima and sums.
  float* pair_ws = ws + ((size_t)b * Hkv + h) * nsplit * G * PART;
  float* dst = pair_ws + (size_t)split * G * PART;
#pragma unroll
  for (int k = 0; k < HEADS_PER_WARP; ++k) {
    const int g = warp + k * WARPS;
    const float l = warp_sum(l_run[k]);
    if (g < G) {
#pragma unroll
      for (int d = 0; d < DPL; ++d) dst[g * PART + lane * DPL + d] = acc[k][d];
      if (lane == 0) {
        dst[g * PART + D] = m_run[k];
        dst[g * PART + D + 1] = l;
      }
    }
  }

  // The last block of this (row, kv head) merges the splits in split order:
  // the barrier orders the block's writes before thread 0's release, and its
  // acquire orders the other blocks' partials before the barrier after it.
  __syncthreads();
  if (tid == 0) s_last = atomic_add_acq_rel(&tickets[b * Hkv + h], 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;
  // Active split k of n_active, in split order.
  auto split_of = [&](int k) {
    return k < pre_active ? k
           : k < pre_active + stage_active ? n_prefix + (k - pre_active) : nsplit - 1;
  };
  // Each thread merges EPT consecutive outputs of one head over the splits,
  // MG splits' partials (values, max, sum) in flight at once (one round for
  // up to 24 active splits at head dim 64), rescaled group by group.
  constexpr int EPT = (G * D + THREADS - 1) / THREADS;  // outputs per thread
  constexpr int MG = 48 / EPT < 24 ? 48 / EPT : 24;
  const int e0 = min(tid * EPT, G * D - EPT);
  const int g0 = e0 / D;
  float mx = NEG_BIG, sum = 0.f, a[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) a[i] = 0.f;
  for (int k0 = 0; k0 < n_active; k0 += MG) {
    float v[MG][EPT], mk[MG], lk[MG];
#pragma unroll
    for (int j2 = 0; j2 < MG; ++j2) {
      const int k = min(k0 + j2, n_active - 1);
      const float* p = pair_ws + ((size_t)split_of(k) * G + g0) * PART;
      mk[j2] = __ldcg(p + D);
      lk[j2] = __ldcg(p + D + 1);
#pragma unroll
      for (int i = 0; i < EPT; ++i) v[j2][i] = __ldcg(p + e0 % D + i);
    }
    float mn = mx;
#pragma unroll
    for (int j2 = 0; j2 < MG; ++j2)
      if (k0 + j2 < n_active) mn = fmaxf(mn, mk[j2]);
    const float r = exp2f(mx - mn);
    sum *= r;
#pragma unroll
    for (int i = 0; i < EPT; ++i) a[i] *= r;
#pragma unroll
    for (int j2 = 0; j2 < MG; ++j2) {
      if (k0 + j2 < n_active) {
        const float f = exp2f(mk[j2] - mn);
        sum = fmaf(lk[j2], f, sum);
#pragma unroll
        for (int i = 0; i < EPT; ++i) a[i] = fmaf(v[j2][i], f, a[i]);
      }
    }
    mx = mn;
  }
  if (tid * EPT < G * D) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) out[out0 + e0 + i] = __float2bfloat16(a[i] / sum);
  }
  if (tid == 0) tickets[b * Hkv + h] = 0;
}

template <int D, typename PrefixT, bool POOLED, bool STAGED>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, void* k_stage, void* v_stage, const void* k_cur,
           const void* v_cur, const void* scalars, const void* lens, void* ws, void* tickets,
           void* out, int B, int Hq, int Hkv, int L, int T, int stage_depth, int layer,
           int chunk, int n_prefix, int n_stage, int k_cur_stride, int v_cur_stride,
           cudaStream_t s) {
  const int G = Hq / Hkv;
  const int nsplit = n_prefix + n_stage;
  const float qscale = LOG2E / sqrtf((float)D);
  const dim3 grid = POOLED ? dim3(Hkv * B, nsplit) : dim3(nsplit, Hkv, B);
  constexpr int smem = Ring<D>::BYTES;
  int dev = 0;
  cudaGetDevice(&dev);
#define ZVT_DECODE(GV)                                                                       \
  {                                                                                          \
    static unsigned configured = 0; /* devices whose attribute is set */                     \
    auto* kernel = decode_kernel<D, GV, PrefixT, POOLED, STAGED>;                            \
    if (!(configured >> dev & 1u)) {                                                         \
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);       \
      configured |= 1u << dev;                                                               \
    }                                                                                        \
  }                                                                                          \
  decode_kernel<D, GV, PrefixT, POOLED, STAGED><<<grid, THREADS, smem, s>>>(                 \
      static_cast<const __nv_bfloat16*>(q), static_cast<const PrefixT*>(k_cache),            \
      static_cast<const PrefixT*>(v_cache), static_cast<const float*>(k_scale),              \
      static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(k_stage),              \
      static_cast<__nv_bfloat16*>(v_stage), static_cast<const __nv_bfloat16*>(k_cur),        \
      static_cast<const __nv_bfloat16*>(v_cur), static_cast<const int*>(scalars),            \
      static_cast<const int*>(lens), static_cast<float*>(ws), static_cast<int*>(tickets),    \
      static_cast<__nv_bfloat16*>(out), B, Hkv, L, T, stage_depth, layer, chunk, n_prefix,   \
      nsplit, k_cur_stride, v_cur_stride, qscale)
  switch (G) {
    case 1: ZVT_DECODE(1); break;
    case 2: ZVT_DECODE(2); break;
    case 4: ZVT_DECODE(4); break;
    case 8: ZVT_DECODE(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZVT_DECODE
  return (int)cudaGetLastError();
}

template <typename PrefixT, bool POOLED, bool STAGED>
int launch_any(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
               const void* v_scale, void* k_stage, void* v_stage, const void* k_cur,
               const void* v_cur, const void* scalars, const void* lens, void* ws,
               void* tickets, void* out, int B, int Hq, int Hkv, int L, int T, int stage_depth,
               int head_dim, int layer, int chunk, int n_prefix, int n_stage, int k_cur_stride,
               int v_cur_stride, cudaStream_t s) {
  if (head_dim == 64)
    return launch<64, PrefixT, POOLED, STAGED>(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                               v_stage, k_cur, v_cur, scalars, lens, ws,
                                               tickets, out, B, Hq, Hkv, L, T, stage_depth,
                                               layer, chunk, n_prefix, n_stage, k_cur_stride,
                                               v_cur_stride, s);
  if (head_dim == 128)
    return launch<128, PrefixT, POOLED, STAGED>(q, k_cache, v_cache, k_scale, v_scale, k_stage,
                                                v_stage, k_cur, v_cur, scalars, lens, ws,
                                                tickets, out, B, Hq, Hkv, L, T, stage_depth,
                                                layer, chunk, n_prefix, n_stage, k_cur_stride,
                                                v_cur_stride, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One entry for every variant: quant (int8 prefix with k_scale/v_scale),
// pooled (scalars = per-row prefix ends, lens = per-row stage lengths) and
// staged (k_stage/v_stage attended, and the column stored into its stage
// slot; the one-position staged kernel reads its layer from scalars[2],
// every other takes `layer`). The split plan (chunk, n_prefix = ceil(T /
// chunk), n_stage = ceil(stage_depth / chunk), 0 without a stage) comes
// from the host; ws holds B * Hkv * (n_prefix + n_stage) * G *
// (head_dim + 2) floats and tickets B * Hkv zeroed int32s. The columns' row
// strides are in elements, multiples of 8 (16-byte rows for cp.async).
extern "C" int zvt_decode_attention(
    int quant, int pooled, int staged, const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, void* k_stage, void* v_stage,
    const void* k_cur, const void* v_cur, const void* scalars, const void* lens, void* ws,
    void* tickets, void* out, int B, int Hq, int Hkv, int L, int T, int stage_depth,
    int head_dim, int layer, int chunk, int n_prefix, int n_stage, int k_cur_stride,
    int v_cur_stride, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || chunk % TILE != 0 || chunk <= 0 || n_prefix + n_stage <= 0 ||
      n_prefix + n_stage > MAX_SPLITS || (quant && (!staged || stage_depth < 1)) ||
      k_cur_stride % 8 != 0 || v_cur_stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZVT_ANY(PT, P, S)                                                                       \
  launch_any<PT, P, S>(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, k_cur, v_cur,   \
                       scalars, lens, ws, tickets, out, B, Hq, Hkv, L, T, stage_depth, head_dim, \
                       layer, chunk, n_prefix, n_stage, k_cur_stride, v_cur_stride, s)
  if (quant) return pooled ? ZVT_ANY(int8_t, true, true) : ZVT_ANY(int8_t, false, true);
  if (staged) return pooled ? ZVT_ANY(__nv_bfloat16, true, true)
                            : ZVT_ANY(__nv_bfloat16, false, true);
  return pooled ? ZVT_ANY(__nv_bfloat16, true, false) : ZVT_ANY(__nv_bfloat16, false, false);
#undef ZVT_ANY
}
