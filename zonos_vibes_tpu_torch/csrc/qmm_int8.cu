// int8 weight-streaming matmul: out[m, g, :] = (x[m, :] @ W[g]) * scale[g].
//
// Replaces: zonos_vibes_tpu/ops/pallas/qmm.py::qmm_int8_pallas (a TPU grid
//   over output blocks: each step DMAs one [in, BLOCK] int8 slab into VMEM,
//   converts it, runs the skinny dot on the MXU with fp32 accumulation and
//   applies the per-out-channel scale to the fp32 result).
//
// Arithmetic: every bf16 x int8 product is exact in fp32 and is summed in
// fp32; the fp32 scale multiplies the finished dot; the result rounds once
// to the output type (bf16 for the projections, fp32 for the heads' logits).
//
// What bounds it on the H100: device-memory bytes. At decode (M = 2, the
// CFG pair) it streams each weight byte once and does 2 * M = 4 flops per
// byte; one fc1 weight (2048 x 16384 int8, 33.5 MB) takes >= 10 us at
// 3.35 TB/s. The prefill (M = 2 * (cond_len + 1), ~176) reuses each weight
// byte M times, which needs the tensor cores.
//
// What the design does about it, for M <= 2 (decode; CUDA cores):
//  * A block covers 128 output columns: 8 threads side by side
//    each load 16 bytes, so every weight row is read as one 128-byte line,
//    and the 32 row slices of a block (4 per warp) walk different rows.
//    Each thread issues U loads before it uses any (U = 8 at decode).
//  * Split-K: the rows are cut into `splits` ranges of a multiple of 256
//    rows, one block each, so that a projection of 2048 columns still puts
//    ~128-512 blocks on the card. Each block writes its fp32 partial to a
//    workspace; the last block of an output tile to arrive (an atomic
//    counter per tile) sums the partials in split order, applies the scale
//    and writes the output, then resets its counter to 0 for the next
//    launch. One launch, no host values, a deterministic sum.
//  * int8 -> fp32 by byte permutation: the byte (sign bit flipped) becomes
//    the low mantissa byte of 2^23, and one subtraction gives the exact
//    value, which avoids the quarter-rate integer-to-float conversion.
//  * x is tiny (M x K bf16) and read by every block: threads read it from
//    global memory, where it stays in L1 and L2.
//  * Each thread keeps fp32 accumulators for 16 columns of both rows (M = 1
//    runs its one row twice).
// For M > 2 (prefill; tensor cores): blocks of 64 rows x 128 columns step
// through K 64 rows at a time. The x tile and the weight tile, its int8
// values widened to bf16 (exact), go through shared memory row-major; each
// of 8 warps runs mma.sync m16n8k16 (bf16 in, fp32 accumulate) on a 32 x 32
// sub-tile, its B fragments loaded with ldmatrix.trans, and the next tiles
// are loaded into registers while the current ones are multiplied. wgmma,
// TMA and a deeper pipeline are later work.
//
// Layouts (row-major): x bf16 [M, K]; w int8 [G, K, N]; scale fp32 [G, 1, N];
// out [M, G, N] of OutT. N must be a multiple of 16. ws fp32 and counters
// int32 (zero before the first launch) as sized by zvt_qmm_int8_workspace
// and zvt_qmm_int8_tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS_PER_THREAD = 16;  // one 16-byte load of a W row
constexpr int COL_GROUPS = 8;        // threads side by side on a row
constexpr int TILE_N = COLS_PER_THREAD * COL_GROUPS;  // 128 columns
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANE_SLICES = 32 / COL_GROUPS;  // row slices in a warp
constexpr int SLICES = WARPS * LANE_SLICES;   // row slices in a block
constexpr int SPLIT_ROWS = 256;               // a split's rows: a multiple of this
constexpr int TARGET_BLOCKS = 4 * 132;        // four blocks per SM of an H100
constexpr int MT = 2;                         // the CUDA-core kernel's rows: the CFG pair
constexpr int U = 8;                          // weight rows each thread has in flight
// Tensor-core kernel tiles; rows of its shared tiles are padded by 8 bf16.
constexpr int MMA_BM = 64;
constexpr int MMA_BK = 64;

struct Plan {
  int ntiles, splits, rows;
};

// The CUDA-core kernel's launch (M <= MT).
Plan make_plan(int K, int N, int G) {
  Plan p;
  p.ntiles = (N + TILE_N - 1) / TILE_N;
  const int base = p.ntiles * G;
  const int want = max(1, min((TARGET_BLOCKS + base - 1) / base, K / SPLIT_ROWS));
  p.rows = ((K + want - 1) / want + SPLIT_ROWS - 1) / SPLIT_ROWS * SPLIT_ROWS;
  p.splits = (K + p.rows - 1) / p.rows;
  return p;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Byte i of v (a signed int8 whose sign bit was flipped) as an exact float.
__device__ __forceinline__ float byte_to_float(uint32_t v, int i) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540u + i)) - 8388736.0f;  // 2^23 + 128
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS) qmm_int8_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int M, int K, int N, int G, int rows, int splits) {
  const int n0 = blockIdx.y * TILE_N;
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = lane % COL_GROUPS;
  const int slice = warp * LANE_SLICES + lane / COL_GROUPS;
  const int col = n0 + cg * COLS_PER_THREAD;
  const int k_end = min(K, (split + 1) * rows);
  const int8_t* wg = w + (size_t)g * K * N;
  // With M = 1 the second row repeats the first; the epilogue drops it.
  const __nv_bfloat16* xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = x + (size_t)min(m, M - 1) * K;

  float acc[MT][COLS_PER_THREAD];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) acc[m][c] = 0.f;
  }

  if (col < N) {
    for (int k = split * rows + slice; k < k_end; k += SLICES * U) {
      uint4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k + u * SLICES;
        // Past k_end: zero weights.
        wv[u] = kk < k_end ? __ldg(reinterpret_cast<const uint4*>(wg + (size_t)kk * N + col))
                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = min(k + u * SLICES, k_end - 1);
        float xf[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xf[m] = __bfloat162float(xr[m][kk]);
        const uint32_t words[4] = {wv[u].x ^ 0x80808080u, wv[u].y ^ 0x80808080u,
                                   wv[u].z ^ 0x80808080u, wv[u].w ^ 0x80808080u};
#pragma unroll
        for (int c = 0; c < COLS_PER_THREAD; ++c) {
          const float wf = byte_to_float(words[c / 4], c % 4);
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xf[m], wf, acc[m][c]);
        }
      }
    }
  }

  // Sum the warp's row slices (lanes of the same column group), then the
  // warps in shared memory; every lane takes part in the shuffles.
#pragma unroll
  for (int off = COL_GROUPS; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
    }
  }
  __shared__ float red[WARPS][MT][TILE_N];
  __shared__ int is_last;
  if (lane < COL_GROUPS) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c)
        red[warp][m][cg * COLS_PER_THREAD + c] = acc[m][c];
    }
  }
  __syncthreads();

  const size_t tile = (size_t)g * gridDim.y + blockIdx.y;
  float* tile_ws = ws + tile * splits * (MT * TILE_N);
  if (splits > 1) {
    for (int e = threadIdx.x; e < MT * TILE_N; e += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][e / TILE_N][e % TILE_N];
      tile_ws[split * (MT * TILE_N) + e] = s;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }
  for (int e = threadIdx.x; e < MT * TILE_N; e += THREADS) {
    const int m = e / TILE_N;
    const int c = e % TILE_N;
    float s = 0.f;
    if (splits > 1) {
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(tile_ws + sp * (MT * TILE_N) + e);
    } else {
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][m][c];
    }
    if (m < M && n0 + c < N)
      store(out + ((size_t)m * G + g) * N + n0 + c, s * scale[(size_t)g * N + n0 + c]);
  }
  if (splits > 1 && threadIdx.x == 0) counters[tile] = 0;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: the mma B
// fragments of two n8 tiles over k16 from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS) qmm_int8_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N, int G) {
  const int m0 = blockIdx.x * MMA_BM;
  const int n0 = blockIdx.y * TILE_N;
  const int g = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / 4) * 32;  // the warp's 32 x 32 sub-tile
  const int wn = (warp % 4) * 32;
  const int gid = lane >> 2;       // mma fragment coordinates
  const int tig = lane & 3;
  const int8_t* wg = w + (size_t)g * K * N;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);

  __shared__ __align__(16) uint16_t xs[MMA_BM][MMA_BK + 8];  // bf16 bits, [m][k]
  __shared__ __align__(16) uint16_t wt[MMA_BK][TILE_N + 8];  // bf16 bits, [k][n]

  // Per thread per K step: 16 x values (row xr, k from xk) and 2 x 16
  // weight bytes (rows wk and wk + 32, 16 columns from wc).
  const int xr = threadIdx.x / 4, xk = (threadIdx.x % 4) * 16;
  const int wk = threadIdx.x / 8, wc = (threadIdx.x % 8) * 16;
  uint32_t xv[8];
  uint4 wv[2];
  auto load = [&](int k0) {
    const bool row_ok = m0 + xr < M;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + xk + 2 * i;
      const size_t at = (size_t)(m0 + xr) * K + k;
      const uint32_t lo = row_ok && k < K ? xb[at] : 0u;
      const uint32_t hi = row_ok && k + 1 < K ? xb[at + 1] : 0u;
      xv[i] = lo | (hi << 16);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + wk + 32 * j;
      wv[j] = (k < K && n0 + wc < N)
                  ? __ldg(reinterpret_cast<const uint4*>(wg + (size_t)k * N + n0 + wc))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stash = [&]() {
    uint4* xdst = reinterpret_cast<uint4*>(&xs[xr][xk]);
    xdst[0] = make_uint4(xv[0], xv[1], xv[2], xv[3]);
    xdst[1] = make_uint4(xv[4], xv[5], xv[6], xv[7]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t words[4] = {wv[j].x ^ 0x80808080u, wv[j].y ^ 0x80808080u,
                                 wv[j].z ^ 0x80808080u, wv[j].w ^ 0x80808080u};
      uint32_t h[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        h[c] = bf16x2_bits(byte_to_float(words[c / 2], (c % 2) * 2),
                           byte_to_float(words[c / 2], (c % 2) * 2 + 1));
      uint4* wdst = reinterpret_cast<uint4*>(&wt[wk + 32 * j][wc]);
      wdst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      wdst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }

  load(0);
  for (int k0 = 0; k0 < K; k0 += MMA_BK) {
    __syncthreads();
    stash();
    __syncthreads();
    if (k0 + MMA_BK < K) load(k0 + MMA_BK);
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + gid;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + tig * 2]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + tig * 2]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + tig * 2 + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        // Lanes 0-7, 8-15, 16-23, 24-31 address the rows of the matrices
        // (k 0-7, n tile j), (k 8-15, j), (k 0-7, j + 1), (k 8-15, j + 1).
        const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn + (j + (lane >> 4)) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, &wt[k][n]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + gid + (r >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + tig * 2 + (r & 1);
        if (m < M && n < N)
          store(out + ((size_t)m * G + g) * N + n, acc[i][j][r] * scale[(size_t)g * N + n]);
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                   void* counters, int M, int K, int N, int G, cudaStream_t s) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  if (M > MT) {
    const dim3 grid((M + MMA_BM - 1) / MMA_BM, (N + TILE_N - 1) / TILE_N, G);
    qmm_int8_mma_kernel<OutT><<<grid, THREADS, 0, s>>>(xp, wp, sp, op, M, K, N, G);
    return cudaGetLastError();
  }
  const Plan p = make_plan(K, N, G);
  const dim3 grid(1, p.ntiles, G * p.splits);
  qmm_int8_kernel<OutT><<<grid, THREADS, 0, s>>>(xp, wp, sp, op, static_cast<float*>(ws),
                                                 static_cast<int*>(counters), M, K, N, G,
                                                 p.rows, p.splits);
  return cudaGetLastError();
}

}  // namespace

// Output tiles of a launch: the counters it needs (0 for the tensor-core kernel).
extern "C" int zvt_qmm_int8_tiles(int M, int K, int N, int G) {
  return M > MT ? 0 : make_plan(K, N, G).ntiles * G;
}

// fp32 workspace floats of a launch (0 when the rows are not split).
extern "C" int zvt_qmm_int8_workspace(int M, int K, int N, int G) {
  if (M > MT) return 0;
  const Plan p = make_plan(K, N, G);
  return p.splits > 1 ? p.ntiles * G * p.splits * MT * TILE_N : 0;
}

// out_f32: 1 for an fp32 output, 0 for bf16.
extern "C" int zvt_qmm_int8(const void* x, const void* w, const void* scale, void* out,
                            void* ws, void* counters, int M, int K, int N, int G, int out_f32,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || N % COLS_PER_THREAD != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_f32 ? launch<float>(x, w, scale, out, ws, counters, M, K, N, G, s)
              : launch<__nv_bfloat16>(x, w, scale, out, ws, counters, M, K, N, G, s);
  return (int)err;
}
