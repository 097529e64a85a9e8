// Packed-int4 weight-streaming matmul with grouped scales:
//   out[m, n] = sum_g scale[g, n] * sum_{k in group g} x[m, k] * q[k, n].
//
// Replaces: not a Pallas kernel. The JAX package stores int4 weights as XLA
//   `s4` arrays and leaves the product to XLA (zonos_vibes_tpu/ops/quant.py
//   ::proj_matmul, :307-330): a G-batched dot with the int4 -> bf16 convert
//   fused into the operand read, fp32 accumulation, the per-(group, column)
//   scale on each group's fp32 sum and a sum over the groups. The weight
//   crosses HBM packed, two values to a byte. No PyTorch call multiplies bf16
//   activations by packed int4 without first writing a dequantized copy of
//   the weight, which would read four times the bytes.
//
// Arithmetic (JAX's): every bf16 x int4 product is exact in fp32. The tensor
// cores sum a group's products in fp32 into a group accumulator; at the
// group's end its fp32 scale multiplies that sum into the totals (one fma),
// and the accumulator restarts. A split of K (below) ends a group early: the
// splits' scaled partials are summed in fp32 in rank order. The result rounds
// once to the output type (bf16 for the projections, fp32 for the quality
// gate). The plain version (qmm_int4_plain) scales each finished group sum
// and sums the groups: the two differ by fp32 rounding only. An ungrouped
// weight is one group of K rows.
//
// What bounds it on the H100: at the decode's M (1-16 rows of x) the work's
// least time is its device-memory bytes (a packed fc1, 2048 x 16384, is 16.8
// MB: >= 5 us at 3.35 TB/s; each weight serves at most 32 flops); at the
// prefill's M (176, 320) the tensor cores (fc1 at M = 176: 11.8 GFLOP, 12 us
// at 989 TFLOP/s). PR 12's design (CUDA cores) was bound by neither but by
// instruction issue: ~3 instructions to widen each weight and M FMAs a
// weight. This one widens a pair of weights in 3 instructions and leaves the
// multiply-adds to mma.sync. What bounds it now (PERF.md, the qmm_int4 row;
// tools/probe_qmm_int4.py times the kernel without its compute and without
// its refills): at M <= 16 not the bytes but each block's serial chain per
// stage (the barrier, the fragment loads and widening, the mma chain, the
// group flush) and a launch's fixed cost; at the prefill's M the mma.sync
// work, with the copies of x, which each column tile stages again, mostly
// not overlapped with it. A warpgroup version (the tile widened once into a
// bf16 tile in shared memory, wgmma m64n128k16) was no faster: its widening
// and barriers per stage, not the tensor cores, set its pace (PERF.md, PR 13).
//
// Design:
//  * A block is 2 TN / 32 warps over TN (64, 128 or 256) columns, one tile of
//    BM rows of x and a stretch of `rows` rows of K; grid (cs, N / TN,
//    ceil(M / BM)). Two warps share each 32 columns: at BM 8 and 16 they
//    split each stage's k rows (a k32 half each; the pair's partials are
//    summed in order at the end), at BM 64 the columns' four n8 tiles (two
//    each, all 64 rows), so that no weight is widened twice in a block and a
//    thread keeps at most 128 registers. Where the tiles alone leave SMs
//    idle, K is split inside a thread-block cluster of cs blocks whose fp32
//    partials meet in distributed shared memory in rank order
//    (deterministic; no workspace, no counters: nothing but the output
//    reaches device memory). The host plans (BM, TN, cs, rows) from the
//    shapes and the card's SM count (ops/cuda/qmm.py::int4_plan).
//  * Row tiles fitted to M, by the operand x takes in mma.sync m16n8k16:
//    - BM = 8 (M <= 8, the solo step and small batches): x is the n8 operand
//      (B), the weight the m16 operand (A): 16 columns per mma, no padded rows
//      of x multiplied beyond 8 (PR 12's CUDA-core kernel, given the same
//      widening, was 3-6% slower at fc1 and fc2 at M = 2 and was removed);
//    - BM = 16 (the 8-slot pool's M = 16): x is the m16 operand, one row tile;
//    - BM = 64 (prefills): x the m16 operand, four row tiles per warp.
//  * Weight layout: uint8 [K, N / 2], byte j of a row holding column 2j in its
//    low nibble and 2j + 1 in its high nibble, each a two's-complement value
//    in [-7, 7] (the layout the checkpoints hold: nothing is repacked). A stage
//    is BK = 64 rows of the tile (TN / 2 bytes each, 16 bytes of padding to
//    the pitch against bank conflicts; one 16-byte cp.async.cg copy per thread,
//    its address computed once) and BM x 64 of x, in a ring of NSTAGE stages,
//    NSTAGE - 1 in flight. Rows past K, columns past N and rows of x past M
//    are zero-filled, reading nothing.
//  * Widening in registers ("nibble trick"): ldmatrix.trans of the packed
//    tile read as 16-bit elements gives lane (g = lane / 4, t = lane % 4) the
//    element g of k rows 2t and 2t + 1, i.e. the four columns 4g..4g+3 of
//    each row in its two halves. For nibble j, (v >> 4j) & 0x000F000F
//    ^ 0x43084308 (one shift, one lop3) is the bf16 pair 128 + (q ^ 8) of
//    both rows (q's nibble in the low mantissa bits of 128.0, its sign bit
//    flipped), and one bf16x2 subtraction of 136 gives q exactly. That
//    register is a B fragment (BM 16/64: n8 tile j, whose column g is the
//    true column 4g + j) or half an A fragment (BM 8: nibbles 2p and 2p + 1
//    give the m16 tile's rows g and g + 8). The permutation is undone where
//    scales are read and partials written, never in memory: a thread's
//    columns come out contiguous (BM 16/64: 8t..8t+7 of its warp's 32; BM 8:
//    4g..4g+3).
//  * Groups: a k16 step lies inside one group unless the group size is not a
//    multiple of 16; there the step is taken once per group it touches with
//    x's other k rows masked to zero. The scales of a thread's columns for the
//    next group are loaded as the current one is flushed.
//  * Programmatic dependent launch: the launch may be scheduled while the
//    previous kernel finishes and waits for it (griddepcontrol.wait) before
//    its first read.
//  * No host synchronisation and no allocation: a launch can be captured in a
//    CUDA graph. The shared-memory attribute is set once per device.
//
// Layouts (row-major): x bf16 [M, K]; w uint8 [K, N / 2]; scale fp32 [NG, N]
// (NG groups of K / NG rows); out [M, N] of OutT. N must be a multiple of 32
// (a 16-byte copy is 32 columns, one warp's), K a multiple of NG.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;                  // rows of K per stage
constexpr int NSTAGE = 4;
constexpr int MAX_THREADS = 512;        // two warps per 32 columns: TN = 256
constexpr int X_PITCH = BK + 8;         // bf16 per staged x row
constexpr int MAX_CLUSTER = 8;          // portable cluster size
constexpr int MAX_BLOCK_SMEM = 232448;  // shared memory a block can have (227 KB)
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Nibble j of both 16-bit halves of v as the exact bf16 pair of int4 values:
// 128 + (q ^ 8) by mask and xor (one lop3), then - 136.
__device__ __forceinline__ uint32_t widen(uint32_t v, int j) {
  const uint32_t biased = ((v >> (4 * j)) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __nv_bfloat162(__ushort_as_bfloat16(0x4308),
                                                  __ushort_as_bfloat16(0x4308)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The bf16 pair of x at k rows (k, k + 1) of a fragment, each half kept only
// inside rows [lo, hi).
__device__ __forceinline__ uint32_t mask_pair(uint32_t v, int k, int lo, int hi) {
  return v & ((lo <= k && k < hi ? 0x0000FFFFu : 0u) |
              (lo <= k + 1 && k + 1 < hi ? 0xFFFF0000u : 0u));
}

// One cluster of gridDim.x blocks per (column tile, tile of BM rows of x);
// block `rank` of the cluster sums rows [rank * rows, (rank + 1) * rows) of K
// (rows a multiple of BK). blockDim.x = 2 TN: two warps per 32 columns, which
// split each stage's k rows (BM 8, 16: one k32 half each) or the columns' n8
// tiles (BM 64: tiles 2 wz and 2 wz + 1, all 64 rows).
template <typename OutT, int BM>
__global__ void __launch_bounds__(MAX_THREADS) qmm_int4_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N, int NG,
    int rows) {
  constexpr bool XB = BM == 8;                 // x is the n8 operand
  constexpr bool KSPLIT = BM <= 16;            // the warp pair splits k
  constexpr bool JSPLIT = !KSPLIT;             // or the 32 columns' n8 tiles
  constexpr int MT = XB ? 1 : BM / 16;         // m16 tiles of x a warp multiplies
  constexpr int NACC = XB || JSPLIT ? 2 : 4;   // accumulator tiles of a warp
  constexpr int NSC = XB || JSPLIT ? 4 : 8;    // a thread's columns
  extern __shared__ __align__(16) uint8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int TN = blockDim.x / 2;
  const int WP = TN / 2 + 16;                   // bytes per staged weight row
  const int stage_bytes = BK * WP + BM * X_PITCH * 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = (tid >> 5) % (TN / 32);        // the warp's 32 columns
  const int wz = (tid >> 5) / (TN / 32);        // and its half of k (or of the n8 tiles)
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.y * TN;
  const int m0 = blockIdx.z * BM;
  const int mr = min(BM, M - m0);               // rows of x in this tile
  const int k_begin = rank * rows;
  const int k_end = min(K, k_begin + rows);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int gs = K / NG;
  const size_t pitch = static_cast<size_t>(N) / 2;
  const bool x_vec = K % 8 == 0;                // x rows 16-byte aligned: cp.async
  const bool cols_ok = n0 + wn * 32 < N;        // N % 32 == 0: all 32 in or all out
  // The thread's first column: NSC contiguous ones (BM 64: two pairs, 4 apart).
  const int col = n0 + wn * 32 + (XB ? 4 * gid : 8 * t4 + (JSPLIT ? 2 * wz : 0));
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  // A stage's BK x TN / 32 16-byte weight copies are one per thread: row wr_
  // of the stage, bytes wc_ of the tile row.
  const int wr_ = tid / (TN / 32);
  const int wc_ = (tid % (TN / 32)) * 16;
  const bool wcol_ok = n0 + 2 * wc_ < N;
  const uint8_t* wsrc = w + (static_cast<size_t>(k_begin) + wr_) * pitch + n0 / 2 + wc_;
  const uint32_t wdst = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + wr_ * WP + wc_;

  // Rows of x past M are never copied: zero them in every stage once.
  for (int i = tid; i < NSTAGE * (BM - mr) * X_PITCH; i += blockDim.x) {
    const int s = i / ((BM - mr) * X_PITCH);
    const int e = i % ((BM - mr) * X_PITCH);
    reinterpret_cast<uint16_t*>(smem + s * stage_bytes + BK * WP)[mr * X_PITCH + e] = 0;
  }
  // Programmatic dependent launch: the block may start while the previous
  // kernel on the stream finishes, and reads nothing before it is done.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // Stage s: the packed weight tile [BK][WP] then the x tile [BM][X_PITCH].
  auto load = [&](int it) {
    const int slot = it % NSTAGE;
    const bool ok = wcol_ok && k_begin + it * BK + wr_ < k_end;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wdst + slot * stage_bytes),
                 "l"(ok ? wsrc + static_cast<size_t>(it) * BK * pitch : w), "r"(ok ? 16 : 0)
                 : "memory");
    uint16_t* xt = reinterpret_cast<uint16_t*>(smem + slot * stage_bytes + BK * WP);
    const int k0 = k_begin + it * BK;
    if (x_vec) {
      for (int c = tid; c < mr * (BK / 8); c += blockDim.x) {
        const int r = c / (BK / 8);
        const int kc = (c % (BK / 8)) * 8;
        const bool okx = k0 + kc < k_end;
        cp_async16(xt + r * X_PITCH + kc,
                   xb + (okx ? static_cast<size_t>(m0 + r) * K + k0 + kc : 0), okx);
      }
    } else {
      for (int e = tid; e < mr * BK; e += blockDim.x) {
        const int r = e / BK;
        const int kc = e % BK;
        xt[r * X_PITCH + kc] =
            k0 + kc < k_end ? xb[static_cast<size_t>(m0 + r) * K + k0 + kc] : uint16_t(0);
      }
    }
  };

  float acc[MT][NACC][4], tot[MT][NACC][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
    }
  }
  int g = k_begin / gs;         // the group being summed
  int bnext = (g + 1) * gs;     // and its end
  float sc[NSC] = {};           // its scales for the thread's columns
  auto load_scales = [&]() {
    if (g < NG && cols_ok) {
      const float* p = scale + static_cast<size_t>(g) * N + col;
      if constexpr (JSPLIT) {  // columns col, col + 1 and col + 4, col + 5
        const float2 u = *reinterpret_cast<const float2*>(p);
        const float2 v = *reinterpret_cast<const float2*>(p + 4);
        sc[0] = u.x;
        sc[1] = u.y;
        sc[2] = v.x;
        sc[3] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < NSC / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(p)[q];
          sc[4 * q] = v.x;
          sc[4 * q + 1] = v.y;
          sc[4 * q + 2] = v.z;
          sc[4 * q + 3] = v.w;
        }
      }
    }
  };
  // The finished group's sum times its scales into the totals; then the next
  // group's scales.
  auto flush = [&]() {
    if (g < NG) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NACC; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // BM 8: tile p = j holds columns 2p (e 0, 1) and 2p + 1 (e 2, 3);
            // BM 16: tile j holds columns j (e 0, 2) and 4 + j (e 1, 3); BM
            // 64: tile 2 wz + j holds columns j and 4 + j of the thread's.
            float s;
            if constexpr (XB)
              s = sc[2 * j + (e >> 1)];
            else if constexpr (JSPLIT)
              s = sc[j + 2 * (e & 1)];
            else
              s = sc[j + 4 * (e & 1)];
            tot[i][j][e] = fmaf(acc[i][j][e], s, tot[i][j][e]);
            acc[i][j][e] = 0.f;
          }
        }
      }
    }
    ++g;
    bnext += gs;
    load_scales();
  };
  load_scales();

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage `it` has landed; every warp is past stage it - 1
    if (it + NSTAGE - 1 < nk) load(it + NSTAGE - 1);
    cp_async_commit();
    const uint8_t* wt = smem + (it % NSTAGE) * stage_bytes;
    const uint16_t* xt = reinterpret_cast<const uint16_t*>(wt + BK * WP);
#pragma unroll
    for (int kq = 0; kq < (KSPLIT ? 1 : 2); ++kq) {
      const int kk = KSPLIT ? 32 * wz : 32 * kq;  // the warp's k32 chunk of the stage
      const int kb0 = k_begin + it * BK + kk;
      if (kb0 >= k_end) break;
      // Lane l addresses row kk + l: matrices k 0-7, 8-15, 16-23, 24-31 of the
      // warp's 32 columns (16 bytes a row).
      uint32_t wr[4];
      ldmatrix_x4_trans(wr, wt + (kk + lane) * WP + wn * 16);
      uint32_t xq[4];
      if constexpr (XB)  // x rows 0-7 at k 0-7, 8-15, 16-23, 24-31: B fragments
        ldmatrix_x4(xq, xt + (lane & 7) * X_PITCH + kk + (lane >> 3) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kb = kb0 + 16 * h;  // this k16 step's first row
        if (kb >= k_end) break;
        const uint32_t w0 = wr[2 * h], w1 = wr[2 * h + 1];
        uint32_t a[MT][4];
        if constexpr (!XB) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
            ldmatrix_x4(a[i], xt + (i * 16 + (lane & 15)) * X_PITCH + kk + 16 * h +
                                  (lane >> 4) * 8);
        }
        // The step's products into the group accumulators, x's k rows outside
        // [lo, hi) (relative to kb) masked out unless the step is whole.
        auto step = [&](bool whole, int lo, int hi) {
          if constexpr (XB) {
            uint32_t b[2] = {xq[2 * h], xq[2 * h + 1]};
            if (!whole) {
              b[0] = mask_pair(b[0], 2 * t4, lo, hi);
              b[1] = mask_pair(b[1], 2 * t4 + 8, lo, hi);
            }
            // m16 tile p: rows g <- column 4g + 2p, rows g + 8 <- 4g + 2p + 1.
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const uint32_t ap[4] = {widen(w0, 2 * p), widen(w0, 2 * p + 1), widen(w1, 2 * p),
                                      widen(w1, 2 * p + 1)};
              mma_bf16(acc[0][p], ap, b);
            }
          } else {
            uint32_t am[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                am[i][q] = whole ? a[i][q] : mask_pair(a[i][q], 2 * t4 + 8 * (q >> 1), lo, hi);
            }
            // n8 tile j: column g <- column 4g + j (BM 64: tiles 2 wz + j).
#pragma unroll
            for (int j = 0; j < NACC; ++j) {
              const int jt = JSPLIT ? 2 * wz + j : j;
              const uint32_t b[2] = {widen(w0, jt), widen(w1, jt)};
#pragma unroll
              for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], am[i], b);
            }
          }
        };

        // Groups that ended before this step (in the other warp's rows).
        while (bnext <= kb) flush();
        if (kb + 16 <= bnext) {  // the step lies in group g
          step(true, 0, 16);
          if (kb + 16 == bnext) flush();
        } else {  // a group ends inside the step
          int lo = 0;
          for (;;) {
            const int hi = min(16, bnext - kb);
            step(false, lo, hi);
            if (kb + hi == bnext) flush();
            if (hi == 16) break;
            lo = hi;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  flush();  // the warp's last, unfinished group (g past NG: nothing)

  // The warps' partials in the drained ring ([2][BM][TN] for a k split, the
  // pair summed in order; [BM][TN] for an n8-tile split), then the cluster's
  // partials meet in distributed shared memory: block `rank` sums its 1/cs
  // share of the tile's outputs over the ranks in order.
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  if constexpr (XB) {  // rows 2t, 2t + 1; columns 4g..4g+3
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(part + ((wz * BM) + 2 * t4 + e) * TN + wn * 32 + 4 * gid) =
          make_float4(tot[0][0][e], tot[0][0][2 + e], tot[0][1][e], tot[0][1][2 + e]);
  } else if constexpr (KSPLIT) {  // rows g, g + 8; columns 8t..8t+7
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* p = part + (wz * BM + gid + 8 * hf) * TN + wn * 32 + 8 * t4;
      *reinterpret_cast<float4*>(p) = make_float4(tot[0][0][2 * hf], tot[0][1][2 * hf],
                                                  tot[0][2][2 * hf], tot[0][3][2 * hf]);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(tot[0][0][2 * hf + 1], tot[0][1][2 * hf + 1], tot[0][2][2 * hf + 1],
                      tot[0][3][2 * hf + 1]);
    }
  } else {  // rows 16 i + g, + 8; columns 8t + 2 wz, + 1 and + 4, + 5
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* p = part + (i * 16 + gid + 8 * hf) * TN + wn * 32 + 8 * t4 + 2 * wz;
        *reinterpret_cast<float2*>(p) = make_float2(tot[i][0][2 * hf], tot[i][1][2 * hf]);
        *reinterpret_cast<float2*>(p + 4) =
            make_float2(tot[i][0][2 * hf + 1], tot[i][1][2 * hf + 1]);
      }
    }
  }
  __syncthreads();
  if constexpr (KSPLIT) {  // the pair's k halves, in order
    for (int e = tid; e < mr * TN; e += blockDim.x) part[e] += part[BM * TN + e];
  }
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  const int total = mr * TN;
  const int per = (total + cs - 1) / cs;
  for (int e = rank * per + tid; e < min(total, (rank + 1) * per); e += blockDim.x) {
    float sum = 0.f;
    if (cs > 1) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        v[q] = q < cs ? *cluster.map_shared_rank(part + e, q) : 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q) sum += v[q];
    } else {
      sum = part[e];
    }
    const int n = n0 + e % TN;
    if (n < N) store(out + static_cast<size_t>(m0 + e / TN) * N + n, sum);
  }
  if (cs > 1) {  // no block leaves while another still reads its partial
    cluster_arrive();
    cluster_wait();
  }
}

template <typename OutT, int BM>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                   int N, int NG, int tn, int cs, int rows, cudaStream_t s) {
  const int ring = NSTAGE * (BK * (tn / 2 + 16) + BM * X_PITCH * 2);
  const int part = (BM <= 16 ? 2 : 1) * BM * tn * 4;  // the warps' partials
  const int smem = ring > part ? ring : part;
  if (smem > MAX_BLOCK_SMEM) return cudaErrorInvalidValue;
  auto* kernel = qmm_int4_kernel<OutT, BM>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static int configured_smem[MAX_DEVICES] = {};  // per device: the attribute set so far
  if (smem > configured_smem[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured_smem[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (N + tn - 1) / tn, (M + BM - 1) / BM);
  cfg.blockDim = dim3(2 * tn);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cs;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 2 : 1;  // a launch without clusters is cheaper to dispatch
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                         static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
                         static_cast<OutT*>(out), M, K, N, NG, rows);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bm(const void* x, const void* w, const void* scale, void* out, int M, int K,
                      int N, int NG, int bm, int tn, int cs, int rows, cudaStream_t s) {
  switch (bm) {
    case 8: return launch<OutT, 8>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
    case 16: return launch<OutT, 16>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
    default: return launch<OutT, 64>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
  }
}

}  // namespace

// As planned by ops/cuda/qmm.py::int4_plan: tiles of bm rows of x (8: x is
// mma's n8 operand; 16 or 64: its m16 operand), tn (64, 128 or 256) columns, clusters of cs (1-8) blocks, `rows` rows of K per block (a multiple
// of 64, cs * rows >= K). out_f32: 1 for an fp32 output, 0 for bf16.
extern "C" int zvt_qmm_int4(const void* x, const void* w, const void* scale, void* out, int M,
                            int K, int N, int NG, int out_f32, int bm, int tn, int cs, int rows,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 32 != 0 || NG <= 0 || K % NG != 0 ||
      (bm != 8 && bm != 16 && bm != 64) || (tn != 64 && tn != 128 && tn != 256) || cs <= 0 ||
      cs > MAX_CLUSTER || rows <= 0 || rows % BK != 0 || (long long)cs * rows < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_f32 ? launch_bm<float>(x, w, scale, out, M, K, N, NG, bm, tn, cs, rows, s)
              : launch_bm<__nv_bfloat16>(x, w, scale, out, M, K, N, NG, bm, tn, cs, rows, s);
  return (int)err;
}
