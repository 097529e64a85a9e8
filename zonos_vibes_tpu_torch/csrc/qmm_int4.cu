// Packed-int4 weight-streaming matmul with grouped scales:
//   out[m, n] = sum_g scale[g, n] * sum_{k in group g} x[m, k] * q[k, n],
// with each group's inner sum cut into slices (see Arithmetic).
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
// Arithmetic: every bf16 x int4 product is exact in fp32. A thread sums in
// fp32 the products of its slice of a group's rows (a group of 128 rows is
// cut into up to 16 slices at M = 2, see Design) and multiplies that partial
// by the group's fp32 scale (one fma into its totals); the scaled partials of
// all slices and groups are then summed in fp32 in a fixed order, and the
// result rounds once to the output type (bf16 for the projections, fp32 for
// the quality gate). So the scale multiplies each slice's partial, not the
// finished group sum as in the plain version (qmm_int4_plain): the two differ
// by fp32 rounding only. An ungrouped weight is one group of K rows.
//
// What bounds it on the H100: the work's least time is its device-memory
// bytes at the decode's M (2, 4, 8, 16): a packed fc1 (2048 x 16384, 16.8
// MB) takes >= 5 us at 3.35 TB/s. This design is bound instead by the CUDA
// cores' instruction issue: every weight costs ~3 instructions to become an
// exact float and M FMAs, so at M = 2 a launch runs ~4-7x its byte bound
// and at M = 16 ~15-30x (PERF.md, the qmm_int4 row). At the prefill's M
// (hundreds of rows) it rereads the weight once per 16 rows (from L2 for
// the most part). Tensor-core tiles are the redesign (ROADMAP).
//
// Design (simple first; the M <= 2 decode shape of qmm_int8.cu's CUDA-core
// kernel, generalised to chunks of MC rows of x):
//  * A block covers TN (32 or 64) columns, a stretch of `rows` rows of K and
//    MC (2, 4, 8 or 16) rows of x; grid (cs, N / TN, ceil(M / MC)). Where a
//    tile's rows exceed a block's budget, K is split inside a thread-block
//    cluster of cs blocks whose fp32 partials meet in distributed shared
//    memory in rank order (deterministic; nothing but the output reaches
//    device memory). The host plans (MC, TN, cs, rows) from the shapes and
//    the card's SM count (ops/cuda/qmm.py::int4_plan).
//  * Weight layout: uint8 [K, N / 2], byte j of a row holding column 2j in
//    its low nibble and 2j + 1 in its high nibble, each a two's-complement
//    value in [-7, 7]. A stage of 8 KB of tile rows is copied by 16-byte
//    cp.async.cg copies into a ring of NSTAGE = 4 stages, three in flight
//    (24 KB a block); rows past K or columns past N are zero-filled,
//    reading nothing.
//  * The block's rows are cut into RSC contiguous slices; thread t owns
//    slice t / CG and CPT = 32 / MC columns of it (MC x CPT = 32 sums), so a
//    thread walks its rows in order and crosses a group boundary at most
//    once every group: there it multiplies its fp32 group partial by the
//    group's scale into its totals. A stage holds RPS rows of every slice,
//    interleaved so that a warp's threads read neighbouring rows.
//  * x's rows of the block are staged once in shared memory, transposed to
//    [row of K][MC] bf16, so one vector load gives a row's MC values.
//  * Nibble -> fp32 exactly without the integer-to-float conversion: the
//    nibble with its sign bit flipped (value + 8) becomes the low mantissa
//    bits of 2^23, and one subtraction of 2^23 + 8 gives the value.
//  * The slices of a warp meet by shuffles, the warps in shared memory (the
//    drained ring), in a fixed order; then the cluster, as above.
//  * Programmatic dependent launch, as qmm_int8's M <= 2 kernel: the launch
//    may be scheduled while the previous kernel finishes and waits for it
//    (griddepcontrol.wait) before its first read.
//  * No host synchronisation and no allocation: a launch can be captured in
//    a CUDA graph. The shared-memory attribute is set once per device.
//
// Layouts (row-major): x bf16 [M, K]; w uint8 [K, N / 2]; scale fp32 [NG, N]
// (NG groups of K / NG rows); out [M, N] of OutT. N must be a multiple of 32
// (a 16-byte copy is 32 columns), K a multiple of NG.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_BYTES = 8192;
constexpr int NSTAGE = 4;
constexpr int MAX_CLUSTER = 8;          // portable cluster size
constexpr int MAX_BLOCK_SMEM = 232448;  // shared memory a block can have (227 KB)
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Nibble i of v (each nibble's sign bit already flipped) as an exact float.
__device__ __forceinline__ float nibble_to_float(uint32_t v, int i) {
  return __uint_as_float(((v >> (4 * i)) & 0xFu) | 0x4B000000u) - 8388616.0f;  // 2^23 + 8
}

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

// The CPT / 2 bytes of a thread's columns of one tile row, nibble signs flipped.
template <int CPT>
__device__ __forceinline__ void load_w(const uint8_t* p, uint32_t* wv) {
  if constexpr (CPT == 16) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    wv[0] = v.x ^ 0x88888888u;
    wv[1] = v.y ^ 0x88888888u;
  } else if constexpr (CPT == 8) {
    wv[0] = *reinterpret_cast<const uint32_t*>(p) ^ 0x88888888u;
  } else if constexpr (CPT == 4) {
    wv[0] = uint32_t(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8888u;
  } else {
    wv[0] = uint32_t(*p) ^ 0x88u;
  }
}

// A row's MC bf16 values of x (staged [row][MC]) as floats.
template <int MC>
__device__ __forceinline__ void load_x(const uint16_t* p, float* xf) {
  uint32_t v[MC / 2];
  if constexpr (MC == 2) {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (MC == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < MC / 8; ++i) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[i];
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  }
#pragma unroll
  for (int i = 0; i < MC / 2; ++i) {
    xf[2 * i] = __uint_as_float(v[i] << 16);
    xf[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// One cluster of gridDim.x blocks per (column tile, chunk of MC rows of x);
// block `rank` of the cluster sums rows [rank * rows, (rank + 1) * rows) of
// K. A launch without clusters (cs = 1) is a cluster of one block.
template <typename OutT, int MC, int TN>
__global__ void __launch_bounds__(THREADS) qmm_int4_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N, int NG,
    int rows) {
  constexpr int CPT = 32 / MC;          // columns of a thread
  constexpr int RB = TN / 2;            // bytes of a tile row
  constexpr int CG = TN / CPT;          // threads side by side on a row
  constexpr int RSC = THREADS / CG;     // row slices of a block
  constexpr int SR = STAGE_BYTES / RB;  // tile rows of a stage
  constexpr int RPS = SR / RSC;         // rows of each slice in a stage
  constexpr int CPR = RB / 16;          // 16-byte copies of a tile row
  constexpr int COPIES = STAGE_BYTES / 16;
  constexpr int NW = (CPT + 7) / 8;     // 32-bit words of a thread's row bytes
  static_assert(CG <= 32 && 32 % CG == 0, "a row's threads lie in one warp");
  static_assert(WARPS * MC * TN * 4 <= NSTAGE * STAGE_BYTES, "the reduction fits the ring");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                                   // [NSTAGE][SR][RB]
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + NSTAGE * STAGE_BYTES);  // [rows][MC]
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][MC][TN], once the ring is drained
  __shared__ __align__(16) float part[MC * TN];  // the block's partial, read by the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.y * TN;
  const int m0 = blockIdx.z * MC;
  const int k0 = rank * rows;
  const int k1 = min(K, k0 + rows);
  const int sl = rows / RSC;  // rows of a slice (a multiple of RPS)
  const int nst = rows / SR;
  const int gs = K / NG;
  const size_t pitch = static_cast<size_t>(N) / 2;

  // Programmatic dependent launch: the block may start while the previous
  // kernel on the stream finishes, and reads nothing before it is done.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // Stage s holds rows [s * RPS, (s + 1) * RPS) of every slice: tile row
  // ri of the stage is row ri / RSC of slice ri % RSC, so the threads of a
  // warp read neighbouring rows (no bank conflicts).
  auto issue = [&](int s) {
    uint8_t* dst = ring + (s % NSTAGE) * STAGE_BYTES;
#pragma unroll
    for (int c = tid; c < COPIES; c += THREADS) {
      const int ri = c / CPR;
      const int cb = (c % CPR) * 16;
      const int k = k0 + (ri % RSC) * sl + s * RPS + ri / RSC;
      const bool ok = k < k1 && n0 + 2 * cb < N;
      cp_async16(dst + ri * RB + cb, w + (ok ? k * pitch + n0 / 2 + cb : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  // While the first stages are in flight: x's rows of the block, zero past
  // k1 and past M, transposed to [row][MC] and ordered as the stages order
  // their rows (row t of slice r at t * RSC + r).
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  for (int i = tid; i < MC * rows; i += THREADS) {
    const int m = i / rows;
    const int kl = i - m * rows;
    const int k = k0 + kl;
    xs[((kl % sl) * RSC + kl / sl) * MC + m] =
        m0 + m < M && k < k1 ? xb[static_cast<size_t>(m0 + m) * K + k] : uint16_t(0);
  }

  const int rc = tid / CG;   // this thread's slice
  const int cgi = tid % CG;  // and column group
  const int col0 = n0 + cgi * CPT;
  const int ks = k0 + rc * sl;  // the slice's first row
  int g = ks / gs;
  int left = gs - ks % gs;  // rows of group g still to come
  float acc[MC][CPT], tot[MC][CPT];
#pragma unroll
  for (int m = 0; m < MC; ++m) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = tot[m][c] = 0.f;
  }
  // The finished group's partial times its scale, into the totals.
  auto flush = [&]() {
    if (g < NG && col0 < N) {
      float sc[CPT];
      const float* sp = scale + static_cast<size_t>(g) * N + col0;
      if constexpr (CPT >= 4) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sp + c);
          sc[c] = v.x;
          sc[c + 1] = v.y;
          sc[c + 2] = v.z;
          sc[c + 3] = v.w;
        }
      } else {
        const float2 v = *reinterpret_cast<const float2*>(sp);
        sc[0] = v.x;
        sc[1] = v.y;
      }
#pragma unroll
      for (int m = 0; m < MC; ++m) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) tot[m][c] = fmaf(acc[m][c], sc[c], tot[m][c]);
      }
    }
#pragma unroll
    for (int m = 0; m < MC; ++m) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;
    }
  };

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of stage `it` have landed
    __syncthreads();              // and everyone's; every thread is past stage it - 1
    if (it + NSTAGE - 1 < nst) issue(it + NSTAGE - 1);
    cp_async_commit();
    const uint8_t* st = ring + (it % NSTAGE) * STAGE_BYTES + rc * RB + cgi * (CPT / 2);
    const uint16_t* xr = xs + static_cast<size_t>(it * RPS * RSC + rc) * MC;
#pragma unroll 2
    for (int j = 0; j < RPS; ++j) {
      uint32_t wv[NW];
      load_w<CPT>(st + j * RSC * RB, wv);
      float xf[MC];
      load_x<MC>(xr + j * RSC * MC, xf);
      float wf[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) wf[c] = nibble_to_float(wv[c / 8], c % 8);
#pragma unroll
      for (int m = 0; m < MC; ++m) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(xf[m], wf[c], acc[m][c]);
      }
      if (--left == 0) {
        flush();
        ++g;
        left = gs;
      }
    }
  }
  cp_async_wait<0>();
  flush();  // the slice's last, unfinished group

  // The slices of a warp with the same column group meet by shuffles, then
  // the warps in shared memory (the drained ring), in a fixed order.
#pragma unroll
  for (int off = CG; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < MC; ++m) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) tot[m][c] += __shfl_xor_sync(0xffffffffu, tot[m][c], off);
    }
  }
  __syncthreads();
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MC; ++m) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[(warp * MC + m) * TN + cgi * CPT + c] = tot[m][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < MC * TN; e += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum += red[wi * MC * TN + e];
    part[e] = sum;
  }

  // The cluster's partials meet in distributed shared memory: block `rank`
  // sums its 1/cs slice of the tile's outputs over the ranks in order.
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  const int per = MC * TN / cs;
  for (int e = rank * per + tid; e < (rank + 1) * per; e += THREADS) {
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
    const int m = m0 + e / TN;
    const int n = n0 + e % TN;
    if (m < M && n < N) store(out + static_cast<size_t>(m) * N + n, sum);
  }
  if (cs > 1) {  // no block leaves while another still reads its partial
    cluster_arrive();
    cluster_wait();
  }
}

template <int MC, int TN>
constexpr int stage_rows() {
  return STAGE_BYTES / (TN / 2);
}

template <typename OutT, int MC, int TN>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                   int N, int NG, int cs, int rows, cudaStream_t s) {
  if (rows % stage_rows<MC, TN>() != 0) return cudaErrorInvalidValue;
  const int smem = NSTAGE * STAGE_BYTES + rows * MC * 2;
  if (smem + MC * TN * 4 > MAX_BLOCK_SMEM) return cudaErrorInvalidValue;
  auto* kernel = qmm_int4_kernel<OutT, MC, TN>;
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
  cfg.gridDim = dim3(cs, (N + TN - 1) / TN, (M + MC - 1) / MC);
  cfg.blockDim = dim3(THREADS);
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

template <typename OutT, int MC>
cudaError_t launch_tn(const void* x, const void* w, const void* scale, void* out, int M, int K,
                      int N, int NG, int tn, int cs, int rows, cudaStream_t s) {
  return tn == 64 ? launch<OutT, MC, 64>(x, w, scale, out, M, K, N, NG, cs, rows, s)
                  : launch<OutT, MC, 32>(x, w, scale, out, M, K, N, NG, cs, rows, s);
}

template <typename OutT>
cudaError_t launch_mc(const void* x, const void* w, const void* scale, void* out, int M, int K,
                      int N, int NG, int mc, int tn, int cs, int rows, cudaStream_t s) {
  switch (mc) {
    case 2: return launch_tn<OutT, 2>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
    case 4: return launch_tn<OutT, 4>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
    case 8: return launch_tn<OutT, 8>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
    default: return launch_tn<OutT, 16>(x, w, scale, out, M, K, N, NG, tn, cs, rows, s);
  }
}

}  // namespace

// As planned by ops/cuda/qmm.py::int4_plan: chunks of mc (2, 4, 8 or 16)
// rows of x, tiles of tn (32 or 64) columns, clusters of cs (1, 2, 4 or 8)
// blocks, `rows` rows of K per block (a multiple of a stage's rows, cs *
// rows >= K). out_f32: 1 for an fp32 output, 0 for bf16.
extern "C" int zvt_qmm_int4(const void* x, const void* w, const void* scale, void* out, int M,
                            int K, int N, int NG, int out_f32, int mc, int tn, int cs, int rows,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 32 != 0 || NG <= 0 || K % NG != 0 ||
      (mc != 2 && mc != 4 && mc != 8 && mc != 16) || (tn != 32 && tn != 64) || cs <= 0 ||
      cs > MAX_CLUSTER || (cs & (cs - 1)) != 0 || rows <= 0 || (long long)cs * rows < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_f32 ? launch_mc<float>(x, w, scale, out, M, K, N, NG, mc, tn, cs, rows, s)
              : launch_mc<__nv_bfloat16>(x, w, scale, out, M, K, N, NG, mc, tn, cs, rows, s);
  return (int)err;
}
