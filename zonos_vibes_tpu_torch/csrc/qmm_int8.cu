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
// What bounds it on the H100, by regime of M (the rows of x):
//  * M <= 16 (decode: M = 2, the CFG pair; the 8-slot pool's step: M = 16):
//    device-memory bytes. Each weight byte is streamed once and used for
//    2 * M <= 32 flops, far under the ~295 flops per byte at which the bf16
//    tensor cores would take over; one fc2 weight (8192 x 2048 int8, 16.8 MB)
//    takes >= 5 us at 3.35 TB/s. The time goes to keeping enough weight bytes
//    in flight on every SM.
//  * M = 176 (a prefill, 2 * (cond_len + 1)): each weight byte serves 176
//    rows, 352 flops per byte: the tensor cores' rate is approached and the
//    bytes still matter (fc1: 12 us of flops, 10 us of bytes).
//
// What the design does about it, for M <= 2 (decode; CUDA cores; one
// launch, no workspace, no counters):
//  * A block covers a tile of TN columns (32 or 64) and ~64-128 KB of
//    the weight's rows, so one launch at the decode shapes is 64-324 blocks
//    that each walk a long stretch of K: the per-block cost (the launch, the
//    first load's latency, the partials' reduction) is paid once for many
//    bytes, and narrow tiles give enough blocks without splitting K. The
//    host plans (TN, CS, rows) from (M, K, N, G) alone
//    (ops/cuda/qmm.py::decode_plan).
//  * Where K is too long for one block (fc2's 8192 rows), it is split inside
//    a thread-block cluster of CS blocks (at most 8, the portable size):
//    block `rank` takes rows [rank * rows, (rank + 1) * rows). After a cluster barrier the blocks sum their fp32 partials
//    through distributed shared memory, each block a 1/CS slice of the
//    tile's outputs, in rank order, so the sum is deterministic and nothing
//    but the output reaches device memory. On an H100 a cluster launch of
//    long blocks costs microseconds of scheduling (`PERF.md`, row 4), so the
//    plan keeps clusters as small as the block size allows.
//  * Weights are streamed into shared memory by 16-byte cp.async.cg copies
//    in a ring of STAGES stages of 4 KB (RS = 4096 / TN rows each): 16 KB
//    in flight per block whatever the registers, one to four blocks per SM
//    (more stages were slower in the sweeps; so were 128-column tiles,
//    though a 32-column tile reads only 32 bytes of each row: the
//    neighbouring tiles read the rest of the row at about the same time). Each thread copies the same 16 bytes of every stage's rows (row
//    tid / (TN / 16), columns 16 (tid % (TN / 16))) and is the only one to
//    read them, so its own cp.async.wait_group is the only wait: no block
//    barrier in the loop. Rows past K (or columns past N) are zero-filled,
//    reading nothing.
//  * x's slice of the block's rows is staged once in shared memory as bf16
//    pairs (row 0 in the low half, row 1 in the high half; 0 for M = 1), one
//    32-bit load per weight row gives both rows' values.
//  * int8 -> fp32 by byte permutation: the byte (sign bit flipped) becomes
//    the low mantissa byte of 2^23, and one subtraction gives the exact
//    value, which avoids the quarter-rate integer-to-float conversion.
//  * Each thread keeps fp32 accumulators for its 16 columns of both rows;
//    the row slices of a warp meet by shuffles, the warps in shared memory
//    (the ring, once drained), in a fixed order.
//  * Programmatic dependent launch: the launch may be scheduled while the
//    previous kernel on the stream is finishing, and waits for it
//    (griddepcontrol.wait) before any read, so nothing the previous kernel
//    writes is read early. This hides most of the gap between a launch and
//    the kernel before it, whatever that kernel is (`PERF.md`, row 4);
//    loading the weights before the wait gained nothing more.
// For M > 2 (the pool's step and the prefill; tensor cores):
//  * Row tiles fitted to M: BM = 16 rows (exactly one m16n8k16 row tile) for
//    M <= 16, so no warp multiplies zero rows at the pool's M = 16; BM = 64
//    for larger M. A block covers BM rows x 128 columns; each of its 4 warps
//    owns 32 columns and all BM rows.
//  * Split-K through a workspace: the rows of W are cut into splits of a
//    multiple of 128 until the grid holds at least one block per SM (the
//    card's count, passed in by the host), and up
//    to two while each split keeps >= 512 rows (more splits cost more partials to
//    sum; this rule was the fastest of those timed, `PERF.md`, row 4). The
//    last block of an output tile to arrive sums the fp32 partials in split
//    order, all of a split's loads issued together. The plan depends only on
//    (BM, ceil(M / BM), K, N, G); each output row's value depends only on
//    its own row of x, so a row's result does not change with the others.
//  * Weights stay int8 in shared memory: a 4-stage ring of 64 x 128 byte
//    tiles (32 KB of weights in flight per block) filled by 16-byte
//    cp.async.cg copies, with the x tile ([BM, 64] bf16) in the same stage.
//    ldmatrix.trans on the int8 tile, read as 16-bit pairs, hands each
//    thread W[2t][2g..2g+1] and W[2t+1][2g..2g+1]; the even and odd columns
//    become two n8 tiles of the mma B operand, widened to bf16 in registers
//    by the byte permutation above (exact), so shared memory carries one
//    byte per weight. x fragments come from ldmatrix on the x tile.
//  * mma.sync m16n8k16, bf16 in, fp32 accumulate; each thread ends holding 4
//    adjacent columns of 2 rows. wgmma and TMA are later work.
//
// Layouts (row-major): x bf16 [M, K]; w int8 [G, K, N]; scale fp32 [G, 1, N];
// out [M, G, N] of OutT. N must be a multiple of 16. For M > 2, ws fp32 and
// counters int32 (zero before the first launch) as sized by
// zvt_qmm_int8_workspace and zvt_qmm_int8_tiles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS_PER_THREAD = 16;  // one 16-byte load of a W row
constexpr int TILE_N = 128;          // the tensor-core kernel's columns per block
constexpr int MAX_DEVICES = 64;      // devices whose shared-memory attribute is tracked
constexpr int MT = 2;                // the CUDA-core kernel's rows: the CFG pair
// CUDA-core kernel: 8 warps, a ring of STAGES stages of STAGE_BYTES.
constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int STAGE_BYTES = DEC_THREADS * 16;
constexpr int STAGES = 4;
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int MAX_BLOCK_SMEM = 232448;  // shared memory a block can have (227 KB)
// Tensor-core kernel: K steps of 64 rows, 4 stages in flight, 4 warps.
constexpr int MMA_BK = 64;
constexpr int MMA_SPLIT = 2 * MMA_BK;  // a split's rows: a multiple of this
constexpr int MMA_STAGES = 4;
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int W_PITCH = TILE_N + 16;  // bytes per int8 weight row in shared memory
constexpr int X_PITCH = MMA_BK + 8;   // bf16 per x row in shared memory

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Byte i of v (a signed int8 whose sign bit was flipped) as an exact float.
__device__ __forceinline__ float byte_to_float(uint32_t v, int i) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540u + i)) - 8388736.0f;  // 2^23 + 128
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// Two exact floats (small integers) as the bf16 pair {lo, hi}: their top halves.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// ldmatrix.trans of int8 rows read as 16-bit pairs gives a thread the bytes
// {W[2t][2g], W[2t][2g+1], W[2t+1][2g], W[2t+1][2g+1]} of one 8-row half of
// the k16 step (lo: k rows 0-7, hi: 8-15). The even columns make one n8
// tile's B fragment, the odd ones another.
__device__ __forceinline__ void widen(uint32_t lo, uint32_t hi, uint32_t* even, uint32_t* odd) {
  const uint32_t w[2] = {lo ^ 0x80808080u, hi ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    even[i] = pack_bf16(byte_to_float(w[i], 0), byte_to_float(w[i], 2));
    odd[i] = pack_bf16(byte_to_float(w[i], 1), byte_to_float(w[i], 3));
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The CUDA-core kernel (M <= MT): one cluster of `gridDim.x` blocks per
// output tile of TN columns of weight g = blockIdx.z; block `rank` of the
// cluster sums rows [rank * rows, (rank + 1) * rows) of K. A launch without
// clusters (cs = 1) is a cluster of one block.
template <typename OutT, int TN, int NSTAGE>
__global__ void __launch_bounds__(DEC_THREADS) qmm_int8_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N, int G,
    int rows) {
  constexpr int CG = TN / COLS_PER_THREAD;  // threads side by side on a row
  constexpr int RS = DEC_THREADS / CG;      // rows of a stage
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                                   // [NSTAGE][RS][TN]
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + NSTAGE * STAGE_BYTES);  // [rows] pairs
  float* red = reinterpret_cast<float*>(smem);  // [DEC_WARPS][MT][TN], once the ring is drained
  __shared__ float part[MT * TN];               // the block's partial, read by the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid / CG;
  const int cgi = tid % CG;
  const int n0 = blockIdx.y * TN;
  const int g = blockIdx.z;
  const int col = n0 + cgi * COLS_PER_THREAD;
  const int k0 = rank * rows;
  const int k1 = min(K, k0 + rows);
  const int nst = k1 > k0 ? (k1 - k0 + RS - 1) / RS : 0;
  const int8_t* wg = w + (size_t)g * K * N;

  // Programmatic dependent launch: the block may start while the previous
  // kernel on the stream finishes, and reads nothing before it is done.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  auto issue = [&](int it) {
    const int k = k0 + it * RS + r;
    const bool ok = k < k1 && col < N;
    cp_async16(ring + (it % NSTAGE) * STAGE_BYTES + tid * 16, wg + (ok ? (size_t)k * N + col : 0),
               ok);
  };
#pragma unroll
  for (int s = 0; s < NSTAGE; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  // While the first stages are in flight: the scale of the output this
  // thread writes (block `rank` writes its 1/cs slice of the tile's MT x TN
  // outputs), and x's rows of the block as (row 0, row 1) bf16 pairs, zero
  // past k1.
  const int per = MT * TN / cs;
  const int e_out = rank * per + tid;
  const int m_out = e_out / TN;
  const int n_out = n0 + e_out % TN;
  const bool writes = tid < per && m_out < M && n_out < N;
  const float sc = writes ? scale[(size_t)g * N + n_out] : 0.f;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  for (int i = tid; i < nst * RS; i += DEC_THREADS) {
    const int k = k0 + i;
    uint32_t v = 0;
    if (k < k1) v = xb[k] | (M > 1 ? uint32_t(xb[K + k]) << 16 : 0u);
    xs[i] = v;
  }
  __syncthreads();

  float acc[MT][COLS_PER_THREAD];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) acc[m][c] = 0.f;
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<NSTAGE - 1>();  // this thread's copy of stage `it` has landed
    const uint4 wv = *reinterpret_cast<const uint4*>(ring + (it % NSTAGE) * STAGE_BYTES + tid * 16);
    const uint32_t xp = xs[it * RS + r];
    const float x0 = __uint_as_float(xp << 16);
    const float x1 = __uint_as_float(xp & 0xffff0000u);
    // The slot is free once read: the next copy into it is this thread's own.
    if (it + NSTAGE < nst) issue(it + NSTAGE);
    cp_async_commit();
    const uint32_t words[4] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u, wv.z ^ 0x80808080u,
                               wv.w ^ 0x80808080u};
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) {
      const float wf = byte_to_float(words[c / 4], c % 4);
      acc[0][c] = fmaf(x0, wf, acc[0][c]);
      acc[1][c] = fmaf(x1, wf, acc[1][c]);
    }
  }
  cp_async_wait<0>();

  // The warp's row slices (lanes of one column group) meet by shuffles, then
  // the warps in shared memory (the drained ring), in a fixed order.
#pragma unroll
  for (int off = CG; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
    }
  }
  __syncthreads();
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; c += 4)
        *reinterpret_cast<float4*>(red + (warp * MT + m) * TN + cgi * COLS_PER_THREAD + c) =
            make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
    }
  }
  __syncthreads();
  for (int e = tid; e < MT * TN; e += DEC_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < DEC_WARPS; ++wi) sum += red[wi * MT * TN + e];
    part[e] = sum;
  }

  // The cluster's partials meet in distributed shared memory: block `rank`
  // sums its slice over the ranks in order.
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  float sum = 0.f;
  if (tid < per) {
    if (cs > 1) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        v[q] = q < cs ? *cluster.map_shared_rank(part + e_out, q) : 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q) sum += v[q];
    } else {
      sum = part[e_out];
    }
  }
  if (cs > 1) cluster_arrive();  // this block is done reading the others' partials
  if (writes) store(out + ((size_t)m_out * G + g) * N + n_out, sum * sc);
  if (cs > 1) cluster_wait();  // no block leaves while another still reads its partial
}

template <typename OutT, int TN, int NSTAGE = STAGES>
cudaError_t launch_decode(const __nv_bfloat16* x, const int8_t* w, const float* scale, OutT* out,
                          int M, int K, int N, int G, int cs, int rows, cudaStream_t s) {
  constexpr int RS = DEC_THREADS / (TN / COLS_PER_THREAD);
  const int smem = NSTAGE * STAGE_BYTES + (rows + RS - 1) / RS * RS * 4;
  if (smem + MT * TN * 4 > MAX_BLOCK_SMEM) return cudaErrorInvalidValue;
  auto* kernel = qmm_int8_decode_kernel<OutT, TN, NSTAGE>;
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
  cfg.gridDim = dim3(cs, (N + TN - 1) / TN, G);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  // Programmatic dependent launch: the blocks may be scheduled while the
  // previous kernel on the stream finishes (the kernel waits for it before
  // its first read).
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cs;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 2 : 1;  // a launch without clusters is cheaper to dispatch
  e = cudaLaunchKernelEx(&cfg, kernel, x, w, scale, out, M, K, N, G, rows);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The tensor-core kernel's launch (M > MT): BM rows per block.
struct MmaPlan {
  int bm, mblocks, ntiles, splits, rows;
};

// `sms`: the card's SM count.
MmaPlan make_mma_plan(int M, int K, int N, int G, int sms) {
  MmaPlan p;
  p.bm = M <= 16 ? 16 : 64;
  p.mblocks = (M + p.bm - 1) / p.bm;
  p.ntiles = (N + TILE_N - 1) / TILE_N;
  // At least one block per SM, and up to two while each split keeps >= 512
  // rows: more splits cost more partials to sum, fewer leave bytes unasked.
  const int base = p.mblocks * p.ntiles * G;
  const int fill = (sms + base - 1) / base;
  const int deep = min(2 * sms / base, K / 512);
  const int want = max(1, min(max(fill, deep), (K + MMA_SPLIT - 1) / MMA_SPLIT));
  p.rows = ((K + want - 1) / want + MMA_SPLIT - 1) / MMA_SPLIT * MMA_SPLIT;
  p.splits = (K + p.rows - 1) / p.rows;
  return p;
}

template <int BM>
__host__ __device__ constexpr int mma_stage_bytes() {
  return MMA_BK * W_PITCH + BM * X_PITCH * 2;
}

// X_VEC: K % 8 == 0, so x rows are 16-byte aligned and copied with cp.async;
// otherwise x is staged by plain loads.
template <typename OutT, int BM, bool X_VEC>
__global__ void __launch_bounds__(MMA_THREADS) qmm_int8_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int M, int K, int N, int G, int rows, int splits) {
  constexpr int MTILES = BM / 16;
  constexpr int STAGE = mma_stage_bytes<BM>();
  extern __shared__ __align__(16) uint8_t smem[];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * TILE_N;
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wn = warp * 32;  // the warp's 32 columns
  const int k_begin = split * rows;
  const int k_end = min(K, k_begin + rows);
  const int nk = (k_end - k_begin + MMA_BK - 1) / MMA_BK;
  const int8_t* wg = w + (size_t)g * K * N;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);

  // Stage s: the int8 weight tile [64][W_PITCH] then the x tile [BM][X_PITCH].
  auto load = [&](int it, int s) {
    uint8_t* wt = smem + s * STAGE;
    uint16_t* xt = reinterpret_cast<uint16_t*>(wt + MMA_BK * W_PITCH);
    const int k0 = k_begin + it * MMA_BK;
    for (int c = threadIdx.x; c < MMA_BK * (TILE_N / 16); c += MMA_THREADS) {
      const int r = c / (TILE_N / 16);
      const int cc = (c % (TILE_N / 16)) * 16;
      const int k = k0 + r;
      const bool ok = k < k_end && n0 + cc < N;
      cp_async16(wt + r * W_PITCH + cc, wg + (ok ? (size_t)k * N + n0 + cc : 0), ok);
    }
    if constexpr (X_VEC) {
      for (int c = threadIdx.x; c < BM * (MMA_BK / 8); c += MMA_THREADS) {
        const int r = c / (MMA_BK / 8);
        const int kc = (c % (MMA_BK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + kc < k_end;
        cp_async16(xt + r * X_PITCH + kc, xb + (ok ? (size_t)(m0 + r) * K + k0 + kc : 0), ok);
      }
    } else {
      for (int e = threadIdx.x; e < BM * MMA_BK; e += MMA_THREADS) {
        const int r = e / MMA_BK;
        const int kc = e % MMA_BK;
        xt[r * X_PITCH + kc] =
            m0 + r < M && k0 + kc < k_end ? xb[(size_t)(m0 + r) * K + k0 + kc] : uint16_t(0);
      }
    }
  };

  float acc[MTILES][4][4];
#pragma unroll
  for (int i = 0; i < MTILES; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();
    // Every warp is past step it - 1, whose stage the next load reuses.
    if (it + MMA_STAGES - 1 < nk) load(it + MMA_STAGES - 1, (it + MMA_STAGES - 1) % MMA_STAGES);
    cp_async_commit();
    const uint8_t* wt = smem + (it % MMA_STAGES) * STAGE;
    const uint16_t* xt = reinterpret_cast<const uint16_t*>(wt + MMA_BK * W_PITCH);
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      uint32_t a[MTILES][4];
#pragma unroll
      for (int i = 0; i < MTILES; ++i)
        ldmatrix_x4(a[i], xt + (i * 16 + (lane & 15)) * X_PITCH + kk + (lane >> 4) * 8);
      // Lanes 0-7, 8-15, 16-23, 24-31 address the rows of (k 0-7, columns
      // wn..wn+15), (k 8-15, wn..), (k 0-7, wn+16..), (k 8-15, wn+16..).
      uint32_t r[4];
      ldmatrix_x4_trans(r, wt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * W_PITCH + wn +
                               (lane >> 4) * 16);
      uint32_t b[4][2];
      widen(r[0], r[1], b[0], b[1]);
      widen(r[2], r[3], b[2], b[3]);
#pragma unroll
      for (int i = 0; i < MTILES; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
  }
  cp_async_wait<0>();

  // A thread holds rows gid and gid + 8 of each row tile, columns
  // wn + 16 jj + 4 tig + {0, 1, 2, 3} from (tile 2 jj, e), (2 jj + 1, e),
  // (2 jj, e + 1), (2 jj + 1, e + 1).
  __shared__ int is_last;
  const size_t tile = ((size_t)g * gridDim.x + blockIdx.x) * gridDim.y + blockIdx.y;
  float* tile_ws = ws + tile * splits * (BM * TILE_N);
  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = i * 16 + gid + 8 * hf;
          const int c = wn + 16 * jj + 4 * tig;
          *reinterpret_cast<float4*>(tile_ws + split * (BM * TILE_N) + r * TILE_N + c) =
              make_float4(acc[i][2 * jj][2 * hf], acc[i][2 * jj + 1][2 * hf],
                          acc[i][2 * jj][2 * hf + 1], acc[i][2 * jj + 1][2 * hf + 1]);
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // The partials summed in split order; each split's loads are issued
    // together (and two splits' at once) so the sum waits on few latencies.
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
#pragma unroll 2
    for (int sp = 0; sp < splits; ++sp) {
      float4 p[MTILES][2][2];
#pragma unroll
      for (int i = 0; i < MTILES; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            p[i][jj][hf] = __ldcg(reinterpret_cast<const float4*>(
                tile_ws + sp * (BM * TILE_N) + (i * 16 + gid + 8 * hf) * TILE_N + wn + 16 * jj +
                4 * tig));
        }
      }
#pragma unroll
      for (int i = 0; i < MTILES; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            acc[i][2 * jj][2 * hf] += p[i][jj][hf].x;
            acc[i][2 * jj + 1][2 * hf] += p[i][jj][hf].y;
            acc[i][2 * jj][2 * hf + 1] += p[i][jj][hf].z;
            acc[i][2 * jj + 1][2 * hf + 1] += p[i][jj][hf].w;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MTILES; ++i) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = i * 16 + gid + 8 * hf;
        const int c = wn + 16 * jj + 4 * tig;
        const float v[4] = {acc[i][2 * jj][2 * hf], acc[i][2 * jj + 1][2 * hf],
                            acc[i][2 * jj][2 * hf + 1], acc[i][2 * jj + 1][2 * hf + 1]};
        const int m = m0 + r;
        const int n = n0 + c;  // N % 16 == 0: the 4 columns are all in or all out
        if (m < M && n < N) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            store(out + ((size_t)m * G + g) * N + n + e, v[e] * scale[(size_t)g * N + n + e]);
        }
      }
    }
  }
  if (splits > 1 && threadIdx.x == 0) counters[tile] = 0;
}

template <typename OutT, int BM, bool X_VEC>
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* w, const float* scale, OutT* out,
                       float* ws, int* counters, int M, int K, int N, int G, const MmaPlan& p,
                       cudaStream_t s) {
  constexpr int SMEM = MMA_STAGES * mma_stage_bytes<BM>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static unsigned long long configured = 0;  // devices whose attribute is set
  if (!(configured >> dev & 1ull)) {
    e = cudaFuncSetAttribute(qmm_int8_mma_kernel<OutT, BM, X_VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    configured |= 1ull << dev;
  }
  const dim3 grid(p.mblocks, p.ntiles, G * p.splits);
  qmm_int8_mma_kernel<OutT, BM, X_VEC><<<grid, MMA_THREADS, SMEM, s>>>(
      x, w, scale, out, ws, counters, M, K, N, G, p.rows, p.splits);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                   void* counters, int M, int K, int N, int G, int sms, cudaStream_t s) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  const MmaPlan p = make_mma_plan(M, K, N, G, sms);
  const bool vec = K % 8 == 0;
  if (p.bm == 16)
    return vec ? launch_mma<OutT, 16, true>(xp, wp, sp, op, wsp, cp, M, K, N, G, p, s)
               : launch_mma<OutT, 16, false>(xp, wp, sp, op, wsp, cp, M, K, N, G, p, s);
  return vec ? launch_mma<OutT, 64, true>(xp, wp, sp, op, wsp, cp, M, K, N, G, p, s)
             : launch_mma<OutT, 64, false>(xp, wp, sp, op, wsp, cp, M, K, N, G, p, s);
}

template <typename OutT>
cudaError_t launch_decode_tn(const void* x, const void* w, const void* scale, void* out, int M,
                             int K, int N, int G, int tn, int cs, int rows, cudaStream_t s) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  return tn == 64 ? launch_decode<OutT, 64>(xp, wp, sp, op, M, K, N, G, cs, rows, s)
                  : launch_decode<OutT, 32>(xp, wp, sp, op, M, K, N, G, cs, rows, s);
}

}  // namespace

// The tensor-core path (M > 2) on a card of `sms` SMs. Output tiles of a
// launch: the counters it needs.
extern "C" int zvt_qmm_int8_tiles(int M, int K, int N, int G, int sms) {
  const MmaPlan p = make_mma_plan(M, K, N, G, sms);
  return p.mblocks * p.ntiles * G;
}

// The tensor-core path's fp32 workspace floats (0 when the rows are not split).
extern "C" int zvt_qmm_int8_workspace(int M, int K, int N, int G, int sms) {
  const MmaPlan p = make_mma_plan(M, K, N, G, sms);
  return p.splits > 1 ? p.mblocks * p.ntiles * G * p.splits * p.bm * TILE_N : 0;
}

// M > 2, on tensor cores, planned for a card of `sms` SMs (the same count
// as zvt_qmm_int8_tiles and zvt_qmm_int8_workspace were given). out_f32: 1
// for an fp32 output, 0 for bf16.
extern "C" int zvt_qmm_int8(const void* x, const void* w, const void* scale, void* out,
                            void* ws, void* counters, int M, int K, int N, int G, int out_f32,
                            int sms, void* stream) {
  if (M <= MT || K <= 0 || N <= 0 || G <= 0 || N % COLS_PER_THREAD != 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_f32 ? launch<float>(x, w, scale, out, ws, counters, M, K, N, G, sms, s)
              : launch<__nv_bfloat16>(x, w, scale, out, ws, counters, M, K, N, G, sms, s);
  return (int)err;
}

// M <= 2, on CUDA cores, as planned by ops/cuda/qmm.py::decode_plan: tiles of
// tn (32 or 64) columns, clusters of cs (1, 2, 4 or 8) blocks, `rows` rows
// of K per block (cs * rows >= K).
extern "C" int zvt_qmm_int8_decode(const void* x, const void* w, const void* scale, void* out,
                                   int M, int K, int N, int G, int out_f32, int tn, int cs,
                                   int rows, void* stream) {
  if (M <= 0 || M > MT || K <= 0 || N <= 0 || G <= 0 || N % COLS_PER_THREAD != 0 ||
      (tn != 32 && tn != 64) || cs <= 0 || cs > MAX_CLUSTER || (cs & (cs - 1)) != 0 ||
      rows <= 0 || (long long)cs * rows < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_f32 ? launch_decode_tn<float>(x, w, scale, out, M, K, N, G, tn, cs, rows, s)
              : launch_decode_tn<__nv_bfloat16>(x, w, scale, out, M, K, N, G, tn, cs, rows, s);
  return (int)err;
}
