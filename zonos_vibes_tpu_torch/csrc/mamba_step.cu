// Fused Mamba-2 decode step: state update, C.h readout, D skip, silu(z) gate
// and the gated RMSNorm, on one plane of a stacked SSM state, in place. One
// launch per call.
//
// Replaces: zonos_vibes_tpu/ops/pallas/mamba_step.py::ssd_gate_step_pallas
//   (a TPU grid over batch rows, one [N, H*P] state block per row held in
//   VMEM across the whole chain, per-head scalars pre-expanded to lanes) and
//   ssd_gate_step_layered_pallas, the same kernel on plane `layer` of a
//   stacked [R, B, N, H*P] state aliased in place. Here one kernel serves
//   both: the single-plane entry is the stacked one with R = 1.
//
// Per batch row b, head h = col / P, state row n (d_state) and column col
// of d_inner = H * P:
//   h[n, col] = h[n, col] * decay[b, h] + B[b, n] * dt[b, h] * x[b, col]
//   y[col]    = sum_n C[b, n] * h[n, col] + D[h] * x[b, col]
//   g[col]    = y[col] * silu(z[b, col])
//   out[col]  = g[col] * rsqrt(mean_col(g^2) + eps) * w[col]
// The recurrence and y stay fp32 (the state is read and written in its
// storage type, fp32 or bf16); out is bf16.
//
// What bounds it on the H100: device-memory bytes. The state plane is read
// once and written once: N * H * P * 4 bytes a row in fp32 (2 MB at the
// hybrid's N = 128, H * P = 4096), so 8.4 MB per call for the solo step's 2
// CFG rows (2.5 us at 3.35 TB/s) and 67 MB for the 8-slot pool's 16 rows
// (20 us); half that with a bf16 state. Everything else is a few KB. At the
// solo step's size the launch and the latency of each dependent round trip
// weigh as much as the bytes.
//
// What the design does about it:
//  * One block per (column tile of TC columns, batch row), all N state rows
//    of the tile in the block. The host plans TC (128, 64 or 32) from (B,
//    HP) alone (ops/cuda/mamba_step.py::step_plan): the widest tile whose
//    grid still puts a block on every SM, so the solo step's 2 rows put 256
//    blocks of 32 columns on the card and the pool's 16 rows 512 of 128.
//    Splitting the state rows across a thread-block cluster, whose blocks
//    then meet y in distributed shared memory, was measured slower at every
//    hybrid shape on an H100 (`PERF.md`, rows 9/10): a cluster launch costs
//    more than the extra blocks gain.
//  * A thread owns one 16-byte chunk of a state row (4 fp32 or 8 bf16
//    columns; neighbouring lanes on neighbouring addresses) in every RP-th
//    row of the tile. It streams them through a ring of RING chunks in
//    shared memory filled by cp.async, so the block's loads are in flight
//    without registers; each chunk is then updated, added into y and
//    written back with one 16-byte store, which needs no register once
//    issued, so the stores of one block overlap the loads of the others.
//    Plane `layer` is the only state memory written.
//  * y: the block's row groups meet in shared memory in a fixed order. One
//    thread per column adds the D skip, applies the gate, and writes g
//    (fp32) to a per-device workspace; the block's sum of g^2 goes beside.
//  * The gated RMSNorm spans all H * P columns of a row, many blocks: each
//    block takes a ticket per batch row (the block's barrier, then one
//    thread's acq_rel atomic); the last of the row's blocks sums the tiles'
//    partials in tile order, normalises the row's g from the workspace
//    (every load issued at once), writes out and resets the ticket to 0.
//    The order of every sum is fixed, so the result does not depend on
//    block scheduling.
//  * The partial-norm mode (sumsq non-null) serves a head-sharded mixer
//    under tensor parallelism, whose gated RMSNorm spans every rank's
//    heads: no rank can normalise alone. The same update, readout and gate;
//    the last block of a row writes bf16(g * w) for the row's columns and
//    the row's fp32 sum of g^2 (the tiles' partials in the same fixed
//    order) to sumsq[b], and resets the ticket. The norm's scale
//    rsqrt(sum over ranks / d_inner + eps) is one scalar per row, so it
//    commutes with the row-parallel out_proj: the caller sums every rank's
//    out_proj(g * w) and sum of g^2 in one all-reduce and scales after
//    (models/mamba_backbone.py, the norm fold).
//  * Programmatic dependent launch: the launch may be scheduled while the
//    previous kernel on the stream is finishing; the kernel waits for it
//    (griddepcontrol.wait) before its first read.
//
// Layouts (row-major): states [R, B, N, HP] fp32 or bf16; xs, z [B, HP]
// bf16; dt, decay [B, H] fp32; bm, cm [B, N] fp32; d_skip [H] fp32;
// norm_w [HP] bf16; out [B, HP] bf16; sumsq [B] fp32 or null. Workspace:
// g [B, HP] fp32, then the tiles' partials [B, HP / TC] fp32; tickets [B]
// int32, zero before the first launch and left zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RING = 8;          // 16-byte chunks a thread has in flight: 32 KB a block
constexpr int MAX_ROWS = 256;    // state rows of a block
constexpr int MAX_NORM_ROUNDS = 8;  // HP <= 8192

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// A 16-byte chunk of a state row as floats, and back.
template <typename StateT>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void load(const void* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ static void store(void* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const void* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(void* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of one value per thread over the block, in a fixed order; every
// thread gets it. `scratch` holds WARPS floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += scratch[w];
  return s;
}

// Grid (HP / TC, B).
template <typename StateT, int TC>
__global__ void __launch_bounds__(THREADS) ssd_step_kernel(
    StateT* __restrict__ plane, const __nv_bfloat16* __restrict__ xs,
    const float* __restrict__ dt, const float* __restrict__ decay,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ d_skip,
    const __nv_bfloat16* __restrict__ norm_w, __nv_bfloat16* __restrict__ out,
    float* __restrict__ sumsq, float* __restrict__ ws, int* __restrict__ tickets, int B, int N,
    int HP, int H, float eps) {
  using C = Chunk<StateT>;
  constexpr int E = C::E;            // columns of a chunk
  constexpr int TPR = TC / E;        // threads on a row
  constexpr int RP = THREADS / TPR;  // rows a pass of the block covers
  constexpr int NORM = 4;            // columns per thread and round of the norm
  __shared__ __align__(16) uint8_t ring[RING * THREADS * 16];  // 16-byte chunks
  __shared__ float red[RP][TC];
  __shared__ float sb[MAX_ROWS], sc[MAX_ROWS];
  __shared__ float scratch[WARPS];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int tile_i = blockIdx.x;
  const int b = blockIdx.y;
  const int chunks = N / RP;
  const int rg = tid / TPR;
  const int cc = tid % TPR;
  const int col0 = tile_i * TC;
  const int col = col0 + cc * E;
  const int P = HP / H;

  // Programmatic dependent launch: the block may start while the previous
  // kernel on the stream finishes, and reads nothing before it is done.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  StateT* s = plane + (size_t)b * N * HP + col;
  auto issue = [&](int j) {
    cp_async16(ring + (size_t)((j % RING) * THREADS + tid) * 16, s + (size_t)(rg + j * RP) * HP);
  };
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    if (j < chunks) issue(j);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // While the state is in flight: B and C of the row, this thread's dt * x,
  // and what the gate of one column per thread needs (z, x and D).
  for (int i = tid; i < N; i += THREADS) {
    sb[i] = bm[(size_t)b * N + i];
    sc[i] = cm[(size_t)b * N + i];
  }
  const int head = col / P;  // P % E == 0: a chunk's columns share a head
  const float dec = decay[b * H + head];
  const float dtv = dt[b * H + head];
  float dtx[E], y[E];
#pragma unroll
  for (int c = 0; c < E; ++c) {
    dtx[c] = dtv * bf16_at(xs, b * HP + col + c);
    y[c] = 0.f;
  }
  const bool gates = tid < TC;
  const int gcol = col0 + tid;
  float zz = 0.f, dx = 0.f;
  if (gates) {
    zz = bf16_at(z, b * HP + gcol);
    dx = d_skip[gcol / P] * bf16_at(xs, b * HP + gcol);
  }
  __syncthreads();

  for (int j = 0; j < chunks; ++j) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");  // chunk j landed
    const int r = rg + j * RP;
    float h[E];
    C::load(ring + (size_t)((j % RING) * THREADS + tid) * 16, h);
    if (j + RING < chunks) issue(j + RING);  // the slot is this thread's own
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float bn = sb[r], cn = sc[r];
#pragma unroll
    for (int c = 0; c < E; ++c) {
      h[c] = h[c] * dec + bn * dtx[c];
      y[c] += cn * h[c];
    }
    C::store(s + (size_t)r * HP, h);
  }

  // The block's row groups in order, then the gate, one column a thread.
#pragma unroll
  for (int c = 0; c < E; ++c) red[rg][cc * E + c] = y[c];
  __syncthreads();
  float gv = 0.f;
  if (gates) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < RP; ++g) acc += red[g][tid];
    gv = (acc + dx) * (zz / (1.f + expf(-zz)));
  }
  const int parts = gridDim.x;
  float* g_ws = ws + (size_t)b * HP;
  float* part_ws = ws + (size_t)B * HP + (size_t)b * parts;
  if (gates) g_ws[gcol] = gv;
  const float ss = block_sum(gv * gv, scratch);
  if (tid == 0) part_ws[tile_i] = ss;

  // The last block of row b to arrive normalises the whole row: the barrier
  // orders the block's writes before thread 0's release, its acquire orders
  // the other blocks' before the barrier after it.
  __syncthreads();
  if (tid == 0) s_last = atomic_add_acq_rel(&tickets[b], 1) == parts - 1;
  __syncthreads();
  if (!s_last) return;
  // The partials and the row's g and w, all loads issued together.
  float p = 0.f;
  for (int i = tid; i < parts; i += THREADS) p += __ldcg(part_ws + i);
  const int rounds = (HP + THREADS * NORM - 1) / (THREADS * NORM);
  float4 gg[MAX_NORM_ROUNDS];
  uint2 ww[MAX_NORM_ROUNDS];
#pragma unroll
  for (int k = 0; k < MAX_NORM_ROUNDS; ++k) {
    const int c = (k * THREADS + tid) * NORM;
    if (k < rounds && c < HP) {
      gg[k] = __ldcg(reinterpret_cast<const float4*>(g_ws + c));
      ww[k] = *reinterpret_cast<const uint2*>(norm_w + c);
    }
  }
  const float total = block_sum(p, scratch);
  // Partial-norm mode: g * w unscaled, and the row's sum of g^2 beside it.
  const float inv = sumsq != nullptr ? 1.f : rsqrtf(total / (float)HP + eps);
  if (sumsq != nullptr && tid == 0) sumsq[b] = total;
#pragma unroll
  for (int k = 0; k < MAX_NORM_ROUNDS; ++k) {
    const int c = (k * THREADS + tid) * NORM;
    if (k < rounds && c < HP) {
      const float w0 = __uint_as_float(ww[k].x << 16), w1 = __uint_as_float(ww[k].x & 0xffff0000u);
      const float w2 = __uint_as_float(ww[k].y << 16), w3 = __uint_as_float(ww[k].y & 0xffff0000u);
      const __nv_bfloat162 o0 = __floats2bfloat162_rn(gg[k].x * inv * w0, gg[k].y * inv * w1);
      const __nv_bfloat162 o1 = __floats2bfloat162_rn(gg[k].z * inv * w2, gg[k].w * inv * w3);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&o0);
      u.y = *reinterpret_cast<const uint32_t*>(&o1);
      *reinterpret_cast<uint2*>(out + (size_t)b * HP + c) = u;
    }
  }
  if (tid == 0) tickets[b] = 0;
}

template <typename StateT, int TC>
int launch(void* states, int layer, const void* xs, const void* dt, const void* decay,
           const void* bm, const void* cm, const void* z, const void* d_skip,
           const void* norm_w, void* out, void* sumsq, void* ws, void* tickets, int B, int N,
           int HP, int H, float eps, cudaStream_t s) {
  constexpr int RP = THREADS / (TC / Chunk<StateT>::E);
  if (N % RP != 0 || N > MAX_ROWS || (HP / H) % Chunk<StateT>::E != 0 || HP % TC != 0 ||
      HP > MAX_NORM_ROUNDS * THREADS * 4)
    return (int)cudaErrorInvalidValue;
  StateT* plane = static_cast<StateT*>(states) + (size_t)layer * B * N * HP;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HP / TC, B);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ssd_step_kernel<StateT, TC>, plane, static_cast<const __nv_bfloat16*>(xs),
      static_cast<const float*>(dt), static_cast<const float*>(decay),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(d_skip),
      static_cast<const __nv_bfloat16*>(norm_w), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(sumsq), static_cast<float*>(ws), static_cast<int*>(tickets), B, N, HP,
      H, eps);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename StateT>
int launch_tc(int tc, void* states, int layer, const void* xs, const void* dt, const void* decay,
              const void* bm, const void* cm, const void* z, const void* d_skip,
              const void* norm_w, void* out, void* sumsq, void* ws, void* tickets, int B, int N,
              int HP, int H, float eps, cudaStream_t s) {
  if (tc == 128)
    return launch<StateT, 128>(states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w, out,
                               sumsq, ws, tickets, B, N, HP, H, eps, s);
  if (tc == 64)
    return launch<StateT, 64>(states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w, out,
                              sumsq, ws, tickets, B, N, HP, H, eps, s);
  return launch<StateT, 32>(states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w, out, sumsq,
                            ws, tickets, B, N, HP, H, eps, s);
}

}  // namespace

// Updates plane `layer` of states [R, B, N, HP] in place and writes out
// [B, HP], with column tiles of tc (32, 64 or 128) as planned by
// ops/cuda/mamba_step.py::step_plan. state_bf16 selects the state's storage
// type (0: fp32, 1: bf16). ws holds B * HP + B * (HP / tc) floats. sumsq
// null: the full gated norm; else the partial-norm mode (out = g * w, the
// rows' sums of g^2 in sumsq [B]).
extern "C" int zvt_ssd_gate_step(void* states, int state_bf16, int layer, const void* xs,
                                 const void* dt, const void* decay, const void* bm,
                                 const void* cm, const void* z, const void* d_skip,
                                 const void* norm_w, void* out, void* sumsq, void* ws,
                                 void* tickets, int R,
                                 int B, int N, int HP, int H, int tc, float eps, void* stream) {
  if (R <= 0 || B <= 0 || layer < 0 || layer >= R || H <= 0 || HP % H != 0 ||
      (tc != 32 && tc != 64 && tc != 128) || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state_bf16)
    return launch_tc<__nv_bfloat16>(tc, states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w,
                                    out, sumsq, ws, tickets, B, N, HP, H, eps, s);
  return launch_tc<float>(tc, states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w, out,
                          sumsq, ws, tickets, B, N, HP, H, eps, s);
}
