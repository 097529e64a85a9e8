// Fused Mamba-2 decode step: state update, C.h readout, D skip, silu(z) gate
// and the gated RMSNorm, on one plane of a stacked SSM state, in place.
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
// (20 us); half that with a bf16 state. Everything else is a few KB.
//
// What the design does about it:
//  * One block per (tile of 128 columns, batch row), so the solo step's 2
//    rows still spread over 64 blocks and the pool's 16 rows over 512. A
//    thread owns 4 contiguous columns (one 16-byte load of an fp32 state
//    row, 8 bytes of a bf16 one; neighbouring lanes on neighbouring
//    addresses) and the block's 4 warps split the N state rows.
//  * A thread loads ROWS_IN_FLIGHT state rows into registers before it
//    updates and stores any of them: a store to the state may alias a later
//    row's load for all the compiler knows, so a load-update-store loop
//    issues one load per memory latency (measured on an H100: 22 us for the
//    solo step's 8.4 MB, bound 2.5 us). With 16 loads in flight per thread the
//    few blocks of the solo step keep enough bytes moving.
//  * y accumulates in registers; the warps' partial sums meet in shared
//    memory, where warp 0 adds the D skip, applies the gate and writes g
//    (fp32) and the tile's sum of g^2.
//  * The gated RMSNorm reduces over all H * P columns of a row, which span
//    32 blocks. A second small kernel (one block per row) sums the tiles'
//    partials in a fixed order and writes out = g * rsqrt(...) * w: the
//    result does not depend on block scheduling.
//  * The plane `layer` is the only memory of the state written: other
//    planes are not touched.
//
// Layouts (row-major): states [R, B, N, HP] fp32 or bf16; xs, z [B, HP]
// bf16; dt, decay [B, H] fp32; bm, cm [B, N] fp32; d_skip [H] fp32;
// norm_w [HP] bf16; g scratch [B, HP] fp32; part [B, HP / 128] fp32;
// out [B, HP] bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COLS = 4;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32 * COLS;
constexpr int ROWS_IN_FLIGHT = 16;  // N must be a multiple of WARPS * ROWS_IN_FLIGHT
constexpr int NORM_THREADS = 256;

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 c = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = c.x;
  v[3] = c.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 c = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&a);
  u.y = *reinterpret_cast<const unsigned int*>(&c);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename StateT>
__global__ void __launch_bounds__(THREADS) ssd_update_kernel(
    StateT* __restrict__ plane, const __nv_bfloat16* __restrict__ xs,
    const float* __restrict__ dt, const float* __restrict__ decay,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ d_skip,
    float* __restrict__ g_out, float* __restrict__ part, int N, int HP, int H) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ntile = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = tile * TILE + lane * COLS;
  const int head = col / (HP / H);  // P % COLS == 0: the 4 columns share a head

  const float dtv = dt[b * H + head];
  const float dec = decay[b * H + head];
  float x[COLS], dtx[COLS], y[COLS];
  load4(xs + (size_t)b * HP + col, x);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    dtx[c] = dtv * x[c];
    y[c] = 0.f;
  }

  const int rows = N / WARPS;
  const int n0 = warp * rows;
  StateT* s = plane + (size_t)b * N * HP + col;
  const float* bmr = bm + (size_t)b * N;
  const float* cmr = cm + (size_t)b * N;
  for (int n = n0; n < n0 + rows; n += ROWS_IN_FLIGHT) {
    float h[ROWS_IN_FLIGHT][COLS];
#pragma unroll
    for (int r = 0; r < ROWS_IN_FLIGHT; ++r) load4(s + (size_t)(n + r) * HP, h[r]);
#pragma unroll
    for (int r = 0; r < ROWS_IN_FLIGHT; ++r) {
      const float bn = bmr[n + r];
      const float cn = cmr[n + r];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        h[r][c] = h[r][c] * dec + bn * dtx[c];
        y[c] += cn * h[r][c];
      }
      store4(s + (size_t)(n + r) * HP, h[r]);
    }
  }

  __shared__ float sm_y[WARPS][TILE];
#pragma unroll
  for (int c = 0; c < COLS; ++c) sm_y[warp][lane * COLS + c] = y[c];
  __syncthreads();
  if (warp != 0) return;
  float zz[COLS], g[COLS];
  load4(z + (size_t)b * HP + col, zz);
  const float dskip = d_skip[head];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += sm_y[w][lane * COLS + c];
    acc += dskip * x[c];
    const float silu = zz[c] / (1.f + expf(-zz[c]));
    g[c] = acc * silu;
    ss += g[c] * g[c];
  }
  store4(g_out + (size_t)b * HP + col, g);
  ss = warp_sum(ss);
  if (lane == 0) part[(size_t)b * ntile + tile] = ss;
}

// One block per batch row: the row's mean of g^2 from the tiles' partials,
// then out = g * rsqrt(mean + eps) * w.
__global__ void __launch_bounds__(NORM_THREADS) ssd_norm_kernel(
    const float* __restrict__ g, const float* __restrict__ part,
    const __nv_bfloat16* __restrict__ norm_w, __nv_bfloat16* __restrict__ out, int HP,
    int ntile, float eps) {
  const int b = blockIdx.x;
  __shared__ float inv;
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int t = threadIdx.x; t < ntile; t += 32) s += part[(size_t)b * ntile + t];
    s = warp_sum(s);
    if (threadIdx.x == 0) inv = rsqrtf(s / (float)HP + eps);
  }
  __syncthreads();
  const float r = inv;
  for (int col = threadIdx.x * COLS; col < HP; col += NORM_THREADS * COLS) {
    float gv[COLS], wv[COLS];
    load4(g + (size_t)b * HP + col, gv);
    load4(norm_w + col, wv);
#pragma unroll
    for (int c = 0; c < COLS; ++c) gv[c] = gv[c] * r * wv[c];
    store4(out + (size_t)b * HP + col, gv);
  }
}

template <typename StateT>
int launch(void* states, int layer, const void* xs, const void* dt, const void* decay,
           const void* bm, const void* cm, const void* z, const void* d_skip,
           const void* norm_w, void* g, void* part, void* out, int B, int N, int HP, int H,
           float eps, cudaStream_t s) {
  StateT* plane = static_cast<StateT*>(states) + (size_t)layer * B * N * HP;
  const int ntile = HP / TILE;
  ssd_update_kernel<StateT><<<dim3(ntile, B), THREADS, 0, s>>>(
      plane, static_cast<const __nv_bfloat16*>(xs), static_cast<const float*>(dt),
      static_cast<const float*>(decay), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const __nv_bfloat16*>(z),
      static_cast<const float*>(d_skip), static_cast<float*>(g), static_cast<float*>(part), N,
      HP, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_norm_kernel<<<B, NORM_THREADS, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(part),
      static_cast<const __nv_bfloat16*>(norm_w), static_cast<__nv_bfloat16*>(out), HP, ntile,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Column tiles per row: the length of each row of `part`.
extern "C" int zvt_ssd_gate_step_tiles(int HP) { return HP / TILE; }

// Updates plane `layer` of states [R, B, N, HP] in place and writes out
// [B, HP]. state_bf16 selects the state's storage type (0: fp32, 1: bf16).
extern "C" int zvt_ssd_gate_step(void* states, int state_bf16, int layer, const void* xs,
                                 const void* dt, const void* decay, const void* bm,
                                 const void* cm, const void* z, const void* d_skip,
                                 const void* norm_w, void* g, void* part, void* out, int R,
                                 int B, int N, int HP, int H, float eps, void* stream) {
  if (R <= 0 || B <= 0 || layer < 0 || layer >= R || H <= 0 || HP % H != 0 ||
      (HP / H) % COLS != 0 || HP % TILE != 0 || N <= 0 || N % (WARPS * ROWS_IN_FLIGHT) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state_bf16)
    return launch<__nv_bfloat16>(states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w, g,
                                 part, out, B, N, HP, H, eps, s);
  return launch<float>(states, layer, xs, dt, decay, bm, cm, z, d_skip, norm_w, g, part, out,
                       B, N, HP, H, eps, s);
}
