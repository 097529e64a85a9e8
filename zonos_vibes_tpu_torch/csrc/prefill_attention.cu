// Causal GQA flash-attention for a prefill chunk already written into one
// layer of the time-major KV cache, on the tensor cores.
//
// Replaces: zonos_vibes_tpu/ops/pallas/prefill_attention.py::
//   prefill_attention_pallas (a TPU grid (B, Hq, nQ, nK) with the key-block
//   axis innermost, causal block pruning through a clamped index map and the
//   fp32 online softmax in VMEM scratch).
//
// What bounds it on the H100: at the lengths the text path gives it (S ~ 90
// positions, one block row of keys or two) neither bytes (~0.5 us) nor flops
// (~0.06 us) are near the card's limits: the launch and the chain of
// dependent steps inside a block set the time. At long chunks (S in the
// thousands) the two products, 4 * S * T * D flops per query head with half
// of them pruned, become the limit.
//
// What the design does about it (flash attention on mma.sync):
//  * One block per (tile of ROWS query rows, kv head, batch row). A query row
//    is one (position, head of the group) pair, so the G query heads of a
//    group share every K/V tile. ROWS = 16 per compute warp: 64 rows (4
//    compute warps) or 32 (2), a template parameter. The launch takes 64
//    unless that grid would cover under half the SMs (the main path's S ~ 90
//    gives 96 blocks at head dim 64 and 48 at 128), then 32. Both heights
//    were timed (`PERF.md`, row 3): 32 rows win at head dim 128's 48-block
//    grid, 64 rows at long chunks, where each K/V tile serves more rows.
//  * At S ~ 90 a block is alone on its SM with nothing to hide its
//    latencies, so the compute warps' own instruction chain sets the time.
//    Each block has as many load warps as compute warps: they issue every
//    copy (Q and the K/V tiles), which takes the copies out of that chain.
//  * Each compute warp owns 16 query rows. Its Q fragments come from
//    ldmatrix on the block's Q rows in shared memory and stay in registers
//    for the whole key loop; S = Q K^T is mma.sync.m16n8k16 (bf16 in, fp32
//    accumulate) with K fragments from ldmatrix on a bf16 K tile in shared
//    memory, each k16 step's fragments loaded together ahead of its
//    products. The scale and log2(e) multiply the fp32 scores (never a bf16
//    q); exponentials are exp2f; row max and sum are taken on the
//    accumulator fragments with quad shuffles.
//  * P rounds to bf16 after normalisation, exp2(s - max) / sum, as in the
//    plain version and JAX, not before it as in FlashAttention: rounding the
//    unnormalised p landed one bf16 step (0.031) from the plain version at
//    outputs of 4 or more, over the 2e-2 absolute limit of the check. So the
//    row max and sum are known before P V:
//    - a short chunk (offset + S <= 128 keys: the main path's prefills and
//      the pool's joins) loads each of its <= 4 K/V tiles once into its own
//      stage of the ring, keeps all scores in registers, takes the exact
//      softmax and then P V;
//    - a longer chunk makes two passes: pass 1 streams K tiles for the
//      running max and sum, pass 2 recomputes the scores and adds P V. That
//      is the arithmetic of FlashAttention-2 with P V kept accurate (the
//      score product twice, the value product once), plus K read twice.
//    P is repacked from the accumulator layout into A fragments in
//    registers; V fragments come from ldmatrix.trans. The output needs no
//    final division.
//  * K/V tiles of 32 keys stay bf16 in shared memory (rows padded by 16
//    bytes so ldmatrix hits distinct banks) in a 4-stage ring filled by
//    16-byte cp.async.cg copies, one group per tile: products start when
//    the first tile lands while the later ones are in flight. 32 keys, not
//    64: the first products start after fewer bytes and the diagonal wastes
//    less (`PERF.md`, row 3). With the Q rows, D = 128 takes up to 85 KB of
//    dynamic shared memory (cudaFuncSetAttribute).
//  * Causal pruning: a warp skips tiles wholly above its last row, takes no
//    mask on tiles wholly at or below its first row, and masks per element
//    on the diagonal. A block reads keys [0, offset + its last position]
//    only: cache rows at or past offset + S are never read (their slots in
//    the tile are zero-filled by the copy), so stale or NaN rows there cannot
//    leak in through 0 * v.
//  * mma.sync rather than Hopper's wgmma: at S ~ 90 the kernel is latency
//    bound and wgmma's 64-row warpgroup tiles would halve the grid again;
//    wgmma is for a later change, since the long-chunk times lose to SDPA.
//
// Numerics: q.k products of bf16 values are exact in fp32 and summed in
// fp32; max, sum and the output accumulate in fp32; P rounds to bf16 after
// normalisation, as in the plain version; the output rounds once to bf16.
//
// Layouts (row-major, bf16): q [B, S, Hq, D], k and v [B, T, Hkv * D]
// (one layer of the cache), out [B, S, Hq, D]; D is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KEYS = 32;   // keys per K/V tile
constexpr int STAGES = 4;  // K/V tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

constexpr int MAX_DEVICES = 64;  // devices whose shared-memory attribute is tracked

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The K/V ring, then the block's Q rows.
template <int D, int ROWS>
constexpr int smem_bytes() {
  return (STAGES * 2 * KEYS + ROWS) * (D + 8) * 2;
}

// Waits until at most n (0-3) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// SHORT: the block's keys fit the ring (offset + S <= STAGES * KEYS), so
// every tile is loaded once and the scores stay in registers between the
// softmax and P V; otherwise two passes stream the tiles through the ring.
template <int D, int WARPS, bool SHORT>
__global__ void __launch_bounds__(2 * WARPS * 32) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int Hkv,
    int G, int T, int offset, float scale_log2) {
  constexpr int COMPUTE = WARPS * 32;  // threads of the compute warps; as many load
  constexpr int ROWS = WARPS * 16;
  constexpr int PITCH = D + 8;   // bf16 per shared row: 16 bytes of padding
  constexpr int KSTEPS = D / 16; // k16 steps of Q K^T
  constexpr int NT = KEYS / 8;   // n8 tiles of a score tile
  constexpr int DT = D / 8;      // n8 tiles of the output
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a K/V row
  extern __shared__ __align__(16) uint16_t smem[];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = Hkv * G;
  const int W = Hkv * D;
  const int total = S * G;
  const int row0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // Keys [0, kv_end) are the only cache rows this block reads.
  const int kv_end = offset + (min(row0 + ROWS, total) - 1) / G + 1;
  const int n_tiles = (kv_end + KEYS - 1) / KEYS;

  // The warp's rows; rows past the chunk take the last row's position (their
  // results are dropped) so that every row has a finite max.
  const bool computes = warp < WARPS;
  const int wrow0 = row0 + (computes ? warp : 0) * 16;
  const bool warp_live = computes && wrow0 < total;
  const int wq_min = offset + min(wrow0, total - 1) / G;
  const int wq_max = offset + min(wrow0 + 15, total - 1) / G;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = offset + min(wrow0 + gid + 8 * i, total - 1) / G;

  // The block's Q rows go to shared memory with the first tile's copies;
  // each compute warp then takes its Q fragments there with ldmatrix and
  // keeps them in registers for the whole key loop.
  uint16_t* qs = smem + STAGES * 2 * KEYS * PITCH;
  auto load_q = [&]() {
    if (computes) return;
    for (int c = threadIdx.x - COMPUTE; c < ROWS * CHUNKS; c += COMPUTE) {
      const int r = c / CHUNKS;
      const int part = (c % CHUNKS) * 8;
      const int row = row0 + r;
      const bool ok = row < total;
      const size_t at = ok ? (((size_t)b * S + row / G) * Hq + h * G + row % G) * D + part : 0;
      cp_async16(qs + r * PITCH + part, q + at, ok);
    }
  };
  uint32_t qf[KSTEPS][4];
  auto q_fragments = [&]() {
#pragma unroll
    for (int kt = 0; kt < KSTEPS; ++kt)
      ldmatrix_x4(qf[kt], qs + (warp * 16 + (lane & 15)) * PITCH + kt * 16 + (lane >> 4) * 8);
  };

  // The load warps issue every copy, so the compute warps' chain of
  // dependent steps holds no copy instructions.
  auto load_tile = [&](int tile, int stage, bool with_v) {
    uint16_t* ks = smem + stage * 2 * KEYS * PITCH;
    uint16_t* vs = ks + KEYS * PITCH;
    if (computes) return;
    for (int c = threadIdx.x - COMPUTE; c < KEYS * CHUNKS; c += COMPUTE) {
      const int j = c / CHUNKS;
      const int part = (c % CHUNKS) * 8;
      const int t = tile * KEYS + j;
      const bool ok = t < kv_end;
      const size_t idx = ((size_t)b * T + (ok ? t : 0)) * W + h * D + part;
      cp_async16(ks + j * PITCH + part, k + idx, ok);
      if (with_v) cp_async16(vs + j * PITCH + part, v + idx, ok);
    }
  };

  // The warp works on a tile only if some of its rows attend a key there.
  // Tile 0 always holds key 0 <= every row's position.
  auto warp_uses = [&](int tile) { return warp_live && tile * KEYS <= wq_max; };

  // Scaled, masked scores of tile `tile` (in log2 units). Thread rows: gid
  // (elements 0, 1) and gid + 8 (elements 2, 3).
  auto scores = [&](const uint16_t* ks, int tile, float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < KSTEPS; ++kt) {
      // The step's K fragments are loaded together, ahead of its products.
      // Lanes 0-7, 8-15, 16-23, 24-31 address the matrices (keys nt, d
      // 0-7), (keys nt, d 8-15), (keys nt + 1, d 0-7), (keys nt + 1, d 8-15).
      uint32_t r[NT / 2][4];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
        ldmatrix_x4(r[nt / 2], ks + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * PITCH + kt * 16 +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        mma_bf16(s[nt], qf[kt], r[nt / 2][0], r[nt / 2][1]);
        mma_bf16(s[nt + 1], qf[kt], r[nt / 2][2], r[nt / 2][3]);
      }
    }
    const int t0 = tile * KEYS;
    const bool diagonal = t0 + KEYS - 1 > wq_min;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale_log2;
        if (diagonal && t0 + nt * 8 + tig * 2 + (e & 1) > qpos[e >> 1]) val = -INFINITY;
        s[nt][e] = val;
      }
    }
  };

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  }

  // o += P V for one tile; p holds the normalised probabilities, which
  // round to bf16 here. V fragments: matrices (keys 0-7, d dt), (keys 8-15,
  // dt), (keys 0-7, dt + 1), (keys 8-15, dt + 1), transposed, loaded together.
  auto add_pv = [&](const uint16_t* vs, const float (&p)[NT][4]) {
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      // P's A fragment for keys 16 kk .. 16 kk + 15: score tiles 2 kk, 2 kk + 1.
      const uint32_t a[4] = {bf16x2_bits(p[2 * kk][0], p[2 * kk][1]),
                             bf16x2_bits(p[2 * kk][2], p[2 * kk][3]),
                             bf16x2_bits(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             bf16x2_bits(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      uint32_t r[DT / 2][4];
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2)
        ldmatrix_x4_trans(r[dt / 2], vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                                         dt * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        mma_bf16(o[dt], a, r[dt / 2][0], r[dt / 2][1]);
        mma_bf16(o[dt + 1], a, r[dt / 2][2], r[dt / 2][3]);
      }
    }
  };

  auto quad_max = [](float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };
  auto quad_sum = [](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  if constexpr (SHORT) {
    // Every tile in its own stage, one copy group each.
    load_q();
#pragma unroll
    for (int t = 0; t < STAGES; ++t) {
      if (t < n_tiles) load_tile(t, t, true);
      cp_async_commit();
    }
    float s[STAGES][NT][4];
#pragma unroll
    for (int t = 0; t < STAGES; ++t) {
      cp_async_wait_pending(STAGES - 1 - t);
      __syncthreads();
      if (t == 0 && warp_live) q_fragments();
      if (t < n_tiles && warp_uses(t)) {
        scores(smem + t * 2 * KEYS * PITCH, t, s[t]);
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][nt][e] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < STAGES; ++t) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[t][nt][e]);
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int t = 0; t < STAGES; ++t) {
      if (t >= n_tiles) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][nt][e] = exp2f(s[t][nt][e] - m[e >> 1]);
          l[e >> 1] += s[t][nt][e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = 1.f / quad_sum(l[i]);
#pragma unroll
    for (int t = 0; t < STAGES; ++t) {
      if (t < n_tiles && warp_uses(t)) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][nt][e] *= l[e >> 1];
        }
        add_pv(smem + t * 2 * KEYS * PITCH + KEYS * PITCH, s[t]);
      }
    }
  } else {
    // Step i < n_tiles: pass 1 over tile i (K only: running max and sum);
    // step n_tiles + i: pass 2 over tile i (K and V: normalised P V).
    const int steps = 2 * n_tiles;
    auto load_step = [&](int step, int stage) {
      const bool second = step >= n_tiles;
      load_tile(second ? step - n_tiles : step, stage, second);
    };
    load_q();
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < steps) load_step(st, st);
      cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      // Every warp is past step - 1, whose stage the next load reuses.
      if (step + STAGES - 1 < steps) load_step(step + STAGES - 1, (step + STAGES - 1) % STAGES);
      cp_async_commit();
      if (step == 0 && warp_live) q_fragments();
      const bool second = step >= n_tiles;
      const int tile = second ? step - n_tiles : step;
      if (warp_uses(tile)) {
        const uint16_t* ks = smem + (step % STAGES) * 2 * KEYS * PITCH;
        float s[NT][4];
        scores(ks, tile, s);
        if (!second) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float mn = fmaxf(m[i], quad_max(mx[i]));
            l[i] *= exp2f(m[i] - mn);
            m[i] = mn;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[nt][e] - m[e >> 1]);
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = exp2f(s[nt][e] - m[e >> 1]) * l[e >> 1];
          }
          add_pv(ks + KEYS * PITCH, s);
        }
      }
      // End of pass 1: l becomes 1 / (row sum), the quad's shares summed.
      if (step == n_tiles - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = 1.f / quad_sum(l[i]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow0 + gid + 8 * i;
    if (!warp_live || row >= total) continue;
    __nv_bfloat16* orow = out + (((size_t)b * S + row / G) * Hq + h * G + row % G) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          bf16x2_bits(o[dt][2 * i], o[dt][2 * i + 1]);
  }
}

template <int D, int WARPS, bool SHORT>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Hkv,
           int G, int T, int offset, cudaStream_t s) {
  constexpr int ROWS = WARPS * 16;
  constexpr int SMEM = smem_bytes<D, ROWS>();
  // The attribute belongs to the current device's context: one flag per
  // device ordinal for each template instance.
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static unsigned long long configured = 0;  // devices whose attribute is set
  if (!(configured >> dev & 1ull)) {
    e = cudaFuncSetAttribute(prefill_mma_kernel<D, WARPS, SHORT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    configured |= 1ull << dev;
  }
  const dim3 grid((S * G + ROWS - 1) / ROWS, Hkv, B);
  prefill_mma_kernel<D, WARPS, SHORT><<<grid, 2 * WARPS * 32, SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Hkv, G, T,
      offset, LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// 64-row tiles unless their grid would cover under half of the card's sms
// SMs, then 32.
template <int D>
int launch_rows(const void* q, const void* k, const void* v, void* out, int B, int S, int Hkv,
                int G, int T, int offset, int sms, cudaStream_t s) {
  const bool wide = 2 * ((S * G + 63) / 64 * Hkv * B) >= sms;
  const bool short_chunk = offset + S <= STAGES * KEYS;
  if (wide)
    return short_chunk ? launch<D, 4, true>(q, k, v, out, B, S, Hkv, G, T, offset, s)
                       : launch<D, 4, false>(q, k, v, out, B, S, Hkv, G, T, offset, s);
  return short_chunk ? launch<D, 2, true>(q, k, v, out, B, S, Hkv, G, T, offset, s)
                     : launch<D, 2, false>(q, k, v, out, B, S, Hkv, G, T, offset, s);
}

}  // namespace

// sms: the launching card's SM count (the wrapper's _sm_count).
extern "C" int zvt_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int Hq, int Hkv, int T, int head_dim,
                                     int offset, int sms, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || offset < 0 || offset + S > T || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_rows<64>(q, k, v, out, B, S, Hkv, G, T, offset, sms, s);
  if (head_dim == 128)
    return launch_rows<128>(q, k, v, out, B, S, Hkv, G, T, offset, sms, s);
  return (int)cudaErrorInvalidValue;
}
