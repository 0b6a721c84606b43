// Grouped matrix products (gmm, its transposed form, tgmm) for Hopper (sm_90a):
// bf16 tensor-core products with f32 accumulation.
//
// Replaces the Pallas TPU kernels of the megablox library that the gmm
// dispatch mode reaches (`moe_ffn_gmm`, unimoe_audio_tpu/moe/dispatch.py:274-371):
//   K4   gmm   (jax/experimental/pallas/ops/tpu/megablox/gmm.py:314, pallas_call :526)
//          out[r] = x[r] . W[g(r)]       x [A, K] bf16, W [E, K, N] bf16 -> out [A, N] f32
//   K4t  gmm(transpose_rhs=True), the input gradient of its custom VJP (megablox/ops.py:80-89)
//          dx[r] = dy[r] . W[g(r)]^T     dy [A, N] f32 or bf16, W bf16 -> dx [A, K] bf16
//   K5   tgmm  (gmm.py:573, pallas_call :763), the weight gradient (ops.py:90-99)
//          dW[g] = sum_{r in g} x[r]^T dy[r]   x [A, K] bf16, dy [A, N] bf16 -> dW [E, K, N] bf16
// Rows are sorted by group: group g owns rows [off_g, off_g + group_sizes[g]), off_g
// being the prefix sum of group_sizes (clamped to A).  A row that no group owns gets
// 0 from gmm and adds nothing to tgmm; a group with no rows reads no weights in gmm
// and gets a zero dW in tgmm.  Group sizes are read on the card only.
//
// Precision: the products accumulate in f32; K4t and K5 store in bf16 (the dtype
// of x and W).  K4t rounds an f32 dy to bf16 as it loads it; K5 takes dy in bf16
// (its wrapper rounds an f32 dy once, to nearest even, the same rounding).
//
// What bounds them on the H100: at the training shape (A = 65,536 rows, K = 2048,
// N = 2752) each launch does 739 GFLOP on about 1 GB, so the tensor cores bound it
// (0.75 ms at 989 TFLOP/s); at a decode step (A = 128) a launch must stream the
// weights of every non-empty group (up to 90 MB, about 27 us at 3.35 TB/s), so
// bytes bound it.
//
// K4 and K5 (`gmm_wgmma_kernel`): warp-specialised wgmma.
//   * 288 threads: two consumer warpgroups, each owning 64 rows of a 128-row
//     output tile, and one producer warp.  The producer keeps a ring of STAGES
//     shared-memory stages full: each holds the two 64 x 64 halves of the A
//     operand and BN/64 boxes of 64 x 64 of the B operand, every box in the
//     128-byte swizzled layout.  TMA fills them (one elected thread, mbarrier
//     transaction counts); where a row stride is not a multiple of 16 bytes
//     (TMA cannot address it) the producer warp fills them with cp.async and
//     plain loads in the same layout.  Consumers wait on the stage's full
//     barrier, run 4 wgmma m64nBNk16 from shared-memory descriptors, and
//     release the stage on its empty barrier.
//   * K4's work list is made on the card, as megablox's `make_group_metadata`
//     (gmm.py:79-255) makes it on the host: the (128-row tile, group) visits
//     in group order, with the rows past the last group as one more group whose
//     visits store zeros.  A tile that straddles a group boundary is visited
//     once per group; TMA loads its whole rows, and only the group's rows are
//     stored.  The grid is (N / BN, A / 128 + E) from host ints; each CTA
//     prefix-sums group_sizes in shared memory and finds its visit; CTAs past
//     the last visit exit at once, and an empty group has no visit (its weights
//     are never read).  Two tile configurations: large A (prefill, training)
//     takes BN = 256 and 4 stages (one CTA per SM, the tensor cores bound it);
//     small A (decode) takes BN = 64 and 3 stages, three CTAs per SM, so that
//     the 8 groups x 43 column tiles fill the card in one wave and each SM
//     keeps about 72 KB of weights in flight (bytes bound it).  At small A a
//     consumer whose 64-row half holds none of the group's rows loads and
//     computes nothing.
//   * K5 reads x^T (M-major A) and dy (N-major B).  Its work items are
//     (group, chunk of at most R rows) pairs, so a large group's rows (the
//     last group holds the unselected and padding rows: 61 % of them at the
//     training shape) spread over many CTAs.  A group with one chunk stores its
//     dW tile in bf16; the chunks of a larger group store f32 partials into a
//     workspace, and `tgmm_reduce_kernel` sums each group's partials in chunk
//     order into bf16.  No atomics: two launches give the same bits.  Rows of a
//     stage past the chunk's end are zeroed in shared memory before the
//     products.
// K4t keeps the WMMA kernel below (`gmm_kernel<true, ...>`): one CTA per
// (128-row tile, 128-column tile), 8 warps of 32 x 64 WMMA fragments,
// register-staged 32-deep slices; its redesign is later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "hopper_ptx.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_GROUPS = 64;

// ---- K4t: WMMA, register-staged slices ----------------------------------------

constexpr int BM = 128;          // output rows per CTA
constexpr int BN = 128;          // output columns per CTA
constexpr int BK = 32;           // depth of one slice of the reduction
constexpr int NT = 256;          // 8 warps
constexpr int LDA = BK + 8;      // bf16 rows of a [*, BK] tile
constexpr int LDST = 16 + 4;     // f32 rows of a warp's 16 x 16 staging tile

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// 8 consecutive elements of a row as 8 packed bf16, the first n_valid of them
// read (the rest 0).  p may be out of range when n_valid <= 0.
__device__ __forceinline__ uint4 load8(const bf16* p, int n_valid, bool vec) {
  if (vec && n_valid >= 8) return *reinterpret_cast<const uint4*>(p);
  uint4 u = make_uint4(0, 0, 0, 0);
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n_valid) h[i] = p[i];
  return u;
}

// The same for f32 input, rounded to bf16 as it is loaded.
__device__ __forceinline__ uint4 load8(const float* p, int n_valid, bool vec) {
  float f[8];
  if (vec && n_valid >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i < n_valid ? p[i] : 0.f;
  }
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void store8(bf16* p, const float* v, int n_valid, bool vec) {
  if (vec && n_valid >= 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n_valid) p[i] = __float2bfloat16(v[i]);
}

// Prefix sums of group_sizes into off[0..E], each clamped to [0, M].
__device__ __forceinline__ void group_offsets(const int* group_sizes, int E, int M, int* off) {
  if (threadIdx.x == 0) {
    int acc = 0;
    off[0] = 0;
    for (int g = 0; g < E; ++g) {
      acc = min(acc + max(group_sizes[g], 0), M);
      off[g + 1] = acc;
    }
  }
  __syncthreads();
}

// Write the warp's 2 x 4 accumulator fragments (a 32 x 64 block whose top-left
// output is (row0, col0)) through a 16 x 16 shared staging tile: rows in
// [lo, hi) and columns below n_cols only.
__device__ __forceinline__ void store_warp_tile(AccFrag (&acc)[2][4], float* stage, bf16* out,
                                                int ld_out, int row0, int col0, int lo, int hi,
                                                int n_cols, bool vec) {
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], LDST, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + i * 16 + r;
      const int gc = col0 + j * 16 + c;
      if (gr >= lo && gr < hi && gc < n_cols)
        store8(out + (size_t)gr * ld_out + gc, stage + r * LDST + c, n_cols - gc, vec);
      __syncwarp();
    }
  }
}

// C [M, Nc] = A [M, Kd] . B [Kd, Nc] per group, B being the transpose of a
// row-major [Nc, Kd] W[g] (TRANS = true, K4t; the non-transposed form is the
// wgmma kernel below).
template <bool TRANS, typename TA, typename TO>
__global__ void __launch_bounds__(NT)
gmm_kernel(const TA* __restrict__ a, const bf16* __restrict__ w, const int* __restrict__ group_sizes,
           TO* __restrict__ out, int M, int Kd, int Nc, int E, int vec_flag) {
  static_assert(TRANS, "the non-transposed gmm is gmm_wgmma_kernel");
  __shared__ __align__(128) bf16 sA[BM * LDA];
  __shared__ __align__(128) bf16 sB[BN * LDA];
  __shared__ __align__(128) float sStage[8][16 * LDST];
  __shared__ int off[MAX_GROUPS + 1];

  const bool vec = vec_flag != 0;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp >> 1, wn = warp & 1;
  const int m1 = min(m0 + BM, M);

  group_offsets(group_sizes, E, M, off);

  for (int g = 0; g < E; ++g) {
    const int lo = max(off[g], m0), hi = min(off[g + 1], m1);
    if (lo >= hi) continue;            // the same for every thread of the CTA
    const bf16* wg = w + (size_t)g * Kd * Nc;

    uint4 ra[2], rb[2];
    auto load_slice = [&](int k0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = tid + p * NT;
        const int row = c >> 2, col = (c & 3) * 8;
        {  // A: rows of this group, columns k0..k0+BK
          const int gr = m0 + row, gk = k0 + col;
          const bool ok = gr >= lo && gr < hi;
          ra[p] = load8(ok ? a + (size_t)gr * Kd + gk : a, ok ? Kd - gk : 0, vec);
        }
        {  // W[g] rows n0..n0+BN (of Nc), columns k0..k0+BK (of Kd)
          const int gn = n0 + row, gk = k0 + col;
          const bool ok = gn < Nc;
          rb[p] = load8(ok ? wg + (size_t)gn * Kd + gk : wg, ok ? Kd - gk : 0, vec);
        }
      }
    };
    auto store_slice = [&]() {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = tid + p * NT;
        *reinterpret_cast<uint4*>(sA + (c >> 2) * LDA + (c & 3) * 8) = ra[p];
        *reinterpret_cast<uint4*>(sB + (c >> 2) * LDA + (c & 3) * 8) = rb[p];
      }
    };

    AccFrag acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    load_slice(0);
    for (int k0 = 0; k0 < Kd; k0 += BK) {
      store_slice();
      __syncthreads();
      if (k0 + BK < Kd) load_slice(k0 + BK);   // in flight during the products below
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sB + (wn * 64 + j * 16) * LDA + kk, LDA);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
      __syncthreads();
    }
    store_warp_tile(acc, sStage[warp], out, Nc, m0 + wm * 32, n0 + wn * 64, lo, hi, Nc, vec);
  }

  // Rows of this tile that no group owns: 0.
  const int z0 = max(off[E], m0);
  const int n1 = min(n0 + BN, Nc);
  for (int i = tid; i < (m1 - z0) * BN; i += NT) {
    const int r = z0 + i / BN, c = n0 + i % BN;
    if (r < m1 && c < n1) out[(size_t)r * Nc + c] = __float2bfloat16(0.f);
  }
}

__host__ __device__ __forceinline__ bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <bool TRANS, typename TA, typename TO>
cudaError_t launch_gmm(const void* a, const void* w, const void* gs, void* out, int M, int Kd,
                       int Nc, int E, int vec, cudaStream_t st) {
  const dim3 grid((Nc + BN - 1) / BN, (M + BM - 1) / BM);
  gmm_kernel<TRANS, TA, TO><<<grid, NT, 0, st>>>(static_cast<const TA*>(a),
                                                static_cast<const bf16*>(w),
                                                static_cast<const int*>(gs),
                                                static_cast<TO*>(out), M, Kd, Nc, E, vec);
  return cudaGetLastError();
}

// ---- K4 and K5: TMA / cp.async ring, wgmma ------------------------------------

namespace ws {

constexpr int BM = 128;           // output rows per CTA: two consumer warpgroups of 64
constexpr int BK = 64;            // reduction depth of one stage (128 bytes of bf16)
constexpr int THREADS = 288;      // 2 consumer warpgroups + 1 producer warp
constexpr int CONSUMERS = 256;
constexpr int BOX = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 box
constexpr int CTRL = 2048;        // alignment slack + barriers + group offsets

// Large A (prefill, training) and K5; small A (decode).
constexpr int LARGE_BN = 256, LARGE_STAGES = 4, LARGE_CTAS = 1;
constexpr int SMALL_BN = 64, SMALL_STAGES = 3, SMALL_CTAS = 3;

__host__ __device__ constexpr int stage_bytes(int bn) { return 2 * BOX + (bn / 64) * BOX; }
__host__ __device__ constexpr int smem_bytes(int bn, int stages) { return stages * stage_bytes(bn) + CTRL; }

template <int BN_>
struct Acc;
template <>
struct Acc<64> {
  float d[32];
  __device__ __forceinline__ void mma(int ta, uint64_t da, uint64_t db) {
    if (ta) hopper::wgmma_m64n64k16<1>(d, da, db);
    else hopper::wgmma_m64n64k16<0>(d, da, db);
  }
};
template <>
struct Acc<256> {
  float d[128];
  __device__ __forceinline__ void mma(int ta, uint64_t da, uint64_t db) {
    if (ta) hopper::wgmma_m64n256k16<1>(d, da, db);
    else hopper::wgmma_m64n256k16<0>(d, da, db);
  }
};

// Two bf16 from global (row valid, `left` elements left in the row) to a
// 4-byte slot of a swizzled tile: cp.async when the pair is 4-byte aligned
// (even widths), else plain loads.
__device__ __forceinline__ void copy_pair(uint8_t* dst, const bf16* src, bool row_ok, int left,
                                          bool pair4, const void* dummy) {
  if (pair4) {
    const bool ok = row_ok && left > 0;
    hopper::cp_async4(hopper::smem_u32(dst), ok ? static_cast<const void*>(src) : dummy,
                      ok ? 4u : 0u);
  } else {
    const bf16 z = __float2bfloat16(0.f);
    __nv_bfloat162 v;
    v.x = row_ok && left > 0 ? src[0] : z;
    v.y = row_ok && left > 1 ? src[1] : z;
    *reinterpret_cast<__nv_bfloat162*>(dst) = v;
  }
}

// TGMM = false (K4): A = x [M, K] (K-major), B = W [E, K, N] (N-major),
//   out f32 [M, N]; blockIdx = (column tile, visit).
// TGMM = true (K5): A = x^T, read from x [M, K] (M-major), B = dy [M, N]
//   (N-major), out bf16 dW [E, K, N] or f32 partials in ws;
//   blockIdx = (column tile, k tile, work item); chunk_rows = R.
// map_a: x as {K, M}, boxes of 64 x 64; map_b: W as {N, K, E} (K4) or dy as
// {N, M, 1} (K5), boxes of 64 x 64 x 1; both 128-byte swizzled (TMA only).
template <int BN_, int STAGES, int MIN_CTAS, bool TGMM, bool TMA>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ a,
                 const bf16* __restrict__ b, const int* __restrict__ group_sizes,
                 void* __restrict__ out, float* __restrict__ wsp, int M, int K, int N, int E,
                 int chunk_rows, int pair4_flag) {
  constexpr int NB = BN_ / 64;                      // B boxes per stage
  constexpr int SB = stage_bytes(BN_);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* tiles = smem_raw + ((1024 - (raw & 1023)) & 1023);   // 1024-byte aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(tiles + STAGES * SB);   // full[S], empty[S]
  int* s_off = reinterpret_cast<int*>(bars + 2 * STAGES);            // [MAX_GROUPS + 1]
  int* s_work = s_off + MAX_GROUPS + 1;                              // g, lo, hi, m0, slot

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN_;

  if (tid < E) s_off[tid + 1] = max(group_sizes[tid], 0);
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    s_off[0] = 0;
    for (int g = 0; g < E; ++g) {
      acc = min(acc + s_off[g + 1], M);
      s_off[g + 1] = acc;
    }
    int found = -1, lo = 0, hi = 0, m0 = 0, slot = -1;
    if (!TGMM) {
      // Visits (128-row tile, group) in group order; group E = rows past off[E].
      const int v = blockIdx.y;
      int cum = 0;
      for (int g = 0; g <= E; ++g) {
        const int glo = s_off[g], ghi = g < E ? s_off[g + 1] : M;
        if (ghi <= glo) continue;
        const int t0 = glo / BM, nt = (ghi - 1) / BM - t0 + 1;
        if (v < cum + nt) {
          found = g;
          m0 = (t0 + v - cum) * BM;
          lo = max(glo, m0);
          hi = min(ghi, m0 + BM);
          break;
        }
        cum += nt;
      }
    } else {
      // Items (group, chunk of chunk_rows rows) in group order; an empty group
      // is one item without rows; chunks of groups with more than one take
      // consecutive workspace slots.
      const int v = blockIdx.z;
      int cum = 0, wsum = 0;
      for (int g = 0; g < E; ++g) {
        const int n = s_off[g + 1] - s_off[g];
        const int c = n > chunk_rows ? (n + chunk_rows - 1) / chunk_rows : 1;
        if (v < cum + c) {
          const int j = v - cum;
          found = g;
          lo = s_off[g] + j * chunk_rows;
          hi = min(lo + chunk_rows, s_off[g + 1]);
          slot = c > 1 ? wsum + j : -1;
          break;
        }
        cum += c;
        if (c > 1) wsum += c;
      }
      m0 = blockIdx.y * BM;
    }
    s_work[0] = found; s_work[1] = lo; s_work[2] = hi; s_work[3] = m0; s_work[4] = slot;
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(hopper::smem_u32(bars + s), TMA ? 1 : 32);
      hopper::mbar_init(hopper::smem_u32(bars + STAGES + s), CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int g = s_work[0], lo = s_work[1], hi = s_work[2], m0 = s_work[3], slot = s_work[4];
  if (g < 0) return;                                 // past the last visit or item
  if (!TGMM && g == E) {                             // rows no group owns: 0
    float* o = static_cast<float*>(out);
    for (int i = tid; i < (hi - lo) * BN_; i += THREADS) {
      const int r = lo + i / BN_, c = n0 + i % BN_;
      if (c < N) o[(size_t)r * N + c] = 0.f;
    }
    return;
  }

  // Which 64-row halves of A carry work: K4, the halves holding rows of the
  // group; K5, the halves inside K.
  bool need[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    need[h] = TGMM ? m0 + 64 * h < K : (m0 + 64 * h < hi && m0 + 64 * h + 64 > lo);
  const int nsteps = TGMM ? (hi - lo + BK - 1) / BK : (K + BK - 1) / BK;
  const int warp = tid / 32, lane = tid % 32;

  if (warp == 8) {
    // ---- producer warp ----
    int stage = 0;
    uint32_t phase = 0;
    if (TMA) {
      if (lane != 0) return;
      const uint32_t bytes = ((need[0] ? 1 : 0) + (need[1] ? 1 : 0) + NB) * BOX;
      for (int s = 0; s < nsteps; ++s) {
        const uint32_t full = hopper::smem_u32(bars + stage);
        hopper::mbar_wait(hopper::smem_u32(bars + STAGES + stage), phase ^ 1);
        hopper::mbar_arrive_expect_tx(full, bytes);
        uint8_t* sa = tiles + stage * SB;
        uint8_t* sb = sa + 2 * BOX;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!need[h]) continue;
          if (TGMM)
            hopper::tma_load_2d(hopper::smem_u32(sa + h * BOX), &map_a, full, m0 + 64 * h,
                                lo + s * BK);
          else
            hopper::tma_load_2d(hopper::smem_u32(sa + h * BOX), &map_a, full, s * BK,
                                m0 + 64 * h);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (TGMM)
            hopper::tma_load_3d(hopper::smem_u32(sb + j * BOX), &map_b, full, n0 + 64 * j,
                                lo + s * BK, 0);
          else
            hopper::tma_load_3d(hopper::smem_u32(sb + j * BOX), &map_b, full, n0 + 64 * j,
                                s * BK, g);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    } else {
      const bool pair4 = pair4_flag != 0;
      for (int s = 0; s < nsteps; ++s) {
        hopper::mbar_wait(hopper::smem_u32(bars + STAGES + stage), phase ^ 1);
        uint8_t* sa = tiles + stage * SB;
        uint8_t* sb = sa + 2 * BOX;
        for (int h = 0; h < 2; ++h) {
          for (int i = lane; i < 64 * 32; i += 32) {
            const int r = i >> 5, c = (i & 31) * 2;          // box row, column pair
            int row, col;
            bool row_ok;
            if (TGMM) { row = lo + s * BK + r; col = m0 + 64 * h + c; row_ok = row < hi; }
            else { row = m0 + 64 * h + r; col = s * BK + c; row_ok = row < M; }
            copy_pair(sa + h * BOX + hopper::swizzle128(r, c), a + (size_t)row * K + col,
                      row_ok, K - col, pair4, a);
          }
        }
        for (int j = 0; j < NB; ++j) {
          for (int i = lane; i < 64 * 32; i += 32) {
            const int r = i >> 5, c = (i & 31) * 2;
            const int col = n0 + 64 * j + c;
            const int row = TGMM ? lo + s * BK + r : s * BK + r;
            const bool row_ok = TGMM ? row < hi : row < K;
            const size_t base = TGMM ? (size_t)row * N : ((size_t)g * K + row) * N;
            copy_pair(sb + j * BOX + hopper::swizzle128(r, c), b + base + col, row_ok, N - col,
                      pair4, b);
          }
        }
        hopper::cp_async_wait_all();
        hopper::fence_proxy_async();
        hopper::mbar_arrive(hopper::smem_u32(bars + stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int h = warp / 4, wt = tid % 128, lw = wt / 32;
  const bool act = need[h];
  Acc<BN_> acc;
#pragma unroll
  for (int i = 0; i < BN_ / 2; ++i) acc.d[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int s = 0; s < nsteps; ++s) {
    hopper::mbar_wait(hopper::smem_u32(bars + stage), phase);
    uint8_t* sa = tiles + stage * SB + h * BOX;
    uint8_t* sb = tiles + stage * SB + 2 * BOX;
    if (TGMM) {
      // Rows of this stage past the chunk's end belong to other groups or
      // chunks: zero them in this warpgroup's x tile.
      const int valid = hi - (lo + s * BK);
      if (valid < BK) {
        for (int i = wt; i < (BK - valid) * 8; i += 128)
          *reinterpret_cast<uint4*>(sa + (valid + i / 8) * 128 + (i % 8) * 16) =
              make_uint4(0, 0, 0, 0);
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(1 + h, 128);
      }
    }
    if (act) {
      // A: K-major (K4, k16 steps of 32 bytes inside the 128-byte rows) or
      // M-major (K5, k16 steps of 16 rows); B: N-major, k16 steps of 16 rows,
      // 64-column boxes BOX bytes apart.
      const uint64_t da = hopper::sw128_desc(hopper::smem_u32(sa), TGMM ? BOX : 16, 1024);
      const uint64_t db = hopper::sw128_desc(hopper::smem_u32(sb), BOX, 1024);
      hopper::fence_regs(acc.d);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        acc.mma(TGMM ? 1 : 0, da + (uint64_t)((TGMM ? kk * 2048 : kk * 32) >> 4),
                db + (uint64_t)((kk * 2048) >> 4));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc.d);
    }
    hopper::mbar_arrive(hopper::smem_u32(bars + STAGES + stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  if (!act) return;

  // Epilogue from registers: accumulator element 4j + 2i + c sits at row
  // lw * 16 + lane / 4 + 8i, column 8j + 2 (lane % 4) + c of the warpgroup's
  // 64 x BN block.
  const int r0 = m0 + 64 * h + lw * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  if (!TGMM) {
    float* o = static_cast<float*>(out);
    const bool vec2 = (N % 2 == 0) && aligned(o, 8);
#pragma unroll
    for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i, c = c0 + 8 * j;
        if (r < lo || r >= hi || c >= N) continue;
        float* p = o + (size_t)r * N + c;
        const float v0 = acc.d[4 * j + 2 * i], v1 = acc.d[4 * j + 2 * i + 1];
        if (vec2) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (c + 1 < N) p[1] = v1;
        }
      }
    }
  } else if (slot < 0) {                             // the group's only chunk: dW in bf16
    bf16* o = static_cast<bf16*>(out) + (size_t)g * K * N;
    const bool vec2 = (N % 2 == 0) && aligned(o, 4);
#pragma unroll
    for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i, c = c0 + 8 * j;
        if (r >= K || c >= N) continue;
        bf16* p = o + (size_t)r * N + c;
        const float v0 = acc.d[4 * j + 2 * i], v1 = acc.d[4 * j + 2 * i + 1];
        if (vec2) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          p[0] = __float2bfloat16(v0);
          if (c + 1 < N) p[1] = __float2bfloat16(v1);
        }
      }
    }
  } else {                                           // one chunk of several: f32 partial
    float* o = wsp + (size_t)slot * K * N;
    const bool vec2 = (N % 2 == 0) && aligned(o, 8);
#pragma unroll
    for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i, c = c0 + 8 * j;
        if (r >= K || c >= N) continue;
        float* p = o + (size_t)r * N + c;
        const float v0 = acc.d[4 * j + 2 * i], v1 = acc.d[4 * j + 2 * i + 1];
        if (vec2) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (c + 1 < N) p[1] = v1;
        }
      }
    }
  }
}

// dW[g] = the sum of group g's partials, in chunk order, for each group split
// into more than one chunk (the others were stored by gmm_wgmma_kernel).
__global__ void __launch_bounds__(256)
tgmm_reduce_kernel(const float* __restrict__ wsp, const int* __restrict__ group_sizes,
                   bf16* __restrict__ dw, int M, int K, int N, int E, int chunk_rows) {
  __shared__ int info[2];                            // chunks of this group, first slot
  const int g = blockIdx.y;
  if (threadIdx.x == 0) {
    int acc = 0, wsum = 0, chunks = 1, first = 0;
    for (int q = 0; q <= g; ++q) {
      const int start = acc;
      acc = min(acc + max(group_sizes[q], 0), M);
      const int n = acc - start;
      const int c = n > chunk_rows ? (n + chunk_rows - 1) / chunk_rows : 1;
      if (q == g) { chunks = c; first = wsum; }
      else if (c > 1) wsum += c;
    }
    info[0] = chunks;
    info[1] = first;
  }
  __syncthreads();
  const int chunks = info[0];
  if (chunks < 2) return;
  const size_t kn = (size_t)K * N;
  const float* src = wsp + (size_t)info[1] * kn;
  bf16* dst = dw + (size_t)g * kn;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if (kn % 4 == 0 && aligned(wsp, 16) && aligned(dw, 8)) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < kn / 4; i += stride) {
      float4 s = reinterpret_cast<const float4*>(src)[i];
      for (int c = 1; c < chunks; ++c) {
        const float4 p = reinterpret_cast<const float4*>(src + c * kn)[i];
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      }
      __nv_bfloat162 lohalf = __floats2bfloat162_rn(s.x, s.y);
      __nv_bfloat162 hihalf = __floats2bfloat162_rn(s.z, s.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lohalf);
      u.y = *reinterpret_cast<uint32_t*>(&hihalf);
      reinterpret_cast<uint2*>(dst)[i] = u;
    }
  } else {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < kn; i += stride) {
      float s = src[i];
      for (int c = 1; c < chunks; ++c) s += src[c * kn + i];
      dst[i] = __float2bfloat16(s);
    }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the CUDA runtime, so that the
// library needs no link against libcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

constexpr int ENCODE_FAILED = 10000;    // + the CUresult of a failed encode

// A bf16 tensor of up to 3 dims (innermost first) cut into 64 x 64 (x 1)
// boxes, 128-byte swizzled, zero-filled out of bounds.
int encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t box[3] = {64, 64, 1}, estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) gdim[i] = dims[i];
  gstride[0] = dims[0] * 2;
  if (rank > 2) gstride[1] = dims[0] * dims[1] * 2;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim,
                        gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

template <int BN_, int STAGES, int MIN_CTAS, bool TGMM, bool TMA>
int launch_ws(dim3 grid, const CUtensorMap& ma, const CUtensorMap& mb, const void* a,
              const void* b, const void* gs, void* out, float* wsp, int M, int K, int N, int E,
              int chunk_rows, cudaStream_t st) {
  auto kernel = gmm_wgmma_kernel<BN_, STAGES, MIN_CTAS, TGMM, TMA>;
  constexpr int smem = smem_bytes(BN_, STAGES);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int pair4 = K % 2 == 0 && N % 2 == 0 && aligned(a, 4) && aligned(b, 4);
  kernel<<<grid, THREADS, smem, st>>>(ma, mb, static_cast<const bf16*>(a),
                                      static_cast<const bf16*>(b), static_cast<const int*>(gs),
                                      out, wsp, M, K, N, E, chunk_rows, pair4);
  return (int)cudaGetLastError();
}

bool tma_ok(const void* a, const void* b, int K, int N) {
  return K % 8 == 0 && N % 8 == 0 && aligned(a, 16) && aligned(b, 16);
}

}  // namespace ws

}  // namespace

// Plain C entries for ctypes.  Each returns 0 on success, a cudaError_t, or
// 10000 + the CUresult of a failed tensor-map encode.
//
// grouped_gemm_gmm: K4t, out [M, Kd] bf16 from a [M, Nc] (f32 with a_f32 = 1, or
// bf16) and w [E, Kd, Nc]: out[r] = a[r] . w[g(r)]^T.  (trans = 0 is the wgmma
// entry below.)
extern "C" int grouped_gemm_gmm(const void* a, const void* w, const void* group_sizes, void* out,
                                int M, int Kd, int Nc, int E, int trans, int a_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!trans || E < 1 || E > MAX_GROUPS || M < 0 || Kd < 1 || Nc < 1 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int vec = aligned(a, 16) && aligned(w, 16) && aligned(out, 16) && Kd % 8 == 0 &&
                  Nc % 8 == 0;
  if (a_f32)
    return (int)launch_gmm<true, float, bf16>(a, w, group_sizes, out, M, Kd, Nc, E, vec, st);
  return (int)launch_gmm<true, bf16, bf16>(a, w, group_sizes, out, M, Kd, Nc, E, vec, st);
}

// grouped_gemm_gmm_wgmma: K4, out [M, N] f32 from x [M, K] bf16 and w [E, K, N]
// bf16.  large = 1: 128 x 256 tiles, 4 stages; 0: 128 x 64 tiles, 3 stages.
// use_tma = 1 needs K and N multiples of 8 and 16-byte aligned x and w; 0
// loads through cp.async.
extern "C" int grouped_gemm_gmm_wgmma(const void* x, const void* w, const void* group_sizes,
                                      void* out, int M, int K, int N, int E, int large,
                                      int use_tma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > MAX_GROUPS || M < 0 || K < 1 || N < 1 || (M + ws::BM - 1) / ws::BM + E > 65535 ||
      (use_tma && !ws::tma_ok(x, w, K, N)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (use_tma) {
    const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t db[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
    int e = ws::encode(&ma, x, 2, da);
    if (e == 0) e = ws::encode(&mb, w, 3, db);
    if (e != 0) return e;
  }
  const int visits = (M + ws::BM - 1) / ws::BM + E;
  if (large) {
    const dim3 grid((N + ws::LARGE_BN - 1) / ws::LARGE_BN, visits);
    return use_tma ? ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, false, true>(
                         grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st)
                   : ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, false, false>(
                         grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st);
  }
  const dim3 grid((N + ws::SMALL_BN - 1) / ws::SMALL_BN, visits);
  return use_tma ? ws::launch_ws<ws::SMALL_BN, ws::SMALL_STAGES, ws::SMALL_CTAS, false, true>(
                       grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st)
                 : ws::launch_ws<ws::SMALL_BN, ws::SMALL_STAGES, ws::SMALL_CTAS, false, false>(
                       grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st);
}

// grouped_gemm_tgmm: K5, dw [E, K, N] bf16 from x [M, K] and dy [M, N], both
// bf16, in chunks of chunk_rows rows; ws: f32 [slots, K, N] for the chunks of
// groups with more than one (null when M <= chunk_rows: no group has two).
// grouped_gemm_tgmm_reduce must follow whenever ws is given.
extern "C" int grouped_gemm_tgmm(const void* x, const void* dy, const void* group_sizes, void* dw,
                                 void* wsp, int M, int K, int N, int E, int chunk_rows,
                                 int use_tma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int items = std::max((M + chunk_rows - 1) / std::max(chunk_rows, 1), 1) + E - 1;
  if (E < 1 || E > MAX_GROUPS || M < 0 || K < 1 || N < 1 || chunk_rows < ws::BK ||
      (K + ws::BM - 1) / ws::BM > 65535 || items > 65535 || (M > chunk_rows && wsp == nullptr) ||
      (use_tma && !ws::tma_ok(x, dy, K, N)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) use_tma = 0;                     // no rows to read: every group gets zeros
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (use_tma) {
    const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t db[3] = {(uint64_t)N, (uint64_t)M, 1};
    int e = ws::encode(&ma, x, 2, da);
    if (e == 0) e = ws::encode(&mb, dy, 3, db);
    if (e != 0) return e;
  }
  const dim3 grid((N + ws::LARGE_BN - 1) / ws::LARGE_BN, (K + ws::BM - 1) / ws::BM, items);
  float* wf = static_cast<float*>(wsp);
  return use_tma ? ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, true, true>(
                       grid, ma, mb, x, dy, group_sizes, dw, wf, M, K, N, E, chunk_rows, st)
                 : ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, true, false>(
                       grid, ma, mb, x, dy, group_sizes, dw, wf, M, K, N, E, chunk_rows, st);
}

// grouped_gemm_tgmm_reduce: for each group of more than one chunk, dw[g] =
// the sum of its f32 partials in ws, in chunk order, rounded to bf16.
extern "C" int grouped_gemm_tgmm_reduce(const void* wsp, const void* group_sizes, void* dw, int M,
                                        int K, int N, int E, int chunk_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > MAX_GROUPS || M < 0 || K < 1 || N < 1 || chunk_rows < 1 || wsp == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t kn = (size_t)K * N;
  const unsigned blocks = (unsigned)std::min<size_t>((kn / 4 + 255) / 256 + 1, 2048);
  ws::tgmm_reduce_kernel<<<dim3(blocks, E), 256, 0, st>>>(
      static_cast<const float*>(wsp), static_cast<const int*>(group_sizes),
      static_cast<bf16*>(dw), M, K, N, E, chunk_rows);
  return (int)cudaGetLastError();
}
