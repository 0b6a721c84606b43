// Grouped matrix products (gmm, its transposed form, tgmm) for Hopper (sm_90a):
// bf16 tensor-core products with f32 accumulation.
//
// Replaces the Pallas TPU kernels of the megablox library that the gmm
// dispatch mode reaches (`moe_ffn_gmm`, unimoe_audio_tpu/moe/dispatch.py:274-371):
//   K4   gmm   (jax/experimental/pallas/ops/tpu/megablox/gmm.py:314, pallas_call :526)
//          out[r] = x[r] . W[g(r)]       x [A, K] bf16, W [E, K, N] bf16 -> out [A, N] f32
//   K4t  gmm(transpose_rhs=True), the input gradient of its custom VJP (megablox/ops.py:80-89)
//          dx[r] = dy[r] . W[g(r)]^T     dy [A, N] bf16, W bf16 -> dx [A, K] bf16
//   K5   tgmm  (gmm.py:573, pallas_call :763), the weight gradient (ops.py:90-99)
//          dW[g] = sum_{r in g} x[r]^T dy[r]   x [A, K] bf16, dy [A, N] bf16 -> dW [E, K, N] bf16
// Rows are sorted by group: group g owns rows [off_g, off_g + group_sizes[g]), off_g
// being the prefix sum of group_sizes (clamped to A).  A row that no group owns gets
// 0 from gmm and adds nothing to tgmm; a group with no rows reads no weights in gmm
// and gets a zero dW in tgmm.  Group sizes are read on the card only.
//
// Precision: the products accumulate in f32; K4t and K5 store in bf16 (the dtype
// of x and W).  Both take dy in bf16: their wrappers round an f32 dy once, to
// nearest even, before the launch (TMA copies bytes and cannot round).
//
// What bounds them on the H100: at the training shape (A = 65,536 rows, K = 2048,
// N = 2752) each launch does 739 GFLOP on about 1 GB, so the tensor cores bound it
// (0.75 ms at 989 TFLOP/s); at a decode step (A = 128) a launch must stream the
// weights of every non-empty group (up to 90 MB, about 27 us at 3.35 TB/s), so
// bytes bound it.
//
// K4, K4t and K5 are three modes of one kernel (`gmm_wgmma_kernel`):
// warp-specialised wgmma.
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
//   * K4t is K4 with the B operand read K-major: dy is the K-major A, and a
//     B stage is BN/64 boxes of W[g] cut from the same {contraction, output
//     column, group} map, each 64 output columns of 64 contiguous
//     contraction elements, which together form one [BN x 64] K-major tile
//     for wgmma (B descriptor K-major, k16 steps of 32 bytes).  Same visits,
//     zero rows and edges as K4; it takes the large configuration only (it
//     runs in training, at A = 65,536).
//   * K5 reads x^T (M-major A) and dy (N-major B).  Its work items are
//     (group, chunk of at most R rows) pairs, so a large group's rows (the
//     last group holds the unselected and padding rows: 61 % of them at the
//     training shape) spread over many CTAs.  A group with one chunk stores its
//     dW tile in bf16; the chunks of a larger group store f32 partials into a
//     workspace, and `tgmm_reduce_kernel` sums each group's partials in chunk
//     order into bf16.  No atomics: two launches give the same bits.  Rows of a
//     stage past the chunk's end are zeroed in shared memory before the
//     products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "hopper_ptx.cuh"
#include "hopper_tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_GROUPS = 64;

__host__ __device__ __forceinline__ bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// ---- K4, K4t and K5: TMA / cp.async ring, wgmma ------------------------------------

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

// The three products of one kernel: which operand is read how, and what is
// stored.
enum Mode { GMM = 0, GMM_T = 1, TGMM = 2 };

template <int BN_>
struct Acc;
template <>
struct Acc<64> {
  float d[32];
  template <int TA, int TB>
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db) {
    hopper::wgmma_m64n64k16<TA, TB>(d, da, db);
  }
};
template <>
struct Acc<256> {
  float d[128];
  template <int TA, int TB>
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db) {
    hopper::wgmma_m64n256k16<TA, TB>(d, da, db);
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

// Stores a warpgroup's accumulator rows [lo, hi) and columns below N of a
// row-major [*, N] output (f32 or bf16) from registers: element 4j + 2i + c
// sits at row r0 + 8i, column c0 + 8j + c.
template <int BN_, typename T>
__device__ __forceinline__ void store_tile(const float (&d)[BN_ / 2], T* o, int N, int r0, int c0,
                                           int lo, int hi) {
  const bool vec2 = (N % 2 == 0) && aligned(o, 2 * sizeof(T));
#pragma unroll
  for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, c = c0 + 8 * j;
      if (r < lo || r >= hi || c >= N) continue;
      T* p = o + (size_t)r * N + c;
      const float v0 = d[4 * j + 2 * i], v1 = d[4 * j + 2 * i + 1];
      if constexpr (sizeof(T) == 4) {
        if (vec2) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        else { p[0] = v0; if (c + 1 < N) p[1] = v1; }
      } else {
        if (vec2) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        else { p[0] = __float2bfloat16(v0); if (c + 1 < N) p[1] = __float2bfloat16(v1); }
      }
    }
  }
}

// K is the contraction length and N the output width in every mode.
// GMM (K4): A = x [M, K] (K-major), B = W [E, K, N] (N-major), out f32
//   [M, N]; blockIdx = (column tile, visit).
// GMM_T (K4t): A = dy [M, K] (K-major), B = W[g]^T read from W [E, N, K]
//   (K-major: the contraction is W's contiguous dimension), out bf16 [M, N];
//   blockIdx = (column tile, visit).
// TGMM (K5): A = x^T, read from x [M, K'] (M-major; K' = the output rows of
//   dW, passed as K), B = dy [M, N] (N-major), out bf16 dW [E, K, N] or f32
//   partials in ws; blockIdx = (column tile, k tile, work item); chunk_rows = R.
// map_a: x or dy as {K, M}, boxes of 64 x 64; map_b: W as {N, K, E} (K4),
// {K, N, E} (K4t) or dy as {N, M, 1} (K5), boxes of 64 x 64 x 1; all
// 128-byte swizzled (TMA only).
template <int BN_, int STAGES, int MIN_CTAS, int MODE, bool TMA>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ a,
                 const bf16* __restrict__ b, const int* __restrict__ group_sizes,
                 void* __restrict__ out, float* __restrict__ wsp, int M, int K, int N, int E,
                 int chunk_rows, int pair4_flag) {
  constexpr bool T5 = MODE == TGMM;
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
    if (!T5) {
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
  if (!T5 && g == E) {                               // rows no group owns: 0
    for (int i = tid; i < (hi - lo) * BN_; i += THREADS) {
      const int r = lo + i / BN_, c = n0 + i % BN_;
      if (c >= N) continue;
      if (MODE == GMM) static_cast<float*>(out)[(size_t)r * N + c] = 0.f;
      else static_cast<bf16*>(out)[(size_t)r * N + c] = __float2bfloat16(0.f);
    }
    return;
  }

  // Which 64-row halves of A carry work: K4 and K4t, the halves holding rows
  // of the group; K5, the halves inside K.
  bool need[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    need[h] = T5 ? m0 + 64 * h < K : (m0 + 64 * h < hi && m0 + 64 * h + 64 > lo);
  const int nsteps = T5 ? (hi - lo + BK - 1) / BK : (K + BK - 1) / BK;
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
          if (T5)
            hopper::tma_load_2d(hopper::smem_u32(sa + h * BOX), &map_a, full, m0 + 64 * h,
                                lo + s * BK);
          else
            hopper::tma_load_2d(hopper::smem_u32(sa + h * BOX), &map_a, full, s * BK,
                                m0 + 64 * h);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t dst = hopper::smem_u32(sb + j * BOX);
          if (MODE == TGMM) hopper::tma_load_3d(dst, &map_b, full, n0 + 64 * j, lo + s * BK, 0);
          else if (MODE == GMM_T) hopper::tma_load_3d(dst, &map_b, full, s * BK, n0 + 64 * j, g);
          else hopper::tma_load_3d(dst, &map_b, full, n0 + 64 * j, s * BK, g);
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
            if (T5) { row = lo + s * BK + r; col = m0 + 64 * h + c; row_ok = row < hi; }
            else { row = m0 + 64 * h + r; col = s * BK + c; row_ok = row < M; }
            copy_pair(sa + h * BOX + hopper::swizzle128(r, c), a + (size_t)row * K + col,
                      row_ok, K - col, pair4, a);
          }
        }
        for (int j = 0; j < NB; ++j) {
          for (int i = lane; i < 64 * 32; i += 32) {
            const int r = i >> 5, c = (i & 31) * 2;
            const bf16* src;
            bool row_ok;
            int left;
            if (MODE == GMM_T) {          // box row = output column, columns = contraction
              const int oc = n0 + 64 * j + r, kc = s * BK + c;
              src = b + ((size_t)g * N + oc) * K + kc;
              row_ok = oc < N;
              left = K - kc;
            } else {
              const int col = n0 + 64 * j + c;
              const int row = T5 ? lo + s * BK + r : s * BK + r;
              row_ok = T5 ? row < hi : row < K;
              src = b + (T5 ? (size_t)row * N : ((size_t)g * K + row) * N) + col;
              left = N - col;
            }
            copy_pair(sb + j * BOX + hopper::swizzle128(r, c), src, row_ok, left, pair4, b);
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
    if (T5) {
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
      // A: K-major (K4, K4t: k16 steps of 32 bytes inside the 128-byte rows)
      // or M-major (K5: k16 steps of 16 rows).  B: N-major (K4, K5: k16 steps
      // of 16 rows, 64-column boxes BOX bytes apart) or K-major (K4t: the
      // NB boxes are one [BN_ x 64] tile of 128-byte rows, k16 steps of 32
      // bytes).
      constexpr int TA = T5 ? 1 : 0, TB = MODE == GMM_T ? 0 : 1;
      const uint64_t da = hopper::sw128_desc(hopper::smem_u32(sa), T5 ? BOX : 16, 1024);
      const uint64_t db = hopper::sw128_desc(hopper::smem_u32(sb), TB ? BOX : 16, 1024);
      hopper::fence_regs(acc.d);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        acc.template mma<TA, TB>(da + (uint64_t)((TA ? kk * 2048 : kk * 32) >> 4),
                                 db + (uint64_t)((TB ? kk * 2048 : kk * 32) >> 4));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc.d);
    }
    hopper::mbar_arrive(hopper::smem_u32(bars + STAGES + stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  if (!act) return;

  // Epilogue from registers (the layout in hopper_ptx.cuh).
  const int r0 = m0 + 64 * h + lw * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  if (MODE == GMM)
    store_tile<BN_>(acc.d, static_cast<float*>(out), N, r0, c0, lo, hi);
  else if (MODE == GMM_T)
    store_tile<BN_>(acc.d, static_cast<bf16*>(out), N, r0, c0, lo, hi);
  else if (slot < 0)                                 // the group's only chunk: dW in bf16
    store_tile<BN_>(acc.d, static_cast<bf16*>(out) + (size_t)g * K * N, N, r0, c0, 0, K);
  else                                               // one chunk of several: f32 partial
    store_tile<BN_>(acc.d, wsp + (size_t)slot * K * N, N, r0, c0, 0, K);
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

template <int BN_, int STAGES, int MIN_CTAS, int MODE, bool TMA>
int launch_ws(dim3 grid, const CUtensorMap& ma, const CUtensorMap& mb, const void* a,
              const void* b, const void* gs, void* out, float* wsp, int M, int K, int N, int E,
              int chunk_rows, cudaStream_t st) {
  auto kernel = gmm_wgmma_kernel<BN_, STAGES, MIN_CTAS, MODE, TMA>;
  constexpr int smem = smem_bytes(BN_, STAGES);
  static hopper::PerDevice configured;
  const cudaError_t set = configured.once([&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    return e;
  });
  if (set != cudaSuccess) return (int)set;
  const int pair4 = K % 2 == 0 && N % 2 == 0 && aligned(a, 4) && aligned(b, 4);
  kernel<<<grid, THREADS, smem, st>>>(ma, mb, static_cast<const bf16*>(a),
                                      static_cast<const bf16*>(b), static_cast<const int*>(gs),
                                      out, wsp, M, K, N, E, chunk_rows, pair4);
  return (int)cudaGetLastError();
}

// TMA addresses rows whose stride is a multiple of 16 bytes from 16-byte
// aligned bases: the contraction K for every operand of K4t (dy and W rows
// both hold K elements), K and N otherwise.
bool tma_ok(const void* a, const void* b, int K, int N, int mode) {
  return K % 8 == 0 && (mode == GMM_T || N % 8 == 0) && aligned(a, 16) && aligned(b, 16);
}

// A 2-d or 3-d bf16 tensor (dims innermost first) in 64 x 64 (x 1) boxes.
int encode64(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims) {
  static const uint32_t box[3] = {64, 64, 1};
  return hopper::encode(map, ptr, rank, dims, box);
}

}  // namespace ws

}  // namespace

// Plain C entries for ctypes.  Each returns 0 on success, a cudaError_t, or
// 10000 + the CUresult of a failed tensor-map encode (hopper::ENCODE_FAILED).
//
// grouped_gemm_gmm_wgmma: K is the contraction and N the output width.
//   trans = 0, K4: out [M, N] f32 = x [M, K] . w[g] for w [E, K, N];
//   trans = 1, K4t: out [M, N] bf16 = x [M, K] . w[g]^T for w [E, N, K]
//     (x is dy; large only).
// x and w bf16.  large = 1: 128 x 256 tiles, 4 stages; 0: 128 x 64 tiles, 3
// stages.  use_tma = 1 needs 16-byte aligned x and w and row strides that
// are multiples of 8 elements (K and N for K4, K for K4t); 0 loads through
// cp.async.
extern "C" int grouped_gemm_gmm_wgmma(const void* x, const void* w, const void* group_sizes,
                                      void* out, int M, int K, int N, int E, int large,
                                      int use_tma, int trans, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mode = trans ? ws::GMM_T : ws::GMM;
  if (E < 1 || E > MAX_GROUPS || M < 0 || K < 1 || N < 1 || (M + ws::BM - 1) / ws::BM + E > 65535 ||
      (trans && !large) || (use_tma && !ws::tma_ok(x, w, K, N, mode)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (use_tma) {
    const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t db[3] = {(uint64_t)(trans ? K : N), (uint64_t)(trans ? N : K), (uint64_t)E};
    int e = ws::encode64(&ma, x, 2, da);
    if (e == 0) e = ws::encode64(&mb, w, 3, db);
    if (e != 0) return e;
  }
  const int visits = (M + ws::BM - 1) / ws::BM + E;
  if (trans) {
    const dim3 grid((N + ws::LARGE_BN - 1) / ws::LARGE_BN, visits);
    return use_tma ? ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, ws::GMM_T, true>(
                         grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st)
                   : ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, ws::GMM_T, false>(
                         grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st);
  }
  if (large) {
    const dim3 grid((N + ws::LARGE_BN - 1) / ws::LARGE_BN, visits);
    return use_tma ? ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, ws::GMM, true>(
                         grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st)
                   : ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, ws::GMM, false>(
                         grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st);
  }
  const dim3 grid((N + ws::SMALL_BN - 1) / ws::SMALL_BN, visits);
  return use_tma ? ws::launch_ws<ws::SMALL_BN, ws::SMALL_STAGES, ws::SMALL_CTAS, ws::GMM, true>(
                       grid, ma, mb, x, w, group_sizes, out, nullptr, M, K, N, E, 0, st)
                 : ws::launch_ws<ws::SMALL_BN, ws::SMALL_STAGES, ws::SMALL_CTAS, ws::GMM, false>(
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
      (use_tma && !ws::tma_ok(x, dy, K, N, ws::TGMM)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) use_tma = 0;                     // no rows to read: every group gets zeros
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (use_tma) {
    const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t db[3] = {(uint64_t)N, (uint64_t)M, 1};
    int e = ws::encode64(&ma, x, 2, da);
    if (e == 0) e = ws::encode64(&mb, dy, 3, db);
    if (e != 0) return e;
  }
  const dim3 grid((N + ws::LARGE_BN - 1) / ws::LARGE_BN, (K + ws::BM - 1) / ws::BM, items);
  float* wf = static_cast<float*>(wsp);
  return use_tma ? ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, ws::TGMM, true>(
                       grid, ma, mb, x, dy, group_sizes, dw, wf, M, K, N, E, chunk_rows, st)
                 : ws::launch_ws<ws::LARGE_BN, ws::LARGE_STAGES, ws::LARGE_CTAS, ws::TGMM, false>(
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
