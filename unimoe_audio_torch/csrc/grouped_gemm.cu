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
//          dW[g] = sum_{r in g} x[r]^T dy[r]   x [A, K] bf16, dy [A, N] f32 or bf16 -> dW [E, K, N] bf16
// Rows are sorted by group: group g owns rows [off_g, off_g + group_sizes[g]), off_g
// being the prefix sum of group_sizes (clamped to A).  A row that no group owns gets
// 0 from gmm and adds nothing to tgmm; a group with no rows reads no weights in gmm
// and gets a zero dW in tgmm.
//
// Precision: an f32 dy (the cotangent of K4's f32 output) is rounded to bf16 as it
// is loaded, the products accumulate in f32, and K4t and K5 store in bf16 (the
// dtype of x and W).  The plain versions in ops/grouped_gemm.py round the same way.
//
// What bounds them on the H100: at the training shape (A = 65,536 rows, K = 2048,
// N = 2752) each launch does 739 GFLOP on about 1 GB, so the tensor cores bound it
// (0.75 ms at 989 TFLOP/s); at a decode step (A = 128) a launch must stream the
// weights of every non-empty group (up to 90 MB, about 27 us at 3.35 TB/s), so
// bytes bound it.  The design keeps each operand tile in shared memory and reads
// group_sizes on the card, so the host never waits for the routing.
//
// Design (not the TPU's blocking: the Pallas grid walks (n tile, m tile, k tile)
// in order with group metadata from `make_group_metadata`, gmm.py:79-255; here
// blocks run in parallel):
//   * gmm: one CTA per (128-row tile, 128-column tile), 8 warps as 4 x 2, each
//     warp owning 32 x 64 outputs in 2 x 4 WMMA 16x16x16 bf16 fragments.  The CTA
//     prefix-sums group_sizes in shared memory; for each group its row tile
//     overlaps it runs the whole K loop with the other groups' rows zero-filled
//     and stores that group's rows only (a tile that straddles a boundary is
//     visited once per group, as megablox does).  Rows no group owns are
//     written as 0, so every output row is written.
//   * tgmm: one CTA per (128 k tile, 128 n tile, group), looping over the
//     group's rows 32 at a time; x^T is read as a column-major A fragment.
//   * the K (or row) loop works on 32-deep slices: the next slice's global loads
//     go to registers while the tensor cores work on the current one in shared
//     memory; ragged edges (any K and N, e.g. 2752 = 21.5 x 128, or 100) are
//     zero-filled on load and masked on store; 16-byte loads and stores where
//     the widths are multiples of 8 and the pointers 16-byte aligned.
// TMA, wgmma, a split of the rows of a large group across CTAs, and a
// persistent schedule are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // output rows per CTA (gmm: rows of x; tgmm: k)
constexpr int BN = 128;          // output columns per CTA
constexpr int BK = 32;           // depth of one slice of the reduction
constexpr int NT = 256;          // 8 warps
constexpr int MAX_GROUPS = 64;
constexpr int LDA = BK + 8;      // bf16 rows of a [*, BK] tile
constexpr int LDB = BN + 8;      // bf16 rows of a [BK, BN] tile
constexpr int LDX = BM + 8;      // bf16 rows of tgmm's [BK, BM] x tile
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

__device__ __forceinline__ void store8(float* p, const float* v, int n_valid, bool vec) {
  if (vec && n_valid >= 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n_valid) p[i] = v[i];
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

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

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
template <typename TO>
__device__ __forceinline__ void store_warp_tile(AccFrag (&acc)[2][4], float* stage, TO* out,
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

// C [M, Nc] = A [M, Kd] . B [Kd, Nc] per group.  B is W[g] read row-major
// ([Kd, Nc], TRANS = false) or as the transpose of a row-major [Nc, Kd] W[g]
// (TRANS = true).
template <bool TRANS, typename TA, typename TO>
__global__ void __launch_bounds__(NT)
gmm_kernel(const TA* __restrict__ a, const bf16* __restrict__ w, const int* __restrict__ group_sizes,
           TO* __restrict__ out, int M, int Kd, int Nc, int E, int vec_flag) {
  __shared__ __align__(128) bf16 sA[BM * LDA];
  __shared__ __align__(128) bf16 sB[TRANS ? BN * LDA : BK * LDB];
  __shared__ __align__(128) float sStage[8][16 * LDST];
  __shared__ int off[MAX_GROUPS + 1];

  typedef typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type BLayout;
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
        {  // A: rows of this group, columns k0..k0+BK
          const int row = c >> 2, col = (c & 3) * 8;
          const int gr = m0 + row, gk = k0 + col;
          const bool ok = gr >= lo && gr < hi;
          ra[p] = load8(ok ? a + (size_t)gr * Kd + gk : a, ok ? Kd - gk : 0, vec);
        }
        if constexpr (TRANS) {  // W[g] rows n0..n0+BN (of Nc), columns k0..k0+BK (of Kd)
          const int row = c >> 2, col = (c & 3) * 8;
          const int gn = n0 + row, gk = k0 + col;
          const bool ok = gn < Nc;
          rb[p] = load8(ok ? wg + (size_t)gn * Kd + gk : wg, ok ? Kd - gk : 0, vec);
        } else {      // W[g] rows k0..k0+BK, columns n0..n0+BN
          const int row = c >> 4, col = (c & 15) * 8;
          const int gk = k0 + row, gn = n0 + col;
          const bool ok = gk < Kd;
          rb[p] = load8(ok ? wg + (size_t)gk * Nc + gn : wg, ok ? Nc - gn : 0, vec);
        }
      }
    };
    auto store_slice = [&]() {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = tid + p * NT;
        *reinterpret_cast<uint4*>(sA + (c >> 2) * LDA + (c & 3) * 8) = ra[p];
        if constexpr (TRANS)
          *reinterpret_cast<uint4*>(sB + (c >> 2) * LDA + (c & 3) * 8) = rb[p];
        else
          *reinterpret_cast<uint4*>(sB + (c >> 4) * LDB + (c & 15) * 8) = rb[p];
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
          if constexpr (TRANS)
            wmma::load_matrix_sync(fb, sB + (wn * 64 + j * 16) * LDA + kk, LDA);
          else
            wmma::load_matrix_sync(fb, sB + kk * LDB + wn * 64 + j * 16, LDB);
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
    if (r < m1 && c < n1) put(out + (size_t)r * Nc + c, 0.f);
  }
}

// dW[g] [K, N] = x[rows of g]^T [K, rows] . dy[rows of g] [rows, N].
template <typename TD>
__global__ void __launch_bounds__(NT)
tgmm_kernel(const bf16* __restrict__ x, const TD* __restrict__ dy, const int* __restrict__ group_sizes,
            bf16* __restrict__ dw, int M, int K, int N, int E, int vec_flag) {
  __shared__ __align__(128) bf16 sX[BK * LDX];
  __shared__ __align__(128) bf16 sD[BK * LDB];
  __shared__ __align__(128) float sStage[8][16 * LDST];
  __shared__ int off[MAX_GROUPS + 1];

  const bool vec = vec_flag != 0;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp >> 1, wn = warp & 1;

  group_offsets(group_sizes, E, M, off);
  const int lo = off[g], hi = off[g + 1];

  uint4 rx[2], rd[2];
  auto load_slice = [&](int r0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = tid + p * NT;
      const int row = c >> 4, col = (c & 15) * 8;
      const int gr = r0 + row;
      const bool ok = gr < hi;
      const int gk = k0 + col, gn = n0 + col;
      rx[p] = load8(ok ? x + (size_t)gr * K + gk : x, ok ? K - gk : 0, vec);
      rd[p] = load8(ok ? dy + (size_t)gr * N + gn : dy, ok ? N - gn : 0, vec);
    }
  };

  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (lo < hi) load_slice(lo);
  for (int r0 = lo; r0 < hi; r0 += BK) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = tid + p * NT;
      *reinterpret_cast<uint4*>(sX + (c >> 4) * LDX + (c & 15) * 8) = rx[p];
      *reinterpret_cast<uint4*>(sD + (c >> 4) * LDB + (c & 15) * 8) = rd[p];
    }
    __syncthreads();
    if (r0 + BK < hi) load_slice(r0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = x^T: element (k, r) sits at sX[r * LDX + k], a column-major fragment.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sX + kk * LDX + wm * 32 + i * 16, LDX);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sD + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
  store_warp_tile(acc, sStage[warp], dw + (size_t)g * K * N, N, k0 + wm * 32, n0 + wn * 64, 0, K,
                  N, vec);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

}  // namespace

// Plain C entries for ctypes.  Each returns the cudaError_t of the launch (0 = ok).
//
// grouped_gemm_gmm: out [M, Nc] from a [M, Kd] and w; trans = 0: w [E, Kd, Nc],
// a bf16, out f32 (K4); trans = 1: w [E, Nc, Kd], a f32 (a_f32 = 1) or bf16,
// out bf16 (K4t).
extern "C" int grouped_gemm_gmm(const void* a, const void* w, const void* group_sizes, void* out,
                                int M, int Kd, int Nc, int E, int trans, int a_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > MAX_GROUPS || M < 0 || Kd < 1 || Nc < 1 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int vec = aligned16(a) && aligned16(w) && aligned16(out) && Kd % 8 == 0 && Nc % 8 == 0;
  if (!trans && !a_f32)
    return (int)launch_gmm<false, bf16, float>(a, w, group_sizes, out, M, Kd, Nc, E, vec, st);
  if (trans && a_f32)
    return (int)launch_gmm<true, float, bf16>(a, w, group_sizes, out, M, Kd, Nc, E, vec, st);
  if (trans && !a_f32)
    return (int)launch_gmm<true, bf16, bf16>(a, w, group_sizes, out, M, Kd, Nc, E, vec, st);
  return (int)cudaErrorInvalidValue;
}

// grouped_gemm_tgmm: dw [E, K, N] bf16 from x [M, K] bf16 and dy [M, N], f32
// (dy_f32 = 1) or bf16 (K5).
extern "C" int grouped_gemm_tgmm(const void* x, const void* dy, const void* group_sizes, void* dw,
                                 int M, int K, int N, int E, int dy_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > MAX_GROUPS || M < 0 || K < 1 || N < 1 || (K + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(dy) && aligned16(dw) && K % 8 == 0 && N % 8 == 0;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  if (dy_f32)
    tgmm_kernel<float><<<grid, NT, 0, st>>>(static_cast<const bf16*>(x),
                                            static_cast<const float*>(dy),
                                            static_cast<const int*>(group_sizes),
                                            static_cast<bf16*>(dw), M, K, N, E, vec);
  else
    tgmm_kernel<bf16><<<grid, NT, 0, st>>>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(dy),
                                           static_cast<const int*>(group_sizes),
                                           static_cast<bf16*>(dw), M, K, N, E, vec);
  return (int)cudaGetLastError();
}
