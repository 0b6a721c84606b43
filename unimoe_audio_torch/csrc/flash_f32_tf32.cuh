// The f32 flash-attention kernels' building blocks (flash_attention_f32.cu,
// the forward; flash_attention_bwd_f32.cu, dq and dk / dv): error-compensated
// TF32 products on the tensor cores over swizzled f32 tiles fed by cp.async.
//
// The arithmetic, "3xTF32" (CUTLASS's OpMultiplyAddFastF32): every matrix
// product runs as three TF32 products on the tensor cores.  Each f32 operand
// x is split in registers into hi = tf32(x), rounded to nearest with ties away
// from zero (the rounding of cvt.rna.tf32.f32, done as an integer add and mask:
// ptxas expands the cvt into four instructions with an inf / NaN guard, the
// add and mask are two), and lo = x - hi, exact in f32, which the tensor core
// reads as TF32 by dropping its low 13 bits (lo rounded toward zero: within
// 2^-22 |x|, where rounding it to nearest first would be within 2^-23 |x|;
// in development runs at the training shape that rounding left the error
// against the plain versions where it was and cost time).  Each product is
// hi_a hi_b + (hi_a lo_b + lo_a hi_b); lo_a lo_b (below 2^-22 of it) is
// dropped, so a product keeps about 21 bits where TF32 alone keeps 11.  The
// two correction products accumulate in f32 in their own accumulator and are
// added to the main one at the end of each tile: for S-like products
// (`product_xyt`) at the end of their Dh-deep sums; for the products into an
// output (`product_ab`: the forward's O, dq, dk and dv) each tile's product is
// formed in a main and a correction tile accumulator (32 output columns at a
// time) and added to the running sum in f32 on the CUDA cores, so no
// tensor-core sum runs longer than one tile.
//
// The instruction: `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`.
// wgmma's tf32 form reads both operands K-major from shared memory and cannot
// transpose 32-bit types, so every tile read both ways (Q, dO, K and V in the
// backward; V in the forward, whose P V product wants it MN-major) would need
// a transposed copy, and hi and lo copies of each: a 64 x 128 tile then costs
// 64 KB.  mma.sync takes its fragments from registers: one f32 copy of each
// tile sits in shared memory and the split happens in registers.
//
// Layouts: every tile is row-major [rows][Dh] f32, element (r, c) at column
// c ^ swz(r) (bit 4 of c flipped by bit 0 ^ bit 2 of r, bit 3 by bit 1 of r).
// The fragments read a tile two ways: rows g, g + 8 (the A operand, and the B
// operand of S = X Y^T) and rows 2t, 2t + 1 (the B operand of out += A B,
// whose A is the C fragment of S left in registers: a C fragment holds
// columns 2t, 2t + 1 where an A fragment wants t, t + 4, so the k index is
// permuted to match).  The k index of S-like products and the n index of the
// others are permuted too, so that a thread's operands are 4 adjacent floats:
// one 128-bit read, free of bank conflicts under the swizzle for both
// patterns.  With g = lane / 4 and t = lane % 4 throughout.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace tf32x3 {

constexpr int THREADS = 256;       // a CTA of either f32 kernel: 8 warps
constexpr int MAX_DEVICES = 64;

// Element (r, c) of a row-major [rows][DH] tile sits at r * DH + (c ^ swz(r)):
// bit 4 of c XORed with bit 0 ^ bit 2 of r and bit 3 with bit 1 of r, which
// keeps every 128-bit fragment read of the products below free of bank
// conflicts (see above) and every 16-byte chunk whole.
__device__ __forceinline__ int swz(int r) {
  return ((((r >> 2) ^ r) & 1) << 4) | (((r >> 1) & 1) << 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = hopper::tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The A fragment (4 values) split into hi and lo.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// One 3xTF32 step: c += a_lo b_hi + a_hi b_lo (the corrections), d += a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float b0, const float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  hopper::mma_m16n8k8_tf32(c, al, bh0, bh1);
  hopper::mma_m16n8k8_tf32(c, ah, bl0, bl1);
  hopper::mma_m16n8k8_tf32(d, ah, bh0, bh1);
}

// Rows [r0, r0 + R) of a row-major [n, DH] f32 matrix into a swizzled
// [R][DH] tile by 16-byte cp.async; rows past n are zero-filled.
template <int DH, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int n) {
  constexpr int CH = DH / 4;
  static_assert((R * CH) % THREADS == 0, "a tile is a whole number of rounds");
#pragma unroll
  for (int e = threadIdx.x; e < R * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool in = r0 + r < n;
    hopper::cp_async16(hopper::smem_u32(dst + r * DH + (c ^ swz(r))),
                       src + (size_t)(in ? r0 + r : 0) * DH + c, in ? 16 : 0);
  }
}

// src[i0 .. i0 + N) of 4-byte values into dst by cp.async; past n zero-filled.
template <int N>
__device__ __forceinline__ void load_vec(void* dst, const void* src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool in = i0 + i < n;
    hopper::cp_async4(hopper::smem_u32(static_cast<char*>(dst) + 4 * i),
                      static_cast<const char*>(src) + 4 * (size_t)(in ? i0 + i : 0), in ? 4 : 0);
  }
}

// acc = X Y^T over DH for one warp: X's rows xr and xr + 8 (xr = a multiple
// of 8 plus g: the A fragments) against Y's rows yr + 8 n, n < 4 (yr likewise:
// the B fragments), both swizzled [.][DH] tiles; 16 x 32 in C fragments:
// acc[n][e] is row xr + 8 (e / 2), column (Y row) 8 n + 2 t + e % 2.  The
// k index is permuted: of each 16 columns, k-step 2 u takes columns
// 16 u + 4 t and + 1 as A columns t and t + 4, k-step 2 u + 1 takes + 2 and
// + 3, so one 128-bit read gives a thread its operands of two k-steps.  Main
// and correction sums, added at the end.
template <int DH>
__device__ __forceinline__ void product_xyt(float (&acc)[4][4], float (&cor)[4][4],
                                            const float* X, int xr, const float* Y, int yr,
                                            int t) {
  const float* x0 = X + xr * DH;
  const float* x1 = x0 + 8 * DH;
  const float* y = Y + yr * DH;
  const int sx = swz(xr), sy = swz(yr);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = cor[n][e] = 0.f;
#pragma unroll 2
  for (int u = 0; u < DH / 16; ++u) {
    const int c = 16 * u + 4 * t;
    const float4 p = ld4(x0 + (c ^ sx)), q = ld4(x1 + (c ^ sx));
    const float a[4] = {p.x, q.x, p.y, q.y}, a2[4] = {p.z, q.z, p.w, q.w};
    uint32_t ah[4], al[4], ah2[4], al2[4];
    split4(a, ah, al);
    split4(a2, ah2, al2);
    const int cy = c ^ sy;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 b = ld4(y + 8 * n * DH + cy);
      mma3(acc[n], cor[n], ah, al, b.x, b.y);
      mma3(acc[n], cor[n], ah2, al2, b.z, b.w);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += cor[n][e];
}

// out[16 x DH] += A B for one warp, A the 16 x 32 C fragments in `a` (the k
// index permuted: A column t of k-step j is column 8 j + 2 t of the C tile,
// t + 4 is 8 j + 2 t + 1) and B rows br + 8 j (+ 1) of a swizzled [.][DH] tile
// (br = a multiple of 8 plus 2 t): one tile of O, dq, dv or dk, formed 32
// columns at a time in a main and a correction accumulator and added to `out`
// in f32.  The n index is permuted too: of each 32 columns, n-tile s < 4 takes
// columns 4 c' + s (c' < 8 its B and C column), so that one 128-bit read gives
// a thread its B operands of all four; out[n][e] holds column
// 32 (n / 4) + 8 t + 4 (e % 2) + n % 4 of row g + 8 (e / 2).
template <int DH>
__device__ __forceinline__ void product_ab(float (&out)[DH / 8][4], const float (&a)[4][4],
                                           const float* B, int br, int g) {
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x[4] = {a[j][0], a[j][2], a[j][1], a[j][3]};
    split4(x, ah[j], al[j]);
  }
  const float* b0 = B + br * DH;
  const float* b1 = b0 + DH;
  const int c0 = (4 * g) ^ swz(br), c1 = (4 * g) ^ swz(br + 1);
#pragma unroll
  for (int c = 0; c < DH / 32; ++c) {
    float acc[4][4], cor[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = cor[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v0 = ld4(b0 + 8 * j * DH + 32 * c + c0);
      const float4 v1 = ld4(b1 + 8 * j * DH + 32 * c + c1);
      mma3(acc[0], cor[0], ah[j], al[j], v0.x, v1.x);
      mma3(acc[1], cor[1], ah[j], al[j], v0.y, v1.y);
      mma3(acc[2], cor[2], ah[j], al[j], v0.z, v1.z);
      mma3(acc[3], cor[3], ah[j], al[j], v0.w, v1.w);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * c + n][e] += acc[n][e] + cor[n][e];
  }
}

// Row i (0: g, 1: g + 8) of out[] (the layout of product_ab) as floats
// 32 c + 8 t + 4 h .. + 3, c < DH / 32, h < 2: n = 4 c .. 4 c + 3, e = 2 i + h.
template <int DH>
__device__ __forceinline__ float4 out4(const float (&out)[DH / 8][4], int c, int i, int h) {
  return make_float4(out[4 * c][2 * i + h], out[4 * c + 1][2 * i + h],
                     out[4 * c + 2][2 * i + h], out[4 * c + 3][2 * i + h]);
}

// Raise a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != 0) return e;
    done[dev] = true;
  }
  return 0;
}

}  // namespace tf32x3
