// Causal GQA flash-attention backward in f32 for Hopper (sm_90a): dq, and dk /
// dv with their GQA sum, on the tensor cores in error-compensated TF32.
//
// Replaces the Pallas TPU kernels of unimoe_audio_tpu/ops/flash_attention.py
// for f32 inputs, which compute in the input dtype (`p.astype(v.dtype)` stays
// f32 there):
//   * flash_bwd_dq_tf32_kernel  <- `_flash_bwd_dq_kernel`  (:150-205, call :323)
//   * flash_bwd_dkv_tf32_kernel <- `_flash_bwd_dkv_kernel` (:208-275, call :348)
//     with the GQA sum (:376-379) folded in.
// The contract is the bf16 kernels' (flash_attention_bwd.cu) with f32 inputs
// and outputs: q, dO [B,H,T,Dh], k/v [B,KV,S,Dh], kv_valid [B,S] int32
// (1 = attendable); query head h reads kv head h / (H/KV); query row i sits at
// key position i + (S - T).  From the forward's residuals m, l [B*H, T] f32
// and D = rowsum(dO * O) from the caller, the kernels rebuild
// P = exp(s - m) / max(l, 1e-30) where the key is attendable (0 elsewhere:
// padding, the diagonal, keys past S, rows past T), dP = dO V^T and
// dS = P (dP - D), all in f32 on the CUDA cores; dq = scale dS K,
// dv = P^T dO, dk = scale dS^T Q, dk and dv summed over each kv head's
// H / KV query heads.  A dead row (no attendable key) gets dq exactly 0.
//
// The arithmetic, "3xTF32" (every matrix product as three TF32 products on
// the tensor cores, about 21 bits a product), the instruction (mma.sync
// m16n8k8, and why not wgmma) and the tile layouts are those of the shared
// building blocks in flash_f32_tf32.cuh, which the forward
// (flash_attention_f32.cu) uses too.  Here the B operand read from rows
// 2t, 2t + 1 is K in dq = dS K, dO in dv = P^T dO and Q in dk = dS^T Q, whose
// A is the C fragment of S or S^T; dS never leaves the registers.
//
// Tiles (8 warps, 256 threads, one CTA per SM by shared memory; every copy a
// 16-byte cp.async, double-buffered so that the next tile's copy is in flight
// while this one is used):
//   * dq: one CTA per (128 query rows, b*H + h), the row tile with the most
//     key tiles launched first.  Q and dO are loaded once; K, V and kv_valid
//     stream in tiles of 32 keys.  A warp owns 16 query rows: S and dP
//     (16 x 32, main and correction accumulators), P and dS in registers, dq
//     (16 x Dh) in registers.  A warp skips a tile wholly above its diagonal.
//     Shared memory 196,864 bytes at Dh 128.
//   * dk / dv: one CTA per (64 keys, b*KV + kv head), key tile 0 (the most
//     query tiles) first; the CTA walks its kv head's H / KV query heads in
//     head order, each from the first 64-row query tile that can see its keys,
//     so each head's contribution is summed on chip: no per-head scratch and no
//     second kernel (256 CTAs at the training shape, about two waves; one CTA
//     per query head with a scratch tensor and a summing kernel measured
//     slower, see PERF.md).  K and V are loaded once; Q, dO, m, l and D stream
//     in tiles of 64 rows.  Warp w owns keys 16 (w % 4) .. + 15 and the tile's
//     rows 32 (w / 4) .. + 31: S^T = K Q^T, then P^T and dV += P^T dO, then
//     dP^T = V dO^T, dS^T and dK += dS^T Q; dk and dv (2 x 16 x Dh) stay in
//     registers.  At the end warp w + 4 hands its dk and dv to warp w through
//     shared memory (lower + upper), which scales and writes them once.
//     Shared memory 198,400 bytes at Dh 128.
// Every sum runs in a fixed order (no atomics), so two launches give the same
// bits.
//
// What bounds them on the H100: at the training shape (B 4, H 16, KV 2,
// T = S = 2048, Dh 128, causal) dq does 103 and dk/dv 138 GFLOP of f32
// products: 0.62 and 0.83 ms at 495 / 3 = 165 TFLOP/s (1.54 and 2.05 ms at
// the CUDA cores' 67).  mma.sync reaches only part of the 495 TF32 rate,
// and per mma.sync a warp also issues the split's integer and float
// operations and a share of a 128-bit shared-memory read; PERF.md gives the
// times, the registers and spills (ptxas -v) and where the time goes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_f32_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int DQ_ROWS = 128;       // dq: query rows of a CTA, 16 a warp
constexpr int DQ_KEYS = 32;        // dq: keys of a streamed K / V tile
constexpr int DKV_KEYS = 64;       // dk/dv: keys of a CTA, 16 a warp
constexpr int DKV_ROWS = 64;       // dk/dv: query rows of a streamed tile, 32 a warp

// ---- dq ----

template <int DH>
struct DqSmem {
  static constexpr int Q = 0;                          // Q [DQ_ROWS][DH]
  static constexpr int DO = Q + DQ_ROWS * DH;          // dO [DQ_ROWS][DH]
  static constexpr int K = DO + DQ_ROWS * DH;          // K [2][DQ_KEYS][DH]
  static constexpr int V = K + 2 * DQ_KEYS * DH;       // V [2][DQ_KEYS][DH]
  static constexpr int VALID = V + 2 * DQ_KEYS * DH;   // kv_valid [2][DQ_KEYS]
  static constexpr int TOTAL = (VALID + 2 * DQ_KEYS) * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                         float* __restrict__ dq, int H, int KV, int T, int S, int causal,
                         float scale) {
  using L = DqSmem<DH>;
  extern __shared__ __align__(16) float smem[];
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = b * KV + h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off = S - T;
  const int w0 = q0 + 16 * warp;                       // the warp's first row
  const float* kb = k + (size_t)kvh * S * DH;
  const float* vb = v + (size_t)kvh * S * DH;
  const int* valid = kv_valid + (size_t)b * S;

  int row[2];
  float mr[2], linv[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = w0 + g + 8 * i;
    const size_t at = (size_t)bh * T + min(row[i], T - 1);
    mr[i] = m[at];
    linv[i] = 1.f / fmaxf(l[at], 1e-30f);
    dr[i] = dvec[at];
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Keys past the last row's diagonal are never attended.
  const int s_end = causal ? min(S, q0 + DQ_ROWS + off) : S;
  const int n_tiles = s_end > 0 ? (s_end + DQ_KEYS - 1) / DQ_KEYS : 0;
  auto load_kv = [&](int j) {
    const int buf = j & 1, s0 = j * DQ_KEYS;
    load_rows<DH, DQ_KEYS>(smem + L::K + buf * DQ_KEYS * DH, kb, s0, S);
    load_rows<DH, DQ_KEYS>(smem + L::V + buf * DQ_KEYS * DH, vb, s0, S);
    load_vec<DQ_KEYS>(valid_s + buf * DQ_KEYS, valid, s0, S);
  };
  if (n_tiles > 0) {
    load_rows<DH, DQ_ROWS>(smem + L::Q, q + (size_t)bh * T * DH, q0, T);
    load_rows<DH, DQ_ROWS>(smem + L::DO, dout + (size_t)bh * T * DH, q0, T);
    load_kv(0);
    hopper::cp_async_commit();
    if (n_tiles > 1) load_kv(1);
    hopper::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    hopper::cp_async_wait_group<1>();
    __syncthreads();
    const int buf = j & 1, s0 = j * DQ_KEYS;
    const float* ks = smem + L::K + buf * DQ_KEYS * DH;
    const float* vs = smem + L::V + buf * DQ_KEYS * DH;
    const int* vv = valid_s + buf * DQ_KEYS;
    // A warp whose rows are all past T, or all above this tile's keys, skips it.
    if (w0 < T && !(causal && s0 > w0 + 15 + off)) {
      float s[4][4], dp[4][4], cor[4][4];
      product_xyt<DH>(s, cor, smem + L::Q, 16 * warp + g, ks, g, t);
      product_xyt<DH>(dp, cor, smem + L::DO, 16 * warp + g, vs, g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kl = 8 * n + 2 * t + (e & 1), key = s0 + kl;
          const bool ok = row[i] < T && vv[kl] > 0 && (!causal || key <= row[i] + off);
          const float p = ok ? expf(s[n][e] * scale - mr[i]) * linv[i] : 0.f;
          s[n][e] = ok ? p * (dp[n][e] - dr[i]) : 0.f;
        }
      product_ab<DH>(acc, s, ks, 2 * t, g);
    }
    __syncthreads();                                   // every warp is done with buf
    if (j + 2 < n_tiles) load_kv(j + 2);
    hopper::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T) continue;
    float* out = dq + ((size_t)bh * T + row[i]) * DH + 8 * t;
#pragma unroll
    for (int c = 0; c < DH / 32; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 x = out4<DH>(acc, c, i, h);
        *reinterpret_cast<float4*>(out + 32 * c + 4 * h) =
            make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
  }
}

// ---- dk, dv ----

template <int DH>
struct DkvSmem {
  static constexpr int K = 0;                          // K [DKV_KEYS][DH]
  static constexpr int V = K + DKV_KEYS * DH;          // V [DKV_KEYS][DH]
  static constexpr int Q = V + DKV_KEYS * DH;          // Q [2][DKV_ROWS][DH]
  static constexpr int DO = Q + 2 * DKV_ROWS * DH;     // dO [2][DKV_ROWS][DH]
  static constexpr int STATS = DO + 2 * DKV_ROWS * DH; // m, l, D [2][3][DKV_ROWS]
  static constexpr int VALID = STATS + 6 * DKV_ROWS;   // kv_valid [DKV_KEYS]
  static constexpr int TOTAL = (VALID + DKV_KEYS) * 4;
  // After the loop the upper warps' dk and dv, [2][4 warps][DH / 8][4][32
  // lanes], over Q and dO.
  static_assert(2 * 4 * DH * 16 <= 4 * DKV_ROWS * DH, "the reduction fits over Q and dO");
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ m, const float* __restrict__ l,
                          const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                          float* __restrict__ dk_out, float* __restrict__ dv_out, int H, int KV,
                          int T, int S, int causal, float scale) {
  using L = DkvSmem<DH>;
  extern __shared__ __align__(16) float smem[];
  const int* valid_s = reinterpret_cast<const int*>(smem + L::VALID);

  const int bkv = blockIdx.x, b = bkv / KV, G = H / KV;
  const int k0 = blockIdx.y * DKV_KEYS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw = 16 * (warp & 3), rw = 32 * (warp >> 2);   // the warp's keys and rows
  const int off = S - T;

  load_rows<DH, DKV_KEYS>(smem + L::K, k + (size_t)bkv * S * DH, k0, S);
  load_rows<DH, DKV_KEYS>(smem + L::V, v + (size_t)bkv * S * DH, k0, S);
  load_vec<DKV_KEYS>(smem + L::VALID, kv_valid + (size_t)b * S, k0, S);
  // The first query row that can see key k0 sits at k0 - (S - T) (< T).
  const int r_start = causal ? (max(0, k0 - off) / DKV_ROWS) * DKV_ROWS : 0;
  const int n_rt = (T - r_start + DKV_ROWS - 1) / DKV_ROWS;
  const int n_tiles = G * n_rt;                        // head-major, rows within a head
  auto load_q = [&](int i) {
    const int buf = i & 1, r0 = r_start + (i % n_rt) * DKV_ROWS;
    const size_t bh = (size_t)b * H + (size_t)(bkv % KV) * G + i / n_rt;
    load_rows<DH, DKV_ROWS>(smem + L::Q + buf * DKV_ROWS * DH, q + bh * T * DH, r0, T);
    load_rows<DH, DKV_ROWS>(smem + L::DO + buf * DKV_ROWS * DH, dout + bh * T * DH, r0, T);
    float* st = smem + L::STATS + buf * 3 * DKV_ROWS;
    load_vec<DKV_ROWS>(st, m + bh * T, r0, T);
    load_vec<DKV_ROWS>(st + DKV_ROWS, l + bh * T, r0, T);
    load_vec<DKV_ROWS>(st + 2 * DKV_ROWS, dvec + bh * T, r0, T);
  };
  load_q(0);
  hopper::cp_async_commit();
  if (n_tiles > 1) load_q(1);
  hopper::cp_async_commit();

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + kw + g + 8 * i;

  for (int it = 0; it < n_tiles; ++it) {
    hopper::cp_async_wait_group<1>();
    __syncthreads();
    const int buf = it & 1, r0 = r_start + (it % n_rt) * DKV_ROWS;
    const float* qs = smem + L::Q + buf * DKV_ROWS * DH;
    const float* os = smem + L::DO + buf * DKV_ROWS * DH;
    const float* ms = smem + L::STATS + buf * 3 * DKV_ROWS + rw;
    const float* ls = ms + DKV_ROWS;
    const float* ds = ms + 2 * DKV_ROWS;
    // A warp whose keys are all past S, whose rows are all past T, or whose
    // keys all lie past its rows' diagonal skips the tile.
    const int w_row = r0 + rw;
    if (k0 + kw < S && w_row < T && !(causal && k0 + kw > w_row + 31 + off)) {
      bool ok[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, row = w_row + 8 * n + 2 * t + (e & 1);
          ok[n][e] = row < T && valid_s[kw + g + 8 * i] > 0 && (!causal || key[i] <= row + off);
        }
      // S^T = K Q^T, P^T, dV += P^T dO.
      float p[4][4], x[4][4], cor[4][4];
      product_xyt<DH>(p, cor, smem + L::K, kw + g, qs, rw + g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * n + 2 * t + (e & 1);
          p[n][e] = ok[n][e] ? expf(p[n][e] * scale - ms[rl]) * (1.f / fmaxf(ls[rl], 1e-30f))
                             : 0.f;
        }
      product_ab<DH>(dv, p, os, rw + 2 * t, g);
      // dP^T = V dO^T, dS^T, dK += dS^T Q.
      product_xyt<DH>(x, cor, smem + L::V, kw + g, os, rw + g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * n + 2 * t + (e & 1);
          x[n][e] = ok[n][e] ? p[n][e] * (x[n][e] - ds[rl]) : 0.f;
        }
      product_ab<DH>(dk, x, qs, rw + 2 * t, g);
    }
    __syncthreads();                                   // every warp is done with buf
    if (it + 2 < n_tiles) load_q(it + 2);
    hopper::cp_async_commit();
  }

  // lower + upper warps' sums, in that order: warp w + 4 hands its dk and
  // dv to warp w, lane to lane.
  hopper::cp_async_wait_group<0>();
  __syncthreads();
  constexpr int NT = DH / 8;
  float* red = smem + L::Q + (warp & 3) * NT * 4 * 32 + lane;
  if (rw) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(n * 4 + e) * 32] = dk[n][e];
        red[4 * NT * 4 * 32 + (n * 4 + e) * 32] = dv[n][e];
      }
  }
  __syncthreads();
  if (!rw) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] = (dk[n][e] + red[(n * 4 + e) * 32]) * scale;
        dv[n][e] += red[4 * NT * 4 * 32 + (n * 4 + e) * 32];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= S) continue;
      const size_t base = ((size_t)bkv * S + key[i]) * DH + 8 * t;
#pragma unroll
      for (int c = 0; c < DH / 32; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float4*>(dk_out + base + 32 * c + 4 * h) = out4<DH>(dk, c, i, h);
          *reinterpret_cast<float4*>(dv_out + base + 32 * c + 4 * h) = out4<DH>(dv, c, i, h);
        }
    }
  }
}

// ---- host side ----

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* m,
              const void* l, const void* dvec, const void* kv_valid, void* dq, int B, int H,
              int KV, int T, int S, int causal, float scale, cudaStream_t st) {
  static bool done[MAX_DEVICES];
  const int e = allow_smem(flash_bwd_dq_tf32_kernel<DH>, DqSmem<DH>::TOTAL, done);
  if (e != 0) return e;
  const dim3 grid(B * H, (T + DQ_ROWS - 1) / DQ_ROWS);
  flash_bwd_dq_tf32_kernel<DH><<<grid, THREADS, DqSmem<DH>::TOTAL, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<const int*>(kv_valid), static_cast<float*>(dq), H, KV, T, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* m,
               const void* l, const void* dvec, const void* kv_valid, void* dk, void* dv,
               int B, int H, int KV, int T, int S, int causal, float scale, cudaStream_t st) {
  static bool done[MAX_DEVICES];
  const int e = allow_smem(flash_bwd_dkv_tf32_kernel<DH>, DkvSmem<DH>::TOTAL, done);
  if (e != 0) return e;
  const dim3 grid(B * KV, (S + DKV_KEYS - 1) / DKV_KEYS);
  flash_bwd_dkv_tf32_kernel<DH><<<grid, THREADS, DkvSmem<DH>::TOTAL, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<const int*>(kv_valid), static_cast<float*>(dk), static_cast<float*>(dv), H, KV,
      T, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KV, int T, int S, int Dh) {
  return B < 1 || H < 1 || KV < 1 || H % KV || T < 1 || S < 1 || (Dh != 64 && Dh != 128) ||
         (T + DQ_ROWS - 1) / DQ_ROWS > 65535 || (S + DKV_KEYS - 1) / DKV_KEYS > 65535;
}

}  // namespace

// Plain C entries for ctypes, with the arguments of the bf16 entries of
// flash_attention_bwd.cu and f32 tensors, less the scratch tensor: dk and dv
// [B*KV, S, Dh] f32 come out GQA-summed.  Each returns 0 or the cudaError_t of
// its launch.  T, S >= 1; ceil(T / 128) and ceil(S / 64) at most 65535.
extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* m, const void* l,
                                          const void* dvec, const void* kv_valid, void* dq, int B,
                                          int H, int KV, int T, int S, int Dh, int causal,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh)) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_dq<128>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S,
                                    causal, scale, st)
                   : launch_dq<64>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S,
                                   causal, scale, st);
}

extern "C" int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* m, const void* l,
                                           const void* dvec, const void* kv_valid, void* dk,
                                           void* dv, int B, int H, int KV, int T, int S, int Dh,
                                           int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh)) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_dkv<128>(q, k, v, dout, m, l, dvec, kv_valid, dk, dv, B, H, KV, T, S,
                                     causal, scale, st)
                   : launch_dkv<64>(q, k, v, dout, m, l, dvec, kv_valid, dk, dv, B, H, KV, T, S,
                                    causal, scale, st);
}
