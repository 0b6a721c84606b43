// Causal GQA flash-attention forward in f32 for Hopper (sm_90a), on the
// tensor cores in error-compensated TF32.  The backward kernels of f32 inputs
// are in flash_attention_bwd_f32.cu; both build on flash_f32_tf32.cuh.
//
// Replaces the Pallas TPU kernel of unimoe_audio_tpu/ops/flash_attention.py
// for f32 inputs, which computes in the input dtype (`p.astype(v.dtype)`
// stays f32 there):
//   * flash_fwd_tf32_kernel <- `_flash_kernel` (:30-97, call :454)
// The contract is the bf16 kernel's (flash_attention_fwd.cu) with f32
// everywhere: q [B,H,T,Dh], k/v [B,KV,S,Dh], kv_valid [B,S] int32
// (1 = attendable); query head h reads kv head h / (H/KV); query row i sits
// at key position i + (S - T); masked scores are -1e30.  The forward writes o
// and the residuals m, l [B*H, T] f32 (p = exp(s - m) / l); a row with no
// attendable key outputs 0, m = -1e30, l = 1e30.  S = Q K^T and O += P V run
// in 3xTF32 (flash_f32_tf32.cuh: each product as three TF32 products, about
// 21 bits a product where TF32 alone keeps 11); the mask, the online softmax
// and O's rescale run in f32 on the CUDA cores.
//
// What bounds it on the H100: at the training shape (B 4, H 16, KV 2,
// T = S = 2048, Dh 128, causal) the forward does 69 GFLOP of f32 products:
// 0.42 ms at 495 / 3 = 165 TFLOP/s, the rate of its 3xTF32 products on the
// tensor cores (1.03 ms at the CUDA cores' 67 TFLOP/s, the floor of the FMA
// kernel this one replaced).  mma.sync reaches only part of the TF32 rate,
// and per mma.sync a warp also issues the split's integer and float
// operations and a share of a 128-bit shared-memory read; the mask, the
// exponentials and O's rescale run beside them on the CUDA cores.  At the
// T2M prefill (B 8, T = S = 128) a call moves about 19 MB and does under a
// GFLOP, so bytes and the launch bound it.
//
// Why mma.sync and not wgmma: tf32 wgmma reads B K-major from shared memory
// and cannot transpose 32-bit types, so P V would need V transposed, in hi and
// lo copies (flash_f32_tf32.cuh).
//
// Design (8 warps, 256 threads; one CTA per SM by shared memory at Dh 128 and
// by registers):
//   * one CTA per (128 query rows, b*H + h), the row tile with the most key
//     tiles launched first;
//   * Q is loaded once by cp.async into a swizzled [128][Dh] tile; K, V and
//     kv_valid stream in tiles of 32 keys, double-buffered, so that the next
//     tile's copy is in flight while this one is used (131,328 bytes of
//     shared memory at Dh 128);
//   * a warp owns 16 query rows: S (16 x 32, main and correction
//     accumulators, `product_xyt`), masked (kv_valid, then causal with the
//     S - T offset), then the online softmax in f32: a row's 8 scores of a
//     tile sit in the 4 lanes that share g, so its max and sum take two
//     shuffles; m and l carried, O rescaled by exp(m_old - m_new); then
//     O += P V (`product_ab`, P's C fragments as the A operand), O (16 x Dh)
//     in registers.  P never leaves the registers;
//   * a warp skips a tile wholly above its diagonal, and rows past T;
//   * o = O / max(l, 1e-30), 0 for a dead row, by 128-bit stores; then m and
//     l (1e30 for a dead row).
// Every sum runs in a fixed order (no atomics), so two launches give the same
// bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_f32_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int ROWS = 128;          // query rows of a CTA, 16 a warp
constexpr int KEYS = 32;           // keys of a streamed K / V tile
constexpr float NEG = -1e30f;      // the TPU kernel's mask value

template <int DH>
struct FwdSmem {
  static constexpr int Q = 0;                          // Q [ROWS][DH]
  static constexpr int K = Q + ROWS * DH;              // K [2][KEYS][DH]
  static constexpr int V = K + 2 * KEYS * DH;          // V [2][KEYS][DH]
  static constexpr int VALID = V + 2 * KEYS * DH;      // kv_valid [2][KEYS]
  static constexpr int TOTAL = (VALID + 2 * KEYS) * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ kv_valid,
                      float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                      int H, int KV, int T, int S, int causal, float scale) {
  using L = FwdSmem<DH>;
  extern __shared__ __align__(16) float smem[];
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = b * KV + h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off = S - T;
  const int w0 = q0 + 16 * warp;                       // the warp's first row
  const float* kb = k + (size_t)kvh * S * DH;
  const float* vb = v + (size_t)kvh * S * DH;
  const int* valid = kv_valid + (size_t)b * S;

  int row[2];
  float mrow[2], lrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = w0 + g + 8 * i;
    mrow[i] = NEG;
    lrow[i] = 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Keys past the last row's diagonal are never attended.
  const int s_end = causal ? min(S, q0 + ROWS + off) : S;
  const int n_tiles = s_end > 0 ? (s_end + KEYS - 1) / KEYS : 0;
  auto load_kv = [&](int j) {
    const int buf = j & 1, s0 = j * KEYS;
    load_rows<DH, KEYS>(smem + L::K + buf * KEYS * DH, kb, s0, S);
    load_rows<DH, KEYS>(smem + L::V + buf * KEYS * DH, vb, s0, S);
    load_vec<KEYS>(valid_s + buf * KEYS, valid, s0, S);
  };
  if (n_tiles > 0) {
    load_rows<DH, ROWS>(smem + L::Q, q + (size_t)bh * T * DH, q0, T);
    load_kv(0);
    hopper::cp_async_commit();
    if (n_tiles > 1) load_kv(1);
    hopper::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    hopper::cp_async_wait_group<1>();
    __syncthreads();
    const int buf = j & 1, s0 = j * KEYS;
    const int* vv = valid_s + buf * KEYS;
    // A warp whose rows are all past T, or all above this tile's keys, skips it.
    if (w0 < T && !(causal && s0 > w0 + 15 + off)) {
      float s[4][4], cor[4][4];
      product_xyt<DH>(s, cor, smem + L::Q, 16 * warp + g, smem + L::K + buf * KEYS * DH, g, t);
      // Mask and online softmax, as the TPU kernel: masked scores are -1e30,
      // m and l carried across tiles, O rescaled by exp(m_old - m_new).  Row
      // i's scores are s[n][2 i], s[n][2 i + 1], over the 4 lanes of g.
      bool ok[4][4];
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kl = 8 * n + 2 * t + (e & 1);
          ok[n][e] = vv[kl] > 0 && (!causal || s0 + kl <= row[i] + off);
          s[n][e] = ok[n][e] ? s[n][e] * scale : NEG;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_new[i] = fmaxf(mrow[i], mx[i]);
        alpha[i] = expf(mrow[i] - m_new[i]);
        mrow[i] = m_new[i];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[n][e] = ok[n][e] ? expf(s[n][e] - m_new[i]) : 0.f;
          sum[i] += s[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        lrow[i] = alpha[i] * lrow[i] + sum[i];
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      product_ab<DH>(acc, s, smem + L::V + buf * KEYS * DH, 2 * t, g);
    }
    __syncthreads();                                   // every warp is done with buf
    if (j + 2 < n_tiles) load_kv(j + 2);
    hopper::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T) continue;
    const bool dead = mrow[i] <= 0.5f * NEG;
    const float denom = fmaxf(lrow[i], 1e-30f);
    float* out = o + ((size_t)bh * T + row[i]) * DH + 8 * t;
#pragma unroll
    for (int c = 0; c < DH / 32; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 x = out4<DH>(acc, c, i, hh);
        *reinterpret_cast<float4*>(out + 32 * c + 4 * hh) =
            dead ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : make_float4(x.x / denom, x.y / denom, x.z / denom, x.w / denom);
      }
    if (t == 0) {
      m_out[(size_t)bh * T + row[i]] = mrow[i];
      l_out[(size_t)bh * T + row[i]] = dead ? -NEG : lrow[i];
    }
  }
}

// ---- host side ----

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, const void* kv_valid, void* o,
               void* m, void* l, int B, int H, int KV, int T, int S, int causal, float scale,
               cudaStream_t st) {
  static bool done[MAX_DEVICES];
  const int e = allow_smem(flash_fwd_tf32_kernel<DH>, FwdSmem<DH>::TOTAL, done);
  if (e != 0) return e;
  const dim3 grid(B * H, (T + ROWS - 1) / ROWS);
  flash_fwd_tf32_kernel<DH><<<grid, THREADS, FwdSmem<DH>::TOTAL, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kv_valid), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), H, KV, T, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KV, int T, int S, int Dh) {
  return B < 1 || H < 1 || KV < 1 || H % KV || T < 1 || S < 0 || (Dh != 64 && Dh != 128) ||
         (T + ROWS - 1) / ROWS > 65535 || (S + KEYS - 1) / KEYS > 65535;
}

}  // namespace

// Plain C entry for ctypes, with the arguments of the bf16 entry
// flash_attention_fwd and f32 tensors (q, k, v, o 16-byte aligned).  Returns
// 0 or the cudaError_t of its launch.  T >= 1; ceil(T / 128) and
// ceil(S / 32) at most 65535.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       const void* kv_valid, void* o, void* m, void* l, int B,
                                       int H, int KV, int T, int S, int Dh, int causal,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh)) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_fwd<128>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st)
                   : launch_fwd<64>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
}
