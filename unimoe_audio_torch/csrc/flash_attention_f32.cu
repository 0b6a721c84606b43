// Causal GQA flash-attention forward in f32 for Hopper (sm_90a), in true f32
// on the CUDA cores.  The backward kernels of f32 inputs, on the tensor cores
// in error-compensated TF32, are in flash_attention_bwd_f32.cu.
//
// Replaces the Pallas TPU kernel of unimoe_audio_tpu/ops/flash_attention.py
// for f32 inputs, which computes in the input dtype (`p.astype(v.dtype)`
// stays f32 there):
//   * flash_fwd_f32_kernel <- `_flash_kernel` (:30-97, call :454)
// The contract is the bf16 kernel's (flash_attention_fwd.cu) with f32
// everywhere: q [B,H,T,Dh], k/v [B,KV,S,Dh], kv_valid [B,S] int32
// (1 = attendable); query head h reads kv head h / (H/KV); query row i sits
// at key position i + (S - T); masked scores are -1e30.  The forward writes o
// and the residuals m, l [B*H, T] f32 (p = exp(s - m) / l); a row with no
// attendable key outputs 0, m = -1e30, l = 1e30.  No product is rounded below
// f32: every product is an FMA on the CUDA cores.
//
// What bounds it on the H100: the CUDA cores' f32 rate (67 TFLOP/s).  At the
// training shape (B 4, H 16, T = S = 2048, Dh 128, causal) the forward does
// 69 GFLOP (about 1 ms at that rate); at the T2M prefill (B 8, T = S = 128) a
// call moves a few MB and does under a GFLOP, so bytes and the launch bound
// it.  Shared memory bandwidth bounds this simple kernel before the FMA rate
// does: each inner step loads 8 operands from shared memory for 16 FMAs.
//
// Design, simple tiles (128 threads, no tensor cores, no asynchronous copies):
//   * a thread is (ty, tx) = (tid / 8, tid % 8); it owns query rows
//     ty + 16 i and keys (or output columns) tx + 8 j, so the 8 threads of a
//     row sit in one warp and reduce a row's max and sum by shuffles;
//   * operand tiles are stored transposed in shared memory ([Dh][rows + 1],
//     the padding keeps the transposing stores and the reads free of bank
//     conflicts), so that the threads of a warp read consecutive words or
//     one broadcast word;
//   * one CTA per (64 query rows, b*H + h), the tile with the most key tiles
//     launched first; key tiles of 32; the scores of a tile in registers
//     (4 x 4 a thread), the online softmax in f32, P through shared memory
//     (over the K tile's space) into O += P V, O in registers (4 rows x
//     Dh / 8 columns a thread).
// Every sum runs in a fixed order, so two launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;       // 16 row groups (ty) x 8 lanes (tx)
constexpr int BQ = 64;             // query rows of a CTA
constexpr int BK = 32;             // keys of a tile
constexpr int QP = BQ + 1;         // padded row of a [Dh][BQ] transposed tile
constexpr int KP = BK + 1;         // padded row of a [Dh][BK] transposed tile
constexpr float NEG = -1e30f;      // the TPU kernel's mask value
constexpr int MAX_DEVICES = 64;

// Rows [r0, r0 + R) of a row-major [n, DH] matrix into t[d * (R + 1) + r];
// rows past n are zero.
template <int DH, int R>
__device__ __forceinline__ void load_transposed(float* t, const float* __restrict__ src, int r0,
                                                int n) {
  for (int e = threadIdx.x; e < R * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    t[d * (R + 1) + r] = r0 + r < n ? src[(size_t)(r0 + r) * DH + d] : 0.f;
  }
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// ---- forward ----

template <int DH>
struct FwdSmem {
  static constexpr int Q = 0;                  // Q^T [DH][QP]
  static constexpr int K = Q + DH * QP;        // K^T [DH][KP]; then P^T [BK][QP]
  static constexpr int V = K + DH * KP;        // V [BK][DH]
  static constexpr int VALID = V + BK * DH;    // kv_valid of the tile [BK]
  static constexpr int TOTAL = (VALID + BK) * 4;
  static_assert(DH * KP >= BK * QP, "P^T must fit in the K tile's space");
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kv_valid,
                     float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int KV, int T, int S, int causal, float scale) {
  constexpr int NJ = DH / 8;                   // output columns a thread
  using L = FwdSmem<DH>;
  extern __shared__ float smem[];
  float* qt = smem + L::Q;
  float* kt = smem + L::K;
  float* pt = smem + L::K;
  float* vs = smem + L::V;
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = b * KV + h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int off = S - T;
  const float* kb = k + (size_t)kvh * S * DH;
  const float* vb = v + (size_t)kvh * S * DH;
  const int* valid = kv_valid + (size_t)b * S;

  load_transposed<DH, BQ>(qt, q + (size_t)bh * T * DH, q0, T);
  float acc[4][NJ], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG;
    lrow[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = 0.f;
  }
  // Keys past the last row's diagonal are never attended.
  const int s_end = causal ? min(S, q0 + BQ + off) : S;
  for (int s0 = 0; s0 < s_end; s0 += BK) {
    __syncthreads();                           // the last tile's readers are done
    load_transposed<DH, BK>(kt, kb, s0, S);
    for (int e = tid; e < BK * DH; e += THREADS)
      vs[e] = s0 + e / DH < S ? vb[(size_t)s0 * DH + e] : 0.f;
    if (tid < BK) valid_s[tid] = s0 + tid < S ? valid[s0 + tid] : 0;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[d * QP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * KP + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask and online softmax, as the TPU kernel: masked scores are -1e30,
    // m and l carried across tiles, O rescaled by exp(m_old - m_new).
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = s0 + tx + 8 * j;
        ok[j] = valid_s[tx + 8 * j] > 0 && (!causal || key <= row + off);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(mrow[i], row_max(mx));
      const float alpha = expf(mrow[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
      lrow[i] = alpha * lrow[i] + row_sum(sum);
      mrow[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();                           // every thread has read K^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pt[(tx + 8 * j) * QP + ty + 16 * i] = p[i][j];
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pt[kk * QP + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) {
        const float vv = vs[kk * DH + tx + 8 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const bool dead = mrow[i] <= 0.5f * NEG;
    const float denom = fmaxf(lrow[i], 1e-30f);
    float* orow = o + ((size_t)bh * T + row) * DH;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) orow[tx + 8 * jd] = dead ? 0.f : acc[i][jd] / denom;
    if (tx == 0) {
      m_out[(size_t)bh * T + row] = mrow[i];
      l_out[(size_t)bh * T + row] = dead ? -NEG : lrow[i];
    }
  }
}

// ---- host side ----

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

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, const void* kv_valid, void* o,
               void* m, void* l, int B, int H, int KV, int T, int S, int causal, float scale,
               cudaStream_t st) {
  static bool done[MAX_DEVICES];
  const int e = allow_smem(flash_fwd_f32_kernel<DH>, FwdSmem<DH>::TOTAL, done);
  if (e != 0) return e;
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_fwd_f32_kernel<DH><<<grid, THREADS, FwdSmem<DH>::TOTAL, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kv_valid), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), H, KV, T, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KV, int T, int S, int Dh) {
  return B < 1 || H < 1 || KV < 1 || H % KV || T < 1 || S < 0 || (Dh != 64 && Dh != 128) ||
         (T + BQ - 1) / BQ > 65535 || (S + BK - 1) / BK > 65535;
}

}  // namespace

// Plain C entry for ctypes, with the arguments of the bf16 entry
// flash_attention_fwd and f32 tensors.  Returns 0 or the cudaError_t of its
// launch.  T >= 1; ceil(T / 64) and ceil(S / 32) at most 65535 (the grids).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       const void* kv_valid, void* o, void* m, void* l, int B,
                                       int H, int KV, int T, int S, int Dh, int causal,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh)) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_fwd<128>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st)
                   : launch_fwd<64>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
}
