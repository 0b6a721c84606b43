// Causal GQA flash attention in f32 for Hopper (sm_90a): the forward, dq, and
// dk / dv with their GQA sum, in true f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernels of unimoe_audio_tpu/ops/flash_attention.py
// for f32 inputs, which compute in the input dtype (`p.astype(v.dtype)` stays
// f32 there):
//   * flash_fwd_f32_kernel     <- `_flash_kernel`         (:30-97, call :454)
//   * flash_bwd_dq_f32_kernel  <- `_flash_bwd_dq_kernel`  (:150-205, call :323)
//   * flash_bwd_dkv_f32_kernel <- `_flash_bwd_dkv_kernel` (:208-275, call :348)
//     and flash_bwd_gqa_sum_f32_kernel <- the GQA sum (:376-379).
// The contract is the bf16 kernels' (flash_attention_fwd.cu,
// flash_attention_bwd.cu) with f32 everywhere: q [B,H,T,Dh], k/v [B,KV,S,Dh],
// kv_valid [B,S] int32 (1 = attendable); query head h reads kv head
// h / (H/KV); query row i sits at key position i + (S - T); masked scores are
// -1e30.  The forward writes o and the residuals m, l [B*H, T] f32
// (p = exp(s - m) / l); a row with no attendable key outputs 0, m = -1e30,
// l = 1e30.  The backward rebuilds P = exp(s - m) / max(l, 1e-30) where the
// key is attendable (0 elsewhere), dP = dO V^T, dS = P (dP - D) with
// D = rowsum(dO * O) from the caller; dq = scale dS K, dv = P^T dO,
// dk = scale dS^T Q, each query head's dk and dv summed over its kv head's
// H / KV query heads in head order.  No product is rounded below f32: the
// tensor cores' TF32 would keep 10 mantissa bits, so every product is an FMA
// on the CUDA cores.
//
// What bounds it on the H100: the CUDA cores' f32 rate (67 TFLOP/s).  At the
// training shape (B 4, H 16, T = S = 2048, Dh 128, causal) the forward does
// 69 GFLOP (about 1 ms at that rate), dq 103 and dk/dv 138; at the T2M
// prefill (B 8, T = S = 128) a call moves a few MB and does under a GFLOP,
// so bytes and the launch bound it.  Shared memory bandwidth bounds these
// simple kernels before the FMA rate does: each inner step loads 8 operands
// from shared memory for 16 FMAs.
//
// Design, simple tiles (128 threads, no tensor cores, no asynchronous copies):
//   * a thread is (ty, tx) = (tid / 8, tid % 8); it owns query rows
//     ty + 16 i and keys (or output columns) tx + 8 j, so the 8 threads of a
//     row sit in one warp and reduce a row's max and sum by shuffles;
//   * operand tiles are stored transposed in shared memory ([Dh][rows + 1],
//     the padding keeps the transposing stores and the reads free of bank
//     conflicts), so that the threads of a warp read consecutive words or
//     one broadcast word;
//   * forward: one CTA per (64 query rows, b*H + h), the tile with the most
//     key tiles launched first; key tiles of 32; the scores of a tile in
//     registers (4 x 4 a thread), the online softmax in f32, P through
//     shared memory (over the K tile's space) into O += P V, O in registers
//     (4 rows x Dh / 8 columns a thread);
//   * dq: one CTA per (64 query rows, b*H + h), Q and dO loaded once, K and V
//     in tiles of 32 keys; S and dP in registers, dS through shared memory
//     into dq += dS K;
//   * dk / dv: one CTA per (32 keys, b*H + h): K and V loaded once, Q and dO
//     in tiles of 64 rows starting at the first tile that can see the keys;
//     S^T and dP^T in registers, P^T and then dS^T through one shared buffer
//     into dv += P^T dO and dk += dS^T Q; each query head's dk and dv are
//     written to a [2, B*H, S, Dh] scratch tensor (or straight out when
//     H == KV) and flash_bwd_gqa_sum_f32_kernel sums them per kv head.
// Every sum runs in a fixed order, so two launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;       // 16 row groups (ty) x 8 lanes (tx)
constexpr int BQ = 64;             // query rows: a CTA's (fwd, dq) or a tile's (dk/dv)
constexpr int BK = 32;             // keys: a tile's (fwd, dq) or a CTA's (dk/dv)
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

// ---- backward: dq ----

template <int DH>
struct DqSmem {
  static constexpr int Q = 0;                  // Q^T [DH][QP]
  static constexpr int DO = Q + DH * QP;       // dO^T [DH][QP]
  static constexpr int K = DO + DH * QP;       // K^T [DH][KP]
  static constexpr int V = K + DH * KP;        // V^T [DH][KP]
  static constexpr int DS = V + DH * KP;       // dS^T [BK][QP]
  static constexpr int VALID = DS + BK * QP;   // [BK]
  static constexpr int TOTAL = (VALID + BK) * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ m, const float* __restrict__ l,
                        const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                        float* __restrict__ dq, int H, int KV, int T, int S, int causal,
                        float scale) {
  constexpr int NJ = DH / 8;
  using L = DqSmem<DH>;
  extern __shared__ float smem[];
  float* qt = smem + L::Q;
  float* dot = smem + L::DO;
  float* kt = smem + L::K;
  float* vt = smem + L::V;
  float* dst = smem + L::DS;
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
  load_transposed<DH, BQ>(dot, dout + (size_t)bh * T * DH, q0, T);
  float mr[4], linv[4], dr[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = (size_t)bh * T + min(row, T - 1);
    mr[i] = m[at];
    linv[i] = 1.f / fmaxf(l[at], 1e-30f);
    dr[i] = dvec[at];
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = 0.f;
  }
  const int s_end = causal ? min(S, q0 + BQ + off) : S;
  for (int s0 = 0; s0 < s_end; s0 += BK) {
    __syncthreads();
    load_transposed<DH, BK>(kt, kb, s0, S);
    load_transposed<DH, BK>(vt, vb, s0, S);
    if (tid < BK) valid_s[tid] = s0 + tid < S ? valid[s0 + tid] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qt[d * QP + ty + 16 * i];
        ov[i] = dot[d * QP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = kt[d * KP + tx + 8 * j];
        vv[j] = vt[d * KP + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = s0 + tx + 8 * j;
        const bool ok = row < T && valid_s[tx + 8 * j] > 0 && (!causal || key <= row + off);
        const float pij = ok ? expf(s[i][j] * scale - mr[i]) * linv[i] : 0.f;
        dst[(tx + 8 * j) * QP + ty + 16 * i] = ok ? pij * (dp[i][j] - dr[i]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dst[kk * QP + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) {
        const float kv = kt[(tx + 8 * jd) * KP + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(dsv[i], kv, acc[i][jd]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    float* out = dq + ((size_t)bh * T + row) * DH;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) out[tx + 8 * jd] = acc[i][jd] * scale;
  }
}

// ---- backward: dk, dv ----

template <int DH>
struct DkvSmem {
  static constexpr int K = 0;                  // K^T [DH][KP]
  static constexpr int V = K + DH * KP;        // V^T [DH][KP]
  static constexpr int Q = V + DH * KP;        // Q^T [DH][QP]
  static constexpr int DO = Q + DH * QP;       // dO^T [DH][QP]
  static constexpr int PS = DO + DH * QP;      // P^T, then dS^T, as [BQ][KP]
  static constexpr int M = PS + BQ * KP;       // m, 1 / l, D of the tile's rows [BQ] each
  static constexpr int LINV = M + BQ;
  static constexpr int D = LINV + BQ;
  static constexpr int VALID = D + BQ;         // kv_valid of the CTA's keys [BK]
  static constexpr int TOTAL = (VALID + BK) * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                         float* __restrict__ dk_out, float* __restrict__ dv_out, int H, int KV,
                         int T, int S, int causal, float scale) {
  constexpr int NJ = DH / 8;
  using L = DkvSmem<DH>;
  extern __shared__ float smem[];
  float* kt = smem + L::K;
  float* vt = smem + L::V;
  float* qt = smem + L::Q;
  float* dot = smem + L::DO;
  float* ps = smem + L::PS;
  float* m_s = smem + L::M;
  float* linv_s = smem + L::LINV;
  float* d_s = smem + L::D;
  int* valid_s = reinterpret_cast<int*>(smem + L::VALID);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = b * KV + h / (H / KV);
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int off = S - T;
  const float* qb = q + (size_t)bh * T * DH;
  const float* ob = dout + (size_t)bh * T * DH;

  load_transposed<DH, BK>(kt, k + (size_t)kvh * S * DH, k0, S);
  load_transposed<DH, BK>(vt, v + (size_t)kvh * S * DH, k0, S);
  if (tid < BK) valid_s[tid] = k0 + tid < S ? kv_valid[(size_t)b * S + k0 + tid] : 0;
  float dk[2][NJ], dv[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) dk[i][jd] = dv[i][jd] = 0.f;

  // The first query row that can see key k0 sits at k0 - (S - T).
  const int r_lo = causal ? max(0, k0 - off) : 0;
  for (int r0 = (r_lo / BQ) * BQ; r0 < T; r0 += BQ) {
    __syncthreads();
    load_transposed<DH, BQ>(qt, qb, r0, T);
    load_transposed<DH, BQ>(dot, ob, r0, T);
    if (tid < BQ) {
      const int row = r0 + tid;
      const size_t at = (size_t)bh * T + min(row, T - 1);
      m_s[tid] = m[at];
      linv_s[tid] = 1.f / fmaxf(l[at], 1e-30f);
      d_s[tid] = dvec[at];
    }
    __syncthreads();

    // S^T and dP^T: keys ty + 16 i, query rows tx + 8 j.
    float st[2][8], dpt[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float kv[2], vv[2], qv[8], ov[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kv[i] = kt[d * KP + ty + 16 * i];
        vv[i] = vt[d * KP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = qt[d * QP + tx + 8 * j];
        ov[j] = dot[d * QP + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }
    // P^T, and dS^T kept in st.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tx + 8 * j, row = r0 + r;
        const bool ok = row < T && valid_s[ty + 16 * i] > 0 && (!causal || key <= row + off);
        const float pij = ok ? expf(st[i][j] * scale - m_s[r]) * linv_s[r] : 0.f;
        ps[r * KP + ty + 16 * i] = pij;
        st[i][j] = ok ? pij * (dpt[i][j] - d_s[r]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int rr = 0; rr < BQ; ++rr) {
      float pv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) pv[i] = ps[rr * KP + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) {
        const float ov = dot[(tx + 8 * jd) * QP + rr];
#pragma unroll
        for (int i = 0; i < 2; ++i) dv[i][jd] = fmaf(pv[i], ov, dv[i][jd]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ps[(tx + 8 * j) * KP + ty + 16 * i] = st[i][j];
    __syncthreads();
#pragma unroll 2
    for (int rr = 0; rr < BQ; ++rr) {
      float dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = ps[rr * KP + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) {
        const float qv = qt[(tx + 8 * jd) * QP + rr];
#pragma unroll
        for (int i = 0; i < 2; ++i) dk[i][jd] = fmaf(dsv[i], qv, dk[i][jd]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    const size_t at = ((size_t)bh * S + key) * DH;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      dk_out[at + tx + 8 * jd] = dk[i][jd] * scale;
      dv_out[at + tx + 8 * jd] = dv[i][jd];
    }
  }
}

// The GQA sum: dk[b*KV + kv] = sum over g < G = H / KV of part[0][b*H + kv*G + g],
// dv the same from part[1], each [S, Dh] slice summed in f32 in the order
// g = 0 .. G-1.
__global__ void __launch_bounds__(256)
flash_bwd_gqa_sum_f32_kernel(const float* __restrict__ part, float* __restrict__ dk,
                             float* __restrict__ dv, int G, size_t n_kv, size_t per_head) {
  const size_t per_w = n_kv * per_head;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * per_w;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t w = i / per_w, r = i % per_w, bkv = r / per_head, e = r % per_head;
    const float* src = part + (w * n_kv + bkv) * G * per_head + e;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += src[(size_t)g * per_head];
    (w ? dv : dk)[bkv * per_head + e] = acc;
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

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* m,
              const void* l, const void* dvec, const void* kv_valid, void* dq, int B, int H,
              int KV, int T, int S, int causal, float scale, cudaStream_t st) {
  static bool done[MAX_DEVICES];
  const int e = allow_smem(flash_bwd_dq_f32_kernel<DH>, DqSmem<DH>::TOTAL, done);
  if (e != 0) return e;
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_bwd_dq_f32_kernel<DH><<<grid, THREADS, DqSmem<DH>::TOTAL, st>>>(
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
  const int e = allow_smem(flash_bwd_dkv_f32_kernel<DH>, DkvSmem<DH>::TOTAL, done);
  if (e != 0) return e;
  const dim3 grid(B * H, (S + BK - 1) / BK);
  flash_bwd_dkv_f32_kernel<DH><<<grid, THREADS, DkvSmem<DH>::TOTAL, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dvec),
      static_cast<const int*>(kv_valid), static_cast<float*>(dk), static_cast<float*>(dv), H, KV,
      T, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KV, int T, int S, int Dh) {
  return B < 1 || H < 1 || KV < 1 || H % KV || T < 1 || S < 0 || (Dh != 64 && Dh != 128) ||
         (T + BQ - 1) / BQ > 65535 || (S + BK - 1) / BK > 65535;
}

}  // namespace

// Plain C entries for ctypes, with the arguments of the bf16 entries
// (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv) and
// f32 tensors.  Each returns 0 or the cudaError_t of its launch.  T >= 1;
// ceil(T / 64) and ceil(S / 32) at most 65535 (the grids).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       const void* kv_valid, void* o, void* m, void* l, int B,
                                       int H, int KV, int T, int S, int Dh, int causal,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh)) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_fwd<128>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st)
                   : launch_fwd<64>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
}

extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* m, const void* l,
                                          const void* dvec, const void* kv_valid, void* dq, int B,
                                          int H, int KV, int T, int S, int Dh, int causal,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh) || S < 1) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_dq<128>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S,
                                    causal, scale, st)
                   : launch_dq<64>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S,
                                   causal, scale, st);
}

// dk, dv: [B*KV, S, Dh] f32.  part: with H > KV, a [2, B*H, S, Dh] f32 scratch
// tensor for each query head's dk and dv, which a second kernel then sums over
// each kv head's H / KV query heads in head order; unused (may be null) when
// H == KV.
extern "C" int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* m, const void* l,
                                           const void* dvec, const void* kv_valid, void* dk,
                                           void* dv, void* part, int B, int H, int KV, int T,
                                           int S, int Dh, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh) || S < 1 || (H > KV && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t per_head = (size_t)S * Dh;
  float* dk_out = H > KV ? static_cast<float*>(part) : static_cast<float*>(dk);
  float* dv_out =
      H > KV ? static_cast<float*>(part) + (size_t)B * H * per_head : static_cast<float*>(dv);
  const int e = Dh == 128 ? launch_dkv<128>(q, k, v, dout, m, l, dvec, kv_valid, dk_out, dv_out,
                                            B, H, KV, T, S, causal, scale, st)
                          : launch_dkv<64>(q, k, v, dout, m, l, dvec, kv_valid, dk_out, dv_out, B,
                                           H, KV, T, S, causal, scale, st);
  if (e != 0 || H == KV) return e;
  const size_t n_kv = (size_t)B * KV, work = 2 * n_kv * per_head;
  const unsigned blocks = (unsigned)std::min<size_t>((work + 255) / 256, 132 * 16);
  flash_bwd_gqa_sum_f32_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                                       static_cast<float*>(dk),
                                                       static_cast<float*>(dv), H / KV, n_kv,
                                                       per_head);
  return (int)cudaGetLastError();
}
