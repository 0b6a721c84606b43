// Causal GQA flash-attention backward for Hopper (sm_90a), bf16 in, f32 math.
//
// Two kernels, replacing the Pallas TPU kernels of the JAX package's
// custom VJP (unimoe_audio_tpu/ops/flash_attention.py):
//   * flash_bwd_dq_kernel  <- `_flash_bwd_dq_kernel`  (:150-205, call :323-340)
//       dq[i] = scale * sum_j dS[i,j] K[j]
//   * flash_bwd_dkv_kernel <- `_flash_bwd_dkv_kernel` (:208-275, call :348-374)
//       dv[j] = sum_i P[i,j] dO[i],  dk[j] = scale * sum_i dS[i,j] Q[i]
//     plus the GQA group-sum that the JAX package does outside (:376-379).
// with P = exp(S*scale - m) / max(l, 1e-30) rebuilt from the forward's
// residuals m, l [B*H, T] f32, dP = dO V^T, D = rowsum(dO * O) [B*H, T] f32
// (computed by the caller, as the JAX package does outside its kernel, :307),
// and dS = P * (dP - D), zero wherever the key is masked (padding, causal,
// keys past S, rows past T).  A dead query row (no attendable key: m = -1e30,
// l = 1e30) therefore gets dq exactly 0 and adds nothing to dk or dv.  P and
// dS are rounded to bf16 before their products, as the TPU kernels do.
// Layouts as the forward: q, dO [B,H,T,Dh], k, v [B,KV,S,Dh] bf16, kv_valid
// [B,S] int32; query head h reads kv head h / (H/KV); query row i sits at key
// position i + (S - T).
//
// What bounds it on the H100: at the training shape (B 4, H 16, KV 2,
// T = S = 2048, Dh 128) dq does 3 and dk/dv 4 products of B*H*T^2*Dh/2 MACs
// over the causal half (about 103 and 138 GFLOP) on about 70 MB of inputs, so
// both are bound by the tensor cores (about 0.10 and 0.14 ms at 989 TFLOP/s).
// The score, probability and dS tiles never leave shared memory.
//
// Design (a first, simple version: WMMA, no cp.async/TMA/wgmma):
//   * dq: one CTA per (64-row query tile, b*H + h), 4 warps of 16 rows; a loop
//     over 64-key K/V tiles up to the causal limit; dq accumulates in WMMA
//     register fragments and is written once.
//   * dk/dv: one CTA per (64-key tile, b*KV + kv), 4 warps of 16 keys; a loop
//     over the H/KV query heads of that kv head and, for each, over the query
//     tiles from the causal start to T.  Scores are built transposed (keys x
//     queries) so each warp owns its 16 key rows end to end; dk and dv
//     accumulate in f32 shared memory and the group-sum happens in the CTA,
//     so no [B*H, S, Dh] intermediate and no atomics (deterministic).
//   * every CTA writes all of its output rows, zeros where no query attends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 64;              // keys per tile
constexpr int NWARPS = 4;           // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG = -1e30f;

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ constexpr size_t up128(size_t x) { return (x + 127) / 128 * 128; }

template <int DH>
struct Strides {
  // Row strides (elements), padded against bank conflicts and kept at
  // multiples of 32 bytes per 16 rows, as WMMA requires.
  static constexpr int LDQ = DH + 8;   // bf16 Q / dO / K / V rows
  static constexpr int LDS = 64 + 4;   // f32 score / dP rows (64 columns)
  static constexpr int LDP = 64 + 8;   // bf16 P / dS rows
  static constexpr int LDO = DH + 4;   // f32 accumulator / staging rows
};

// c[16 x 64] = a[16 x DH] * b[64 x DH]^T, all in shared memory (b row-major,
// read as a column-major B operand).
template <int DH>
__device__ __forceinline__ void mm_abt(const bf16* a, const bf16* b, float* c) {
  constexpr int LDQ = Strides<DH>::LDQ, LDS = Strides<DH>::LDS;
  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int d = 0; d < DH; d += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + d, LDQ);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBt fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LDQ + d, LDQ);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(c + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// acc[16 x DH] (f32, shared memory) += a[16 x 64] (bf16) * b[64 x DH] (bf16).
template <int DH>
__device__ __forceinline__ void mm_acc_smem(const bf16* a, const bf16* b, float* acc) {
  constexpr int LDQ = Strides<DH>::LDQ, LDP = Strides<DH>::LDP, LDO = Strides<DH>::LDO;
  FragA fa[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(fa[kk], a + kk * 16, LDP);
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    FragC c;
    wmma::load_matrix_sync(c, acc + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(c, fa[kk], fb, c);
    }
    wmma::store_matrix_sync(acc + j * 16, c, LDO, wmma::mem_row_major);
  }
}

// rows x DH bf16 tile from global (row stride DH) into shared memory (stride
// LDQ); rows at or past n_rows are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n_rows, int tid) {
  constexpr int VEC = 8, VPR = DH / VEC, LDQ = Strides<DH>::LDQ;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = zero;
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

template <int DH>
struct DqLayout {
  using St = Strides<DH>;
  static constexpr size_t Q = 0;
  static constexpr size_t DO = up128(Q + sizeof(bf16) * BQ * St::LDQ);
  static constexpr size_t K = up128(DO + sizeof(bf16) * BQ * St::LDQ);
  static constexpr size_t V = up128(K + sizeof(bf16) * BK * St::LDQ);
  static constexpr size_t SC = up128(V + sizeof(bf16) * BK * St::LDQ);
  static constexpr size_t DP = SC + sizeof(float) * BQ * St::LDS;
  static constexpr size_t DS = up128(DP + sizeof(float) * BQ * St::LDS);
  static constexpr size_t M = up128(DS + sizeof(bf16) * BQ * St::LDP);
  static constexpr size_t LI = M + sizeof(float) * BQ;
  static constexpr size_t DD = LI + sizeof(float) * BQ;
  static constexpr size_t VALID = DD + sizeof(float) * BQ;
  static constexpr size_t TOTAL = up128(VALID + sizeof(int) * BK);
  // The dq staging tile [BQ x LDO] f32 reuses the score and dP tiles.
  static_assert(sizeof(float) * BQ * St::LDO <= DS - SC, "staging does not fit");
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                    bf16* __restrict__ dq, int H, int KV, int T, int S, int causal, float scale) {
  using Lay = DqLayout<DH>;
  using St = Strides<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + Lay::Q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + Lay::DO);
  bf16* sk = reinterpret_cast<bf16*>(smem + Lay::K);
  bf16* sv = reinterpret_cast<bf16*>(smem + Lay::V);
  float* ss = reinterpret_cast<float*>(smem + Lay::SC);
  float* sdp = reinterpret_cast<float*>(smem + Lay::DP);
  bf16* sds = reinterpret_cast<bf16*>(smem + Lay::DS);
  float* sm = reinterpret_cast<float*>(smem + Lay::M);
  float* sli = reinterpret_cast<float*>(smem + Lay::LI);
  float* sd = reinterpret_cast<float*>(smem + Lay::DD);
  int* svalid = reinterpret_cast<int*>(smem + Lay::VALID);

  const int bh = blockIdx.y;             // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_offset = S - T;

  const bf16* kg = k + (size_t)(b * KV + kvh) * S * DH;
  const bf16* vg = v + (size_t)(b * KV + kvh) * S * DH;
  const int* validg = kv_valid + (size_t)b * S;

  load_tile<DH>(sq, q + (size_t)bh * T * DH, q0, T, tid);
  load_tile<DH>(sdo, dout + (size_t)bh * T * DH, q0, T, tid);
  for (int i = tid; i < BQ; i += NTHREADS) {
    const bool live = q0 + i < T;
    const size_t at = (size_t)bh * T + q0 + i;
    sm[i] = live ? m[at] : 0.f;
    sli[i] = live ? 1.f / fmaxf(l[at], 1e-30f) : 0.f;
    sd[i] = live ? dvec[at] : 0.f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, T) - 1 + q_offset;
    n_tiles = min(n_tiles, last_q < 0 ? 0 : last_q / BK + 1);
  }

  FragC acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    load_tile<DH>(sk, kg, k0, S, tid);
    load_tile<DH>(sv, vg, k0, S, tid);
    for (int i = tid; i < BK; i += NTHREADS) svalid[i] = (k0 + i < S) ? (validg[k0 + i] > 0) : 0;
    __syncthreads();

    // This warp's 16 rows: S = Q K^T and dP = dO V^T.
    mm_abt<DH>(sq + warp * 16 * St::LDQ, sk, ss + warp * 16 * St::LDS);
    mm_abt<DH>(sdo + warp * 16 * St::LDQ, sv, sdp + warp * 16 * St::LDS);
    __syncwarp();

    // dS = where(allowed, P * (dP - D), 0), rounded to bf16.
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const bool row_ok = q0 + r < T;
      const int q_abs = q0 + r + q_offset;
      const float m_r = sm[r], li_r = sli[r], d_r = sd[r];
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const bool ok = row_ok && svalid[c] && (!causal || k0 + c <= q_abs);
        float ds = 0.f;
        if (ok) {
          const float p = expf(ss[r * St::LDS + c] * scale - m_r) * li_r;
          ds = p * (sdp[r * St::LDS + c] - d_r);
        }
        sds[r * St::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dq += dS K for this warp's rows (register accumulators).
    {
      FragA fa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(fa[kk], sds + warp * 16 * St::LDP + kk * 16, St::LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          FragB fb;
          wmma::load_matrix_sync(fb, sk + kk * 16 * St::LDQ + j * 16, St::LDQ);
          wmma::mma_sync(acc[j], fa[kk], fb, acc[j]);
        }
      }
    }
    // Every warp must be done with this K/V tile before the next is loaded.
    __syncthreads();
  }

  // Stage scale * dq through shared memory (over the score tiles, free now)
  // and write the live rows as bf16.
  float* stage = ss;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
    for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= scale;
    wmma::store_matrix_sync(stage + warp * 16 * St::LDO + j * 16, acc[j], St::LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    const int tq = q0 + r;
    if (tq >= T) break;
    bf16* dst = dq + ((size_t)bh * T + tq) * DH;
    for (int c = lane; c < DH; c += 32) dst[c] = __float2bfloat16(stage[r * St::LDO + c]);
  }
}

template <int DH>
struct DkvLayout {
  using St = Strides<DH>;
  static constexpr size_t K = 0;
  static constexpr size_t V = up128(K + sizeof(bf16) * BK * St::LDQ);
  static constexpr size_t Q = up128(V + sizeof(bf16) * BK * St::LDQ);
  static constexpr size_t DO = up128(Q + sizeof(bf16) * BQ * St::LDQ);
  static constexpr size_t ST = up128(DO + sizeof(bf16) * BQ * St::LDQ);
  static constexpr size_t DPT = up128(ST + sizeof(float) * BK * St::LDS);
  static constexpr size_t P = up128(DPT + sizeof(float) * BK * St::LDS);
  static constexpr size_t DS = up128(P + sizeof(bf16) * BK * St::LDP);
  static constexpr size_t DK = up128(DS + sizeof(bf16) * BK * St::LDP);
  static constexpr size_t DV = up128(DK + sizeof(float) * BK * St::LDO);
  static constexpr size_t M = up128(DV + sizeof(float) * BK * St::LDO);
  static constexpr size_t LI = M + sizeof(float) * BQ;
  static constexpr size_t DD = LI + sizeof(float) * BQ;
  static constexpr size_t VALID = DD + sizeof(float) * BQ;
  static constexpr size_t TOTAL = up128(VALID + sizeof(int) * BK);
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int T, int S,
                     int causal, float scale) {
  using Lay = DkvLayout<DH>;
  using St = Strides<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem + Lay::K);
  bf16* sv = reinterpret_cast<bf16*>(smem + Lay::V);
  bf16* sq = reinterpret_cast<bf16*>(smem + Lay::Q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + Lay::DO);
  float* sst = reinterpret_cast<float*>(smem + Lay::ST);
  float* sdpt = reinterpret_cast<float*>(smem + Lay::DPT);
  bf16* sp = reinterpret_cast<bf16*>(smem + Lay::P);
  bf16* sds = reinterpret_cast<bf16*>(smem + Lay::DS);
  float* sdk = reinterpret_cast<float*>(smem + Lay::DK);
  float* sdv = reinterpret_cast<float*>(smem + Lay::DV);
  float* sm = reinterpret_cast<float*>(smem + Lay::M);
  float* sli = reinterpret_cast<float*>(smem + Lay::LI);
  float* sd = reinterpret_cast<float*>(smem + Lay::DD);
  int* svalid = reinterpret_cast<int*>(smem + Lay::VALID);

  const int bkv = blockIdx.y;            // b * KV + kv head
  const int b = bkv / KV;
  const int kvh = bkv % KV;
  const int groups = H / KV;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_offset = S - T;

  load_tile<DH>(sk, k + (size_t)bkv * S * DH, k0, S, tid);
  load_tile<DH>(sv, v + (size_t)bkv * S * DH, k0, S, tid);
  for (int i = tid; i < BK; i += NTHREADS)
    svalid[i] = (k0 + i < S) ? (kv_valid[(size_t)b * S + k0 + i] > 0) : 0;
  for (int i = tid; i < BK * DH; i += NTHREADS) {
    sdk[(i / DH) * St::LDO + i % DH] = 0.f;
    sdv[(i / DH) * St::LDO + i % DH] = 0.f;
  }
  // First query tile that can attend a key of this tile (query i sees key j
  // iff j <= i + q_offset).
  const int first_q = causal ? max(0, k0 - q_offset) : 0;
  const int qt0 = first_q / BQ;
  const int n_qt = (T + BQ - 1) / BQ;
  __syncthreads();

  for (int hh = 0; hh < groups; ++hh) {
    const int bh = b * H + kvh * groups + hh;
    const bf16* qg = q + (size_t)bh * T * DH;
    const bf16* dog = dout + (size_t)bh * T * DH;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      load_tile<DH>(sq, qg, q0, T, tid);
      load_tile<DH>(sdo, dog, q0, T, tid);
      for (int i = tid; i < BQ; i += NTHREADS) {
        const bool live = q0 + i < T;
        const size_t at = (size_t)bh * T + q0 + i;
        sm[i] = live ? m[at] : 0.f;
        sli[i] = live ? 1.f / fmaxf(l[at], 1e-30f) : 0.f;
        sd[i] = live ? dvec[at] : 0.f;
      }
      __syncthreads();

      // This warp's 16 keys: S^T = K Q^T and dP^T = V dO^T.
      mm_abt<DH>(sk + warp * 16 * St::LDQ, sq, sst + warp * 16 * St::LDS);
      mm_abt<DH>(sv + warp * 16 * St::LDQ, sdo, sdpt + warp * 16 * St::LDS);
      __syncwarp();

      for (int i = 0; i < 16; ++i) {
        const int r = warp * 16 + i;
        const bool key_ok = svalid[r] != 0;
        const int key = k0 + r;
#pragma unroll
        for (int u = 0; u < BQ / 32; ++u) {
          const int c = lane + 32 * u;
          const bool ok = key_ok && q0 + c < T && (!causal || key <= q0 + c + q_offset);
          float p = 0.f, ds = 0.f;
          if (ok) {
            p = expf(sst[r * St::LDS + c] * scale - sm[c]) * sli[c];
            ds = p * (sdpt[r * St::LDS + c] - sd[c]);
          }
          sp[r * St::LDP + c] = __float2bfloat16(p);
          sds[r * St::LDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      // dv += P^T dO and dk += dS^T Q for this warp's keys.
      mm_acc_smem<DH>(sp + warp * 16 * St::LDP, sdo, sdv + warp * 16 * St::LDO);
      mm_acc_smem<DH>(sds + warp * 16 * St::LDP, sq, sdk + warp * 16 * St::LDO);
      // Every warp must be done with this Q/dO tile before the next is loaded.
      __syncthreads();
    }
  }

  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    const int key = k0 + r;
    if (key >= S) break;
    const size_t at = ((size_t)bkv * S + key) * DH;
    for (int c = lane; c < DH; c += 32) {
      dk[at + c] = __float2bfloat16(sdk[r * St::LDO + c] * scale);
      dv[at + c] = __float2bfloat16(sdv[r * St::LDO + c]);
    }
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* m, const void* l, const void* dvec, const void* kv_valid,
                      void* dq, int B, int H, int KV, int T, int S, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = DqLayout<DH>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_valid), static_cast<bf16*>(dq),
      H, KV, T, S, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* m, const void* l, const void* dvec, const void* kv_valid,
                       void* dk, void* dv, int B, int H, int KV, int T, int S, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = DkvLayout<DH>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, B * KV);
  flash_bwd_dkv_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_valid), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KV, T, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes.  Each returns the cudaError_t of its launch
// (0 = ok).  m, l, dvec are [B*H, T] f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* m, const void* l,
                                      const void* dvec, const void* kv_valid, void* dq, int B,
                                      int H, int KV, int T, int S, int Dh, int causal, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return (int)launch_dq<128>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S, causal, scale, st);
  if (Dh == 64)
    return (int)launch_dq<64>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* m, const void* l,
                                       const void* dvec, const void* kv_valid, void* dk, void* dv,
                                       int B, int H, int KV, int T, int S, int Dh, int causal,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return (int)launch_dkv<128>(q, k, v, dout, m, l, dvec, kv_valid, dk, dv, B, H, KV, T, S, causal, scale, st);
  if (Dh == 64)
    return (int)launch_dkv<64>(q, k, v, dout, m, l, dvec, kv_valid, dk, dv, B, H, KV, T, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
