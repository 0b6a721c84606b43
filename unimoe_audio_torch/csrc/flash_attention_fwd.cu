// Causal GQA flash-attention forward for Hopper (sm_90a), bf16 in, f32 math.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (unimoe_audio_tpu/ops/flash_attention.py:30-97, launched by
// `_flash_forward` :454-482).  Same contract:
//   q [B,H,T,Dh], k/v [B,KV,S,Dh] bf16, kv_valid [B,S] int32 (1 = attendable);
//   query head h reads kv head h / (H/KV); query row i sits at absolute key
//   position i + (S - T) (rectangular causal mask); masked scores are -1e30;
//   a row with no attendable key outputs 0 (m stays -1e30, l is set to 1e30).
//   Outputs: o [B,H,T,Dh] bf16 and the softmax stats m, l [B*H, T] f32
//   (p = exp(s - m) / l), the residuals a fused backward needs.
//
// What bounds it on the H100: at the prefill shapes (B = 2 * requests, H = 16,
// KV = 2, T = S ~ 128-256, Dh = 128) the whole call moves a few MB and does
// well under a GFLOP, so it is bound by memory traffic and launch latency,
// not by the tensor cores.  The design keeps the [T, S] score matrix out of
// device memory entirely (each score tile lives in shared memory only) and
// reads each Q tile once and each K/V tile once per CTA.
//
// Design (not a block-by-block copy of the TPU kernel):
//   * one CTA per (64-row query tile, b*H + h); 4 warps, each owning 16 rows;
//   * a loop inside the CTA over 64-key K/V tiles up to the causal limit
//     replaces the TPU grid's sequential third axis (tiles wholly above the
//     diagonal are never loaded);
//   * Q, K, V, the score tile, the bf16 probability tile and the f32 output
//     accumulator all sit in shared memory; QK^T and PV run on the tensor
//     cores through WMMA 16x16x16 bf16 fragments with f32 accumulation;
//   * the online softmax (running max m, denominator l, rescale factor) is
//     done per row by one warp with shuffles; P is rounded to bf16 before the
//     PV product, as the TPU kernel does;
//   * ragged T / S edges are masked in the kernel (zero-filled tiles, keys
//     past S invalid, rows past T not stored): no host-side padding.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;              // query rows per CTA
constexpr int BK = 64;              // keys per tile
constexpr int NWARPS = BQ / 16;     // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG = -1e30f;       // the TPU kernel's mask value

__host__ __device__ constexpr size_t up128(size_t x) { return (x + 127) / 128 * 128; }

template <int DH>
struct Layout {
  // Row strides (elements), padded against shared-memory bank conflicts and
  // kept at multiples of 32 bytes per 16 rows, as WMMA requires.
  static constexpr int LDQ = DH + 8;   // bf16 Q / K / V rows
  static constexpr int LDS = BK + 4;   // f32 score rows
  static constexpr int LDP = BK + 8;   // bf16 probability rows
  static constexpr int LDO = DH + 4;   // f32 output-accumulator rows
  static constexpr size_t Q = 0;
  static constexpr size_t K = up128(Q + sizeof(__nv_bfloat16) * BQ * LDQ);
  static constexpr size_t V = up128(K + sizeof(__nv_bfloat16) * BK * LDQ);
  static constexpr size_t SC = up128(V + sizeof(__nv_bfloat16) * BK * LDQ);
  static constexpr size_t P = up128(SC + sizeof(float) * BQ * LDS);
  static constexpr size_t O = up128(P + sizeof(__nv_bfloat16) * BQ * LDP);
  static constexpr size_t M = up128(O + sizeof(float) * BQ * LDO);
  static constexpr size_t L = M + sizeof(float) * BQ;
  static constexpr size_t A = L + sizeof(float) * BQ;
  static constexpr size_t VALID = A + sizeof(float) * BQ;
  static constexpr size_t TOTAL = up128(VALID + sizeof(int) * BK);
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_valid,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int KV, int T, int S, int causal,
                 float scale) {
  using Lay = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Q);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + Lay::K);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + Lay::V);
  float* ss = reinterpret_cast<float*>(smem + Lay::SC);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  float* so = reinterpret_cast<float*>(smem + Lay::O);
  float* sm = reinterpret_cast<float*>(smem + Lay::M);
  float* sl = reinterpret_cast<float*>(smem + Lay::L);
  float* sa = reinterpret_cast<float*>(smem + Lay::A);
  int* svalid = reinterpret_cast<int*>(smem + Lay::VALID);

  const int bh = blockIdx.y;             // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);          // GQA: query head -> kv head
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_offset = S - T;

  const __nv_bfloat16* qg = q + (size_t)bh * T * DH;
  const __nv_bfloat16* kg = k + (size_t)(b * KV + kvh) * S * DH;
  const __nv_bfloat16* vg = v + (size_t)(b * KV + kvh) * S * DH;
  const int* validg = kv_valid + (size_t)b * S;

  constexpr int VEC = 8;                 // bf16 per 16-byte load
  constexpr int VPR = DH / VEC;          // 16-byte vectors per row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Q tile (rows past T zero-filled), output accumulator and row stats.
  for (int i = tid; i < BQ * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = zero;
    if (q0 + r < T) val = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * DH + c);
    *reinterpret_cast<uint4*>(sq + r * Lay::LDQ + c) = val;
  }
  for (int i = tid; i < BQ * DH; i += NTHREADS) so[(i / DH) * Lay::LDO + i % DH] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    sm[i] = NEG;
    sl[i] = 0.f;
  }

  // K/V tiles up to the causal limit of this CTA's last live query row.
  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, T) - 1 + q_offset;
    n_tiles = min(n_tiles, last_q < 0 ? 0 : last_q / BK + 1);
  }
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int i = tid; i < BK * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * VEC;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kg + (size_t)(k0 + r) * DH + c);
        vv = *reinterpret_cast<const uint4*>(vg + (size_t)(k0 + r) * DH + c);
      }
      *reinterpret_cast<uint4*>(sk + r * Lay::LDQ + c) = kv;
      *reinterpret_cast<uint4*>(sv + r * Lay::LDQ + c) = vv;
    }
    for (int i = tid; i < BK; i += NTHREADS)
      svalid[i] = (k0 + i < S) ? (validg[k0 + i] > 0) : 0;
    __syncthreads();

    // Scores for this warp's 16 rows: S = Q K^T (K read as a col-major B).
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int d = 0; d < DH; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sq + warp * 16 * Lay::LDQ + d, Lay::LDQ);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sk + j * 16 * Lay::LDQ + d, Lay::LDQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(ss + warp * 16 * Lay::LDS + j * 16, acc[j], Lay::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time across the warp's 32 lanes.
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const int q_abs = q0 + r + q_offset;
      float s_loc[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const bool ok = svalid[c] && (!causal || k0 + c <= q_abs);
        s_loc[u] = ok ? ss[r * Lay::LDS + c] * scale : NEG;
        mx = fmaxf(mx, s_loc[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(s_loc[u] - m_new);
        sum += p;
        sp[r * Lay::LDP + lane + 32 * u] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[r] = alpha * sl[r] + sum;
        sm[r] = m_new;
        sa[r] = alpha;
      }
    }
    __syncwarp();

    // Rescale this warp's accumulator rows by alpha, then O += P V.
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const float alpha = sa[r];
      for (int c = lane; c < DH; c += 32) so[r * Lay::LDO + c] *= alpha;
    }
    __syncwarp();
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(fp[kk], sp + warp * 16 * Lay::LDP + kk * 16, Lay::LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* optr = so + warp * 16 * Lay::LDO + j * 16;
        wmma::load_matrix_sync(acc, optr, Lay::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sv + kk * 16 * Lay::LDQ + j * 16, Lay::LDQ);
          wmma::mma_sync(acc, fp[kk], fb, acc);
        }
        wmma::store_matrix_sync(optr, acc, Lay::LDO, wmma::mem_row_major);
      }
    }
    // Every warp must be done with this K/V tile before the next is loaded.
    __syncthreads();
  }

  // Finalize: o = acc / l, dead rows (m never left -1e30) output 0, l = 1e30.
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    const int tq = q0 + r;
    if (tq >= T) break;
    const float m_r = sm[r];
    const float l_r = sl[r];
    const bool dead = m_r <= NEG * 0.5f;
    const float denom = fmaxf(l_r, 1e-30f);
    __nv_bfloat16* og = o + ((size_t)bh * T + tq) * DH;
    for (int c = lane; c < DH; c += 32)
      og[c] = __float2bfloat16(dead ? 0.f : so[r * Lay::LDO + c] / denom);
    if (lane == 0) {
      m_out[(size_t)bh * T + tq] = m_r;
      l_out[(size_t)bh * T + tq] = dead ? -NEG : l_r;
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_valid, void* o,
                   void* m, void* l, int B, int H, int KV, int T, int S, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<DH>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_valid),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(m), static_cast<float*>(l), H, KV, T,
      S, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_valid, void* o, void* m, void* l, int B, int H,
                                   int KV, int T, int S, int Dh, int causal, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return (int)launch<128>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
  if (Dh == 64) return (int)launch<64>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
