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
// What bounds it on the H100: at the training shape (B 4, H 16, T = S = 2048,
// Dh 128, causal) a call does 69 GFLOP on about 40 MB, so the tensor cores
// bound it (0.07 ms at 989 TFLOP/s); at the T2M prefill (B 8, T = S = 128) it
// moves a few MB and does under a GFLOP, so bytes and the launch bound it.
// The [T, S] scores never leave the SM: each score tile lives in registers.
//
// Design, a first Hopper kernel in the shape of FlashAttention-3 (without its
// pingpong scheduling or the overlap of softmax with the products):
//   * one CTA per (128 query rows, b * H + h): two consumer warpgroups of 64
//     rows and one producer warpgroup (384 threads, one CTA per SM; setmaxnreg
//     moves the producer's registers to the consumers).  The grid is
//     (B * H, query tiles), the tile with the most K/V tiles launched first;
//   * the producer loads the Q tile once by TMA, then K and V tiles of BKV =
//     128 keys into a ring of 2 stages (separate full barriers for K and V,
//     one empty barrier released by both warpgroups).  The tensor maps are
//     3-d ({Dh, T, B*H} for q, {Dh, S, B*KV} for k and v) in boxes of 64
//     columns, 128-byte swizzled: a tile past T or S is zero-filled within
//     its head and never reads the next head's rows.  Causal tiles wholly
//     above the diagonal are never loaded;
//   * S = Q K^T by wgmma m64n128k16 from shared memory, Q a K-major A and the
//     K tile a K-major B (Dh is contiguous in both), into registers;
//   * scale (in log2 units), mask and online softmax on the accumulator
//     fragment: a thread holds 2 rows, and a row's max and sum run over the 4
//     lanes that share it.  Only tiles that hold an invalid key or cross the
//     diagonal mask per element, by kv_valid (a 128-bit ballot per tile) and
//     by the fragment's row and column;
//   * P is rounded to bf16 in registers, as the TPU kernel does, and feeds
//     O += P V from registers (wgmma with a register A fragment; V is the
//     N-major B).  O stays in registers and is rescaled there;
//   * epilogue o = acc / l from registers, dead rows 0, rows past T not
//     stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_ptx.cuh"
#include "hopper_tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;            // query rows per CTA: two consumer warpgroups of 64
constexpr int BKV = 128;           // keys per K/V tile
constexpr int STAGES = 2;          // K/V ring
constexpr int THREADS = 384;       // 2 consumer warpgroups + 1 producer warpgroup
constexpr int CONSUMERS = 256;
// 384 threads start with 168 registers each (65,536 / 384, rounded down to
// 8); the producer warpgroup gives 144 of its own back so that the
// consumers, with two 64-float accumulators, get 240: 128 x 24 + 256 x 240
// = 64,512.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float NEG = -1e30f;      // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: the Q tile, then K[stage] and V[stage], each DH / 64 boxes
// of [rows x 64] bf16 (128-byte rows), then the barriers.
template <int DH>
struct Smem {
  static constexpr int BOXES = DH / 64;
  static constexpr int QBOX = BQ * 128;
  static constexpr int KVBOX = BKV * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + BOXES * QBOX;
  static constexpr int V = K + STAGES * BOXES * KVBOX;
  static constexpr int BARS = V + STAGES * BOXES * KVBOX;   // q, kfull[S], vfull[S], empty[S]
  static constexpr int TOTAL = BARS + 8 * (1 + 3 * STAGES) + 1024;   // + alignment slack
};

template <int DH>
struct OAcc;
template <>
struct OAcc<64> {
  float d[32];
  __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t db) {
    hopper::wgmma_m64n64k16_rs<1>(d, a, db);
  }
};
template <>
struct OAcc<128> {
  float d[64];
  __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t db) {
    hopper::wgmma_m64n128k16_rs<1>(d, a, db);
  }
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const int* __restrict__ kv_valid,
                 bf16* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int KV, int T, int S, int causal, float scale_log2) {
  using L = Smem<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* sm = smem_raw + ((1024 - (raw & 1023)) & 1023);   // 1024-byte aligned
  const uint32_t base = hopper::smem_u32(sm);
  const uint32_t bar_q = base + L::BARS;
  auto k_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;                       // b * H + h
  const int b = bh / H, h = bh % H;
  const int kv_row = b * KV + h / (H / KV);        // GQA: query head -> kv head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_offset = S - T;
  int n_tiles = (S + BKV - 1) / BKV;
  if (causal) {
    const int last = min(q0 + BQ, T) - 1 + q_offset;
    n_tiles = min(n_tiles, last < 0 ? 0 : last / BKV + 1);
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 8 || lane != 0) return;
    hopper::mbar_arrive_expect_tx(bar_q, L::BOXES * L::QBOX);
    for (int x = 0; x < L::BOXES; ++x)
      hopper::tma_load_3d(base + L::Q + x * L::QBOX, &map_q, bar_q, 64 * x, q0, bh);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      hopper::mbar_wait(empty(stage), phase ^ 1);
      const uint32_t kd = base + L::K + stage * L::BOXES * L::KVBOX;
      const uint32_t vd = base + L::V + stage * L::BOXES * L::KVBOX;
      hopper::mbar_arrive_expect_tx(k_full(stage), L::BOXES * L::KVBOX);
      for (int x = 0; x < L::BOXES; ++x)
        hopper::tma_load_3d(kd + x * L::KVBOX, &map_k, k_full(stage), 64 * x, t * BKV, kv_row);
      hopper::mbar_arrive_expect_tx(v_full(stage), L::BOXES * L::KVBOX);
      for (int x = 0; x < L::BOXES; ++x)
        hopper::tma_load_3d(vd + x * L::KVBOX, &map_v, v_full(stage), 64 * x, t * BKV, kv_row);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns query rows q0 + 64 wg .. + 63 ----
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, lw = warp % 4, quad = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * lw + lane / 4;      // this thread's rows: row0 + 8 i
  const int wg_first = q0 + 64 * wg + q_offset;            // the warpgroup's first key position
  const int* valid_b = kv_valid + (size_t)b * S;

  OAcc<DH> acc;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc.d[i] = 0.f;
  float m_run[2] = {NEG, NEG};     // running max of the row, in log2 units
  float l_run[2] = {0.f, 0.f};     // this thread's share of the row's sum

  hopper::mbar_wait(bar_q, 0);
  const uint32_t q_tile = base + L::Q + 64 * wg * 128;     // the warpgroup's 64 rows

  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    // Key validity of this tile: bit c % 32 of word c / 32 for key k0 + c.
    uint32_t vmask[BKV / 32];
    bool all_valid = true;
#pragma unroll
    for (int u = 0; u < BKV / 32; ++u) {
      const int c = k0 + 32 * u + lane;
      vmask[u] = __ballot_sync(0xffffffffu, c < S && valid_b[c] > 0);
      all_valid = all_valid && vmask[u] == 0xffffffffu;
    }

    // S = Q K^T: both K-major, k16 steps of 32 bytes in 128-byte rows, a new
    // box every 4 steps.
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    const uint32_t k_tile = base + L::K + stage * L::BOXES * L::KVBOX;
    hopper::mbar_wait(k_full(stage), phase);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t da = hopper::sw128_desc(q_tile + (kk / 4) * L::QBOX + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::sw128_desc(k_tile + (kk / 4) * L::KVBOX + (kk % 4) * 32, 16, 1024);
      hopper::wgmma_m64n128k16<0, 0>(s, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);

    // Scale to log2 units; mask where the tile holds an invalid key or
    // crosses this warpgroup's diagonal.
    const bool need_mask = !all_valid || (causal && k0 + BKV - 1 > wg_first);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale_log2;
          if (need_mask) {
            const int col = 8 * j + 2 * quad + c;
            const bool ok = ((vmask[j / 4] >> (col % 32)) & 1u) &&
                            (!causal || k0 + col <= row0 + 8 * i + q_offset);
            x = ok ? x : NEG;
          }
          s[4 * j + 2 * i + c] = x;
        }
      }
    }

    // Online softmax on the fragment; P = 2^(x - m), rounded to bf16 into
    // the A fragments of P V.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      alpha[i] = hopper::exp2_approx(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = hopper::exp2_approx(s[4 * j + 2 * i + c] - m_new);
          s[4 * j + 2 * i + c] = p;
          sum += p;
        }
      }
      l_run[i] = alpha[i] * l_run[i] + sum;
    }
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[k][r] = hopper::pack_bf16x2(s[8 * k + 2 * r], s[8 * k + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc.d[4 * j + 2 * i] *= alpha[i];
        acc.d[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += P V: V N-major, k16 steps of 16 key rows (2048 bytes), 64-column
    // boxes KVBOX bytes apart.
    const uint32_t v_tile = base + L::V + stage * L::BOXES * L::KVBOX;
    hopper::mbar_wait(v_full(stage), phase);
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k) hopper::fence_regs(pa[k]);
    hopper::fence_regs(acc.d);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k)
      acc.mma(pa[k], hopper::sw128_desc(v_tile + k * 2048, L::KVBOX, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc.d);
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k) hopper::fence_regs(pa[k]);
    hopper::mbar_arrive(empty(stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  // Epilogue: o = acc / l; a dead row (m never left -1e30) outputs 0, l = 1e30.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    const bool dead = m_run[i] <= NEG * 0.5f;
    const float inv = dead ? 0.f : 1.f / fmaxf(l, 1e-30f);
    bf16* og = o + ((size_t)bh * T + row) * DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
          __floats2bfloat162_rn(acc.d[4 * j + 2 * i] * inv, acc.d[4 * j + 2 * i + 1] * inv);
    if (quad == 0) {
      m_out[(size_t)bh * T + row] = dead ? NEG : m_run[i] * LN2;
      l_out[(size_t)bh * T + row] = dead ? -NEG : l;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* o, void* m,
           void* l, int B, int H, int KV, int T, int S, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = Smem<DH>::TOTAL;
  static hopper::PerDevice configured;
  const cudaError_t set = configured.once([&] {
    return cudaFuncSetAttribute(flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  });
  if (set != cudaSuccess) return (int)set;
  CUtensorMap mq, mk, mv;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  const uint64_t dq[3] = {(uint64_t)DH, (uint64_t)T, (uint64_t)B * H};
  const uint32_t bq[3] = {64, BQ, 1};
  int e = hopper::encode(&mq, q, 3, dq, bq);
  if (e == 0 && S > 0) {                 // S = 0: no K/V tile is loaded, every row is dead
    const uint64_t dkv[3] = {(uint64_t)DH, (uint64_t)S, (uint64_t)B * KV};
    const uint32_t bkv[3] = {64, BKV, 1};
    e = hopper::encode(&mk, k, 3, dkv, bkv);
    if (e == 0) e = hopper::encode(&mv, v, 3, dkv, bkv);
  }
  if (e != 0) return e;
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<const int*>(kv_valid), static_cast<bf16*>(o),
      static_cast<float*>(m), static_cast<float*>(l), H, KV, T, S, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  Returns 0, the cudaError_t of the launch, or
// 10000 + the CUresult of a failed tensor-map encode (hopper::ENCODE_FAILED).
// q, k, v 16-byte aligned; B * H below 2^31 and ceil(T / 128) at most 65535
// (the grid); T >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_valid, void* o, void* m, void* l, int B, int H,
                                   int KV, int T, int S, int Dh, int causal, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || KV < 1 || H % KV || T < 1 || S < 0 || (T + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (Dh == 128) return launch<128>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
  if (Dh == 64) return launch<64>(q, k, v, kv_valid, o, m, l, B, H, KV, T, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
