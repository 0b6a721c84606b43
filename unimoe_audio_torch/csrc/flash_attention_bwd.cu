// Causal GQA flash-attention backward for Hopper (sm_90a), bf16 in, f32 math.
//
// Replaces the Pallas TPU kernels of the JAX package's custom VJP
// (unimoe_audio_tpu/ops/flash_attention.py):
//   * flash_bwd_dq_kernel  <- `_flash_bwd_dq_kernel`  (:150-205, call :323-340)
//       dq[i] = scale * sum_j dS[i,j] K[j]
//   * flash_bwd_dkv_kernel <- `_flash_bwd_dkv_kernel` (:208-275, call :348-374)
//       dv[j] = sum_i P[i,j] dO[i],  dk[j] = scale * sum_i dS[i,j] Q[i]
//     per query head, and flash_bwd_gqa_sum_kernel <- the GQA group-sum
//     that the JAX package does outside its kernel (:376-379).
// with P = exp(S*scale - m) / max(l, 1e-30) rebuilt from the forward's
// residuals m, l [B*H, T] f32, dP = dO V^T, D = rowsum(dO * O) [B*H, T] f32
// (computed by the caller, as the JAX package does outside its kernel, :307),
// and dS = P * (dP - D), zero wherever the key is masked (padding, causal,
// keys past S, rows past T).  A dead query row (no attendable key: m = -1e30,
// l = 1e30) therefore gets dq exactly 0 and adds nothing to dk or dv.  P and
// dS are rounded to bf16 before their products, as the TPU kernels do; with
// H / KV > 1 each query head's dk and dv are rounded to bf16 and then summed
// in f32 in head order, as the JAX package rounds them per head before its sum.
// Layouts as the forward: q, dO [B,H,T,Dh], k, v [B,KV,S,Dh] bf16, kv_valid
// [B,S] int32; query head h reads kv head h / (H/KV); query row i sits at key
// position i + (S - T).
//
// What bounds it on the H100: at the training shape (B 4, H 16, KV 2,
// T = S = 2048, Dh 128, causal) dq does 3 and dk/dv 4 products of
// B*H*T^2*Dh/2 MACs (about 103 and 138 GFLOP) on about 70 MB of inputs, so
// the tensor cores bound both (about 0.10 and 0.14 ms at 989 TFLOP/s).  The
// score, P, dP and dS tiles never leave the registers.
//
// Design: both kernels in the shape of the forward (flash_attention_fwd.cu)
// and of FlashAttention-3's backward, without atomics, so that two launches
// on the same inputs give the same bits:
//   * 384 threads, one CTA per SM: two consumer warpgroups and a producer
//     warpgroup whose registers go to the consumers by setmaxnreg (24 / 240).
//     One producer thread issues every TMA load; the tensor maps are 3-d
//     ({Dh, T, B*H} for q and dO, {Dh, S, B*KV} for k and v) in boxes of 64
//     columns, 128-byte swizzled, so a tile past T or S is zero-filled within
//     its head.  Rings of STAGES stages with full / empty mbarriers.
//   * P = 2^(S * scale * log2 e - lse2), lse2 = m log2 e + log2 max(l, 1e-30)
//     per query row; lse2 = +inf for a dead row or a row past T, so its P is
//     exactly 0 without a mask.  Keys are masked per element (by kv_valid and
//     the diagonal) only in tiles that cross a warpgroup's diagonal or hold an
//     invalid key; a warpgroup skips a tile wholly above its diagonal.
//   * dq: one CTA per (128 query rows, b*H + h), the grid launching the row
//     tile with the most key tiles first.  Q and dO are loaded once; K and V
//     stream in tiles of 64 keys.  Each warpgroup owns 64 rows: S = Q K^T and
//     dP = dO V^T by wgmma m64n64k16 from shared memory (K-major A and B),
//     dS in registers, rounded to bf16 into the A fragments of dQ += dS K
//     (wgmma with A from registers, the K tile an N-major B).  dq stays in
//     registers until the epilogue.
//   * dk/dv: one CTA per (128 keys, b*H + h), key tile 0 (the most query
//     tiles) first.  K and V are loaded once; Q and dO stream in tiles of 64
//     query rows, and the producer warpgroup's warps 9-10 write each tile's
//     lse2 and D beside them.  Each warpgroup owns 64 keys and builds the
//     scores transposed: S^T = K Q^T and dP^T = V dO^T (m64n64k16, K-major
//     A and B), P^T and dS^T in registers, then dV += P^T dO and
//     dK += dS^T Q with A from registers and the same Q and dO tiles read as
//     N-major B.  dk and dv stay in registers (64 + 64 floats a thread at
//     Dh 128) and are written once, per query head: with heads in the grid
//     the CTAs fill the card (1,024 at the training shape, against 128 for
//     one CTA per kv head), and flash_bwd_gqa_sum_kernel then sums each kv
//     head's H / KV bf16 partials in head order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "hopper_ptx.cuh"
#include "hopper_tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;       // 2 consumer warpgroups + 1 producer warpgroup
constexpr int CONSUMERS = 256;
// 384 threads start with 168 registers (65,536 / 384); the producer
// warpgroup keeps 24 so that the consumers get 240: 128 x 24 + 256 x 240 =
// 64,512.  A dk/dv consumer holds dk and dv (128 floats at Dh 128) and S^T
// and dP^T (64), which become P^T and dS^T and then their bf16 A fragments.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int DQ_BQ = 128, DQ_BKV = 64;    // dq: query rows per CTA, keys per K/V tile
constexpr int DKV_BK = 128, DKV_BQ = 64;   // dk/dv: keys per CTA, query rows per Q/dO tile
constexpr int STATS_THREADS = DKV_BQ;      // producer threads writing lse2 and D

// lse2 of a query row (see the note above): +inf where P must be 0.
__device__ __forceinline__ float row_lse2(const float* m, const float* l, size_t at, bool live) {
  if (!live) return INFINITY;
  const float mm = m[at];
  return mm <= -5e29f ? INFINITY : mm * LOG2E + log2f(fmaxf(l[at], 1e-30f));
}

// Dh-wide accumulator of a product with A from registers and an N-major B.
template <int DH>
struct DAcc;
template <>
struct DAcc<64> {
  float d[32];
  __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t db) {
    hopper::wgmma_m64n64k16_rs<1>(d, a, db);
  }
};
template <>
struct DAcc<128> {
  float d[64];
  __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint64_t db) {
    hopper::wgmma_m64n128k16_rs<1>(d, a, db);
  }
};

// d[64 x 64] = A[64 x DH] . B[64 x DH]^T, both K-major tiles in boxes of 64
// columns (a_box / b_box bytes apart): k16 steps of 32 bytes in 128-byte
// rows, a new box every 4 steps; the first step overwrites d.
template <int DH>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a, uint32_t a_box, uint32_t b,
                                        uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    hopper::wgmma_m64n64k16<0, 0>(
        d, hopper::sw128_desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
        hopper::sw128_desc(b + (kk / 4) * b_box + (kk % 4) * 32, 16, 1024), kk > 0);
}

// The bf16 A fragments of an m64n64 accumulator's 4 k16 column steps.
__device__ __forceinline__ void pack_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = hopper::pack_bf16x2(x[8 * k + 2 * r], x[8 * k + 2 * r + 1]);
}

// ---- dq ---------------------------------------------------------------------

template <int DH>
struct DqSmem {
  static constexpr int BOXES = DH / 64;
  static constexpr int QBOX = DQ_BQ * 128;      // a 64-column box of the Q or dO tile
  static constexpr int KVBOX = DQ_BKV * 128;    // of a K or V stage
  static constexpr int Q = 0;
  static constexpr int DO = Q + BOXES * QBOX;
  static constexpr int K = DO + BOXES * QBOX;
  static constexpr int V = K + STAGES * BOXES * KVBOX;
  static constexpr int BARS = V + STAGES * BOXES * KVBOX;   // q, full[S], empty[S]
  static constexpr int TOTAL = BARS + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                    bf16* __restrict__ dq, int H, int KV, int T, int S, int causal, float scale) {
  using L = DqSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);   // 1024-byte aligned
  const uint32_t bar_q = base + L::BARS;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };

  const int bh = blockIdx.x;                       // b * H + h
  const int b = bh / H, h = bh % H;
  const int kv_row = b * KV + h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;
  const int q_offset = S - T;
  int n_tiles = (S + DQ_BKV - 1) / DQ_BKV;
  if (causal) {
    const int last = min(q0 + DQ_BQ, T) - 1 + q_offset;
    n_tiles = min(n_tiles, last < 0 ? 0 : last / DQ_BKV + 1);
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 8 || lane != 0) return;
    hopper::mbar_arrive_expect_tx(bar_q, 2 * L::BOXES * L::QBOX);
    for (int x = 0; x < L::BOXES; ++x) {
      hopper::tma_load_3d(base + L::Q + x * L::QBOX, &map_q, bar_q, 64 * x, q0, bh);
      hopper::tma_load_3d(base + L::DO + x * L::QBOX, &map_do, bar_q, 64 * x, q0, bh);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      hopper::mbar_wait(empty(stage), phase ^ 1);
      const uint32_t kd = base + L::K + stage * L::BOXES * L::KVBOX;
      const uint32_t vd = base + L::V + stage * L::BOXES * L::KVBOX;
      hopper::mbar_arrive_expect_tx(full(stage), 2 * L::BOXES * L::KVBOX);
      for (int x = 0; x < L::BOXES; ++x) {
        hopper::tma_load_3d(kd + x * L::KVBOX, &map_k, full(stage), 64 * x, t * DQ_BKV, kv_row);
        hopper::tma_load_3d(vd + x * L::KVBOX, &map_v, full(stage), 64 * x, t * DQ_BKV, kv_row);
      }
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, lw = warp % 4, quad = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * lw + lane / 4;     // this thread's rows: row0 + 8 i
  const int wg_first = q0 + 64 * wg;
  const float sl2 = scale * LOG2E;
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t at = (size_t)bh * T + row;
    lse2[i] = row_lse2(m, l, at, row < T);
    dd[i] = row < T ? dvec[at] : 0.f;
  }
  const int* valid_b = kv_valid + (size_t)b * S;

  DAcc<DH> acc;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc.d[i] = 0.f;

  hopper::mbar_wait(bar_q, 0);
  const uint32_t q_tile = base + L::Q + 64 * wg * 128;     // the warpgroup's 64 rows
  const uint32_t do_tile = base + L::DO + 64 * wg * 128;

  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * DQ_BKV;
    // Key validity of this tile: bit c % 32 of word c / 32 for key k0 + c.
    uint32_t vmask[DQ_BKV / 32];
    bool all_valid = true;
#pragma unroll
    for (int u = 0; u < DQ_BKV / 32; ++u) {
      const int c = k0 + 32 * u + lane;
      vmask[u] = __ballot_sync(0xffffffffu, c < S && valid_b[c] > 0);
      all_valid = all_valid && vmask[u] == 0xffffffffu;
    }
    // Every warpgroup waits for the stage before it releases it, so that no
    // release runs ahead of the ring.
    hopper::mbar_wait(full(stage), phase);
    const bool skip = wg_first >= T || (causal && k0 > wg_first + 63 + q_offset);
    if (!skip) {
      const uint32_t k_tile = base + L::K + stage * L::BOXES * L::KVBOX;
      const uint32_t v_tile = base + L::V + stage * L::BOXES * L::KVBOX;
      float s[32], dp[32];
      hopper::wgmma_fence();
      mma_abt<DH>(s, q_tile, L::QBOX, k_tile, L::KVBOX);      // S = Q K^T
      mma_abt<DH>(dp, do_tile, L::QBOX, v_tile, L::KVBOX);    // dP = dO V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // dS = P (dP - D), masked where the tile holds an invalid key or
      // crosses this warpgroup's diagonal.
      const bool need_mask = !all_valid || (causal && k0 + DQ_BKV - 1 > wg_first + q_offset);
#pragma unroll
      for (int j = 0; j < DQ_BKV / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const float p = hopper::exp2_approx(s[e] * sl2 - lse2[i]);
            float ds = p * (dp[e] - dd[i]);
            if (need_mask) {
              const int col = 8 * j + 2 * quad + c;
              const bool ok = ((vmask[j / 4] >> (col % 32)) & 1u) &&
                              (!causal || k0 + col <= row0 + 8 * i + q_offset);
              ds = ok ? ds : 0.f;
            }
            s[e] = ds;
          }
        }
      }
      uint32_t da[4][4];
      pack_frags(s, da);

      // dQ += dS K: the K tile is the N-major B, k16 steps of 16 key rows
      // (2048 bytes), its 64-column boxes KVBOX bytes apart.
#pragma unroll
      for (int k = 0; k < 4; ++k) hopper::fence_regs(da[k]);
      hopper::fence_regs(acc.d);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc.mma(da[k], hopper::sw128_desc(k_tile + k * 2048, L::KVBOX, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc.d);
#pragma unroll
      for (int k = 0; k < 4; ++k) hopper::fence_regs(da[k]);
    }
    hopper::mbar_arrive(empty(stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  // Epilogue: dq = scale * acc; rows past T are not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    bf16* og = dq + ((size_t)bh * T + row) * DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
          __floats2bfloat162_rn(acc.d[4 * j + 2 * i] * scale, acc.d[4 * j + 2 * i + 1] * scale);
  }
}

// ---- dk / dv ----------------------------------------------------------------

template <int DH>
struct DkvSmem {
  static constexpr int BOXES = DH / 64;
  static constexpr int KBOX = DKV_BK * 128;     // a 64-column box of the K or V tile
  static constexpr int QBOX = DKV_BQ * 128;     // of a Q or dO stage
  static constexpr int K = 0;
  static constexpr int V = K + BOXES * KBOX;
  static constexpr int Q = V + BOXES * KBOX;
  static constexpr int DO = Q + STAGES * BOXES * QBOX;
  static constexpr int STATS = DO + STAGES * BOXES * QBOX;   // per stage: lse2[BQ], D[BQ] f32
  static constexpr int BARS = STATS + STAGES * 2 * DKV_BQ * 4;   // kv, full[S], empty[S]
  static constexpr int TOTAL = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ dvec, const int* __restrict__ kv_valid,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int T, int S,
                     int causal, float scale) {
  using L = DkvSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* stats = reinterpret_cast<float*>(smem_raw + pad + L::STATS);
  const uint32_t bar_kv = base + L::BARS;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + STAGES + s); };

  const int bh = blockIdx.x;                       // b * H + h: dk, dv rows of this head
  const int b = bh / H, h = bh % H;
  const int kv_row = b * KV + h / (H / KV);
  const int k0 = blockIdx.y * DKV_BK;              // key tile 0, with the most query tiles, first
  const int q_offset = S - T;
  // Query i attends key j iff j <= i + q_offset: the first query tile that
  // attends a key of this tile.
  const int qt0 = (causal ? max(0, k0 - q_offset) : 0) / DKV_BQ;
  const int n_tiles = max(0, (T + DKV_BQ - 1) / DKV_BQ - qt0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1 + STATS_THREADS);
      hopper::mbar_init(empty(s), CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    int stage = 0;
    uint32_t phase = 0;
    if (warp == 8) {
      // ---- one thread issues every TMA load ----
      if (lane != 0) return;
      hopper::mbar_arrive_expect_tx(bar_kv, 2 * L::BOXES * L::KBOX);
      for (int x = 0; x < L::BOXES; ++x) {
        hopper::tma_load_3d(base + L::K + x * L::KBOX, &map_k, bar_kv, 64 * x, k0, kv_row);
        hopper::tma_load_3d(base + L::V + x * L::KBOX, &map_v, bar_kv, 64 * x, k0, kv_row);
      }
      for (int t = 0; t < n_tiles; ++t) {
        hopper::mbar_wait(empty(stage), phase ^ 1);
        const uint32_t qd = base + L::Q + stage * L::BOXES * L::QBOX;
        const uint32_t dod = base + L::DO + stage * L::BOXES * L::QBOX;
        const int q0 = (qt0 + t) * DKV_BQ;
        hopper::mbar_arrive_expect_tx(full(stage), 2 * L::BOXES * L::QBOX);
        for (int x = 0; x < L::BOXES; ++x) {
          hopper::tma_load_3d(qd + x * L::QBOX, &map_q, full(stage), 64 * x, q0, bh);
          hopper::tma_load_3d(dod + x * L::QBOX, &map_do, full(stage), 64 * x, q0, bh);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      return;
    }
    if (warp > 8 + STATS_THREADS / 32) return;
    // ---- warps 9-10: lse2 and D of each tile's query rows ----
    const int c = tid - 9 * 32;
    for (int t = 0; t < n_tiles; ++t) {
      hopper::mbar_wait(empty(stage), phase ^ 1);
      const int row = (qt0 + t) * DKV_BQ + c;
      const size_t at = (size_t)bh * T + row;
      stats[stage * 2 * DKV_BQ + c] = row_lse2(m, l, at, row < T);
      stats[stage * 2 * DKV_BQ + DKV_BQ + c] = row < T ? dvec[at] : 0.f;
      hopper::mbar_arrive(full(stage));
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 ----
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, lw = warp % 4, quad = lane % 4;
  const int key0 = k0 + 64 * wg + 16 * lw + lane / 4;     // this thread's keys: key0 + 8 i
  const int wg_key = k0 + 64 * wg;
  const float sl2 = scale * LOG2E;
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    key_ok[i] = key0 + 8 * i < S && kv_valid[(size_t)b * S + key0 + 8 * i] > 0;
  const bool any_bad = __any_sync(0xffffffffu, !(key_ok[0] && key_ok[1]));

  DAcc<DH> adk, adv;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) { adk.d[i] = 0.f; adv.d[i] = 0.f; }

  hopper::mbar_wait(bar_kv, 0);
  const uint32_t k_tile = base + L::K + 64 * wg * 128;     // the warpgroup's 64 keys
  const uint32_t v_tile = base + L::V + 64 * wg * 128;

  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = (qt0 + t) * DKV_BQ;
    hopper::mbar_wait(full(stage), phase);
    const bool skip = wg_key >= S || (causal && wg_key > q0 + DKV_BQ - 1 + q_offset);
    if (!skip) {
      const uint32_t q_tile = base + L::Q + stage * L::BOXES * L::QBOX;
      const uint32_t do_tile = base + L::DO + stage * L::BOXES * L::QBOX;
      const float* st = stats + stage * 2 * DKV_BQ;
      float s[32], dp[32];
      hopper::wgmma_fence();
      mma_abt<DH>(s, k_tile, L::KBOX, q_tile, L::QBOX);      // S^T = K Q^T
      mma_abt<DH>(dp, v_tile, L::KBOX, do_tile, L::QBOX);    // dP^T = V dO^T
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T and dS^T = P^T (dP^T - D) in place, P masked where the
      // warpgroup holds an invalid key or the tile crosses its diagonal;
      // both are rounded to bf16 before either product is issued, so that
      // S^T and dP^T die first (dk, dv, P^T and dP^T at once would spill).
      const bool need_mask = any_bad || (causal && wg_key + 63 > q0 + q_offset);
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j) {
        const float2 lse = *reinterpret_cast<const float2*>(st + 8 * j + 2 * quad);
        const float2 d2 = *reinterpret_cast<const float2*>(st + DKV_BQ + 8 * j + 2 * quad);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            float p = hopper::exp2_approx(s[e] * sl2 - (c ? lse.y : lse.x));
            if (need_mask) {
              const int col = q0 + 8 * j + 2 * quad + c;
              p = key_ok[i] && (!causal || key0 + 8 * i <= col + q_offset) ? p : 0.f;
            }
            s[e] = p;
            dp[e] = p * (dp[e] - (c ? d2.y : d2.x));
          }
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_frags(s, pa);
      pack_frags(dp, da);

      // dV += P^T dO and dK += dS^T Q, the Q and dO tiles as N-major B: k16
      // steps of 16 query rows (2048 bytes), 64-column boxes QBOX bytes apart.
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hopper::fence_regs(pa[k]);
        hopper::fence_regs(da[k]);
      }
      hopper::fence_regs(adv.d);
      hopper::fence_regs(adk.d);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        adv.mma(pa[k], hopper::sw128_desc(do_tile + k * 2048, L::QBOX, 1024));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        adk.mma(da[k], hopper::sw128_desc(q_tile + k * 2048, L::QBOX, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(adk.d);
      hopper::fence_regs(adv.d);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hopper::fence_regs(pa[k]);
        hopper::fence_regs(da[k]);
      }
    }
    hopper::mbar_arrive(empty(stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  // Epilogue: this head's dk = scale * acc and dv; keys past S not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const size_t at = ((size_t)bh * S + key) * DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(adk.d[4 * j + 2 * i] * scale, adk.d[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(adv.d[4 * j + 2 * i], adv.d[4 * j + 2 * i + 1]);
    }
  }
}

// The GQA sum: dk[b*KV + kv] = sum over g < G = H / KV of part[0][b*H + kv*G + g],
// dv the same from part[1], each [S, Dh] slice summed in f32 in the order
// g = 0 .. G-1 and rounded to bf16.  8 elements (16 bytes) a thread.
__global__ void __launch_bounds__(256)
flash_bwd_gqa_sum_kernel(const bf16* __restrict__ part, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int G, size_t n_kv, size_t per_head) {
  const size_t vecs = per_head / 8, per_w = n_kv * vecs;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * per_w;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t w = i / per_w, r = i % per_w, bkv = r / vecs, e = r % vecs;
    const uint4* src = reinterpret_cast<const uint4*>(part) + (w * n_kv + bkv) * G * vecs + e;
    float acc[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[x] = 0.f;
    for (int g = 0; g < G; ++g) {
      const uint4 u = src[(size_t)g * vecs];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 f = __bfloat1622float2(p[x]);
        acc[2 * x] += f.x;
        acc[2 * x + 1] += f.y;
      }
    }
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int x = 0; x < 4; ++x) ow[x] = hopper::pack_bf16x2(acc[2 * x], acc[2 * x + 1]);
    reinterpret_cast<uint4*>(w ? dv : dk)[bkv * vecs + e] = o;
  }
}

// ---- host side ----

struct Maps {
  CUtensorMap q, dout, k, v;
};

// 3-d maps of q and dO ({Dh, T, B*H}, boxes of q_rows) and of k and v
// ({Dh, S, B*KV}, boxes of kv_rows), 64 columns a box.
int encode_maps(Maps* mp, const void* q, const void* k, const void* v, const void* dout, int B,
                int H, int KV, int T, int S, int Dh, uint32_t q_rows, uint32_t kv_rows) {
  memset(mp, 0, sizeof(*mp));
  const uint64_t dq[3] = {(uint64_t)Dh, (uint64_t)T, (uint64_t)B * H};
  const uint64_t dkv[3] = {(uint64_t)Dh, (uint64_t)S, (uint64_t)B * KV};
  const uint32_t bq[3] = {64, q_rows, 1};
  const uint32_t bkv[3] = {64, kv_rows, 1};
  int e = hopper::encode(&mp->q, q, 3, dq, bq);
  if (e == 0) e = hopper::encode(&mp->dout, dout, 3, dq, bq);
  if (e == 0) e = hopper::encode(&mp->k, k, 3, dkv, bkv);
  if (e == 0) e = hopper::encode(&mp->v, v, 3, dkv, bkv);
  return e;
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* m,
              const void* l, const void* dvec, const void* kv_valid, void* dq, int B, int H,
              int KV, int T, int S, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = DqSmem<DH>::TOTAL;
  static hopper::PerDevice configured;
  int e = (int)configured.once([&] {
    return cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (e != 0) return e;
  Maps mp;
  e = encode_maps(&mp, q, k, v, dout, B, H, KV, T, S, DH, DQ_BQ, DQ_BKV);
  if (e != 0) return e;
  const dim3 grid(B * H, (T + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_kernel<DH><<<grid, THREADS, smem, stream>>>(
      mp.q, mp.dout, mp.k, mp.v, static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_valid), static_cast<bf16*>(dq),
      H, KV, T, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* m,
               const void* l, const void* dvec, const void* kv_valid, void* dk, void* dv,
               int B, int H, int KV, int T, int S, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = DkvSmem<DH>::TOTAL;
  static hopper::PerDevice configured;
  int e = (int)configured.once([&] {
    return cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (e != 0) return e;
  Maps mp;
  e = encode_maps(&mp, q, k, v, dout, B, H, KV, T, S, DH, DKV_BQ, DKV_BK);
  if (e != 0) return e;
  const dim3 grid(B * H, (S + DKV_BK - 1) / DKV_BK);
  flash_bwd_dkv_kernel<DH><<<grid, THREADS, smem, stream>>>(
      mp.q, mp.dout, mp.k, mp.v, static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_valid), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KV, T, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KV, int T, int S, int Dh) {
  return B < 1 || H < 1 || KV < 1 || H % KV || T < 1 || S < 1 || (Dh != 64 && Dh != 128) ||
         (T + DQ_BQ - 1) / DQ_BQ > 65535 || (S + DKV_BK - 1) / DKV_BK > 65535;
}

}  // namespace

// Plain C entries for ctypes.  Each returns 0, the cudaError_t of its launch,
// or 10000 + the CUresult of a failed tensor-map encode (hopper::ENCODE_FAILED).
// m, l, dvec are [B*H, T] f32; q, k, v, dout 16-byte aligned; T, S >= 1;
// ceil(T / 128) and ceil(S / 128) at most 65535 (the grids).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* m, const void* l,
                                      const void* dvec, const void* kv_valid, void* dq, int B,
                                      int H, int KV, int T, int S, int Dh, int causal, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh)) return (int)cudaErrorInvalidValue;
  return Dh == 128 ? launch_dq<128>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S, causal,
                                    scale, st)
                   : launch_dq<64>(q, k, v, dout, m, l, dvec, kv_valid, dq, B, H, KV, T, S, causal,
                                   scale, st);
}

// dk, dv: [B*KV, S, Dh] bf16.  part: with H > KV, a [2, B*H, S, Dh] bf16
// scratch tensor for each query head's dk and dv, which a second kernel then
// sums over each kv head's H / KV query heads in head order; unused (may be
// null) when H == KV.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* m, const void* l,
                                       const void* dvec, const void* kv_valid, void* dk, void* dv,
                                       void* part, int B, int H, int KV, int T, int S, int Dh,
                                       int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, KV, T, S, Dh) || (H > KV && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t per_head = (size_t)S * Dh;
  bf16* dk_out = H > KV ? static_cast<bf16*>(part) : static_cast<bf16*>(dk);
  bf16* dv_out =
      H > KV ? static_cast<bf16*>(part) + (size_t)B * H * per_head : static_cast<bf16*>(dv);
  const int e = Dh == 128 ? launch_dkv<128>(q, k, v, dout, m, l, dvec, kv_valid, dk_out, dv_out, B,
                                            H, KV, T, S, causal, scale, st)
                          : launch_dkv<64>(q, k, v, dout, m, l, dvec, kv_valid, dk_out, dv_out, B,
                                           H, KV, T, S, causal, scale, st);
  if (e != 0 || H == KV) return e;
  const size_t n_kv = (size_t)B * KV, work = 2 * n_kv * (per_head / 8);
  const unsigned blocks = (unsigned)std::min<size_t>((work + 255) / 256, 132 * 16);
  flash_bwd_gqa_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const bf16*>(part),
                                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                   H / KV, n_kv, per_head);
  return (int)cudaGetLastError();
}
