// The two-pass flash-attention backward shared by K4, K8 and K9
// (flash_cross_bwd.cu) and K12 (lane_pad_probe.cu): pass 1 (dkdv) walks a
// block of KV rows over every q tile, pass 2 (dq) a block of q rows over
// every KV tile, so each gradient stays in registers and is written once.
// bf16 runs on Hopper: wgmma products, TMA loads into an mbarrier ring, a
// producer warp and two consumer warpgroups (below); fp32 on the CUDA
// cores. The design and its bound are set out in flash_cross_bwd.cu.
//
// PROBE (K12, bf16 only): the recipe's transcendentals replaced by casts, as
// the TPU tool tools/lane_pad_probe.py replaces them (its `probe_kernel`):
// p = bf16(s * c1) and ds = bf16(dp * c1), with no lb and no delta; the five
// products, their fp32 accumulation and the two passes are the backward's.
// Rows past Nq or Nk load as zeros, so they add nothing, as in the recipe.
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace cs {

// fp32: 128 threads, two per row of a 64-row block, 64-row tiles
constexpr int BWD_THREADS = 128;
constexpr int BKV = 64;
constexpr int BQT = 64;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lb;     // (B, H, Nq)
  const float* delta;  // (B, H, Nq)
  void* dq;
  void* dk;
  void* dv;
  // batch, head and row strides in elements: the inputs q, do, k and v (K4:
  // token-major rows, head stride hd; K8/K9: any head-major layout with hd
  // contiguous) and the outputs dq and dk/dv (token-major (B, N, H*hd) for all)
  long long q_bs, q_hs, q_rs;
  long long do_bs, do_hs, do_rs;
  long long k_bs, k_hs, k_rs;
  long long v_bs, v_hs, v_rs;
  long long dq_bs, dq_hs, dq_rs;
  long long dkv_bs, dkv_hs, dkv_rs;
  int h, nq, nk;
  float scale;  // 1/sqrt(hd)
  float c1;     // scale * log2(e)
};

// lb and delta of q rows [q0, q0 + BQT) into shared memory; rows past Nq get
// lb = +inf (so p = 0) and delta = 0.
__device__ __forceinline__ void load_stats(float* s_lb, float* s_dl, const BwdArgs& a, long long st,
                                           int q0, int tid) {
  if (tid < BQT) {
    const int r = q0 + tid;
    s_lb[tid] = r < a.nq ? a.lb[st + r] : INFINITY;
    s_dl[tid] = r < a.nq ? a.delta[st + r] : 0.f;
  }
}

// ---- bf16: wgmma, TMA, warp specialisation ---------------------------------
//
// A block is three warpgroups: warpgroup 0 the producer (one warp issues
// every TMA load and, in pass 1, copies lb and delta; setmaxnreg hands its
// registers to the consumers), warpgroups 1 and 2 the consumers, each
// owning 64 of the block's 128 resident rows (KV rows in pass 1, q rows in
// pass 2). The resident tiles arrive once; the streamed tiles go through a
// ring of STAGES buffers, each with a `full` mbarrier (the TMA bytes, in
// pass 1 also the producer warp's stores of lb and delta) and an `empty`
// one (one arrival per consumer warp once the products that read the
// buffer are done).
//
// Per streamed tile a consumer issues its two score products (s and dp,
// both operands in shared memory) and behind them the previous tile's
// gradient products (its p and ds from registers), waits for s alone and
// takes the exponentials while the tensor cores run the rest, waits for dp
// and forms ds, then waits for the previous tile's products, releases that
// tile's buffer and packs this tile's p and ds to bf16. Every product is
// done by the end of its iteration: one left in flight across the loop's
// back edge makes ptxas serialise every wgmma of the kernel (C7515).
//
// Registers: ptxas allocates the consumers' code up to the setmaxnreg
// ceiling (240), not the launch bound (168), only if the kernel has no trap
// instruction (with one it capped them at 168 and spilled). The block's
// shape, the ring and the product helpers are shared with the forward
// (tma.cuh, wgmma.cuh).
constexpr int STAGES = 4;

// The tile plan of head dim HD. Shared rows are hd padded to CB 64-column
// SW128 blocks (the padding read as zeros from TMA, and never by a product:
// the hd contractions stop at hd, and the hd-wide gradient products are
// m64n{HD}). Pass 1 keeps s^T and dp^T (BQ/2 fp32 registers each), dk and dv
// (HD/2 each) and the previous tile's p and ds packed to bf16 (BQ/4 each)
// live at once: BQ = 64 costs 96 + HD registers a thread, which fits the
// consumers' 240 up to HD 80 with room for the addresses; HD 96-128 take
// BQ = 32 (48 + HD). Pass 2 holds s, dp (BK/2 each), dq (HD/2) and ds
// (BK/4): BK = 128 (160 + HD/2) up to HD 64, BK = 64 above. Four stages
// (on the H100 more were no faster, two clearly slower): at most 64 KB of
// ring in pass 1 and 128 KB in pass 2, beside the 32-64 KB of resident
// rows; the block runs alone on its SM, held there by its registers.
template <int HD>
struct BwdTiles {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  static constexpr int CB = (HD + 63) / 64;
  static constexpr int ROWS = 128;  // resident rows a block: 64 per consumer warpgroup
  static constexpr int BQ = HD <= 80 ? 64 : 32;
  static constexpr int BK = HD <= 64 ? 128 : 64;
  static constexpr uint32_t RES = CB * ROWS * 128;  // bytes of a resident operand
  static constexpr uint32_t QT = CB * BQ * 128;  // of a streamed q or do tile (pass 1)
  static constexpr uint32_t KT = CB * BK * 128;  // of a streamed K or V tile (pass 2)
  static constexpr uint32_t p1_st = 2 * RES + STAGES * 2 * QT;
  static constexpr uint32_t p1_bar = p1_st + STAGES * 2 * BQ * 4;
  static constexpr uint32_t p1_bytes = p1_bar + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
  static constexpr uint32_t p2_bar = 2 * RES + STAGES * 2 * KT;
  static constexpr uint32_t p2_bytes = p2_bar + (1 + 2 * STAGES) * 8 + 1024;
};

// The two consumer warpgroups run the same loop over the same tiles; started
// together they stay in step, both on the tensor cores and then both on
// the exponentials. Warpgroup 1 therefore starts once warpgroup 0 has its
// first scores, and the two stay about half an iteration apart (named
// barrier 1, once per block; on the H100 this sped up the dq pass and left
// the dk/dv pass as it was).
__device__ __forceinline__ void start_after_warpgroup_0() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
__device__ __forceinline__ void release_warpgroup_1() { asm volatile("bar.arrive 1, 256;\n" ::: "memory"); }

// a consumer's 64 x HD fp32 tile to rows [r0, r0 + 64) of a token-major
// bf16 output (row stride rs), rows at or past n skipped
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long rs, const float (&acc)[HD / 2], int r0,
                                           int n) {
  const int lane = threadIdx.x & 31, r = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  out += 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (r + 8 * hh >= n) continue;
    __nv_bfloat16* row = out + (long long)(r + 8 * hh) * rs;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// Pass 1, bf16: dk and dv of 128 KV rows (K and V resident), walking over
// the q tiles (q, do, lb and delta streamed).
template <int HD, bool PROBE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                        const BwdArgs a) {
  using T = BwdTiles<HD>;
  constexpr int BQ = T::BQ, S = STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + T::RES;
  unsigned char* sQD = smem + 2 * T::RES;                  // stage s: q at 2s*QT, do at (2s+1)*QT
  float* sST = reinterpret_cast<float*>(smem + T::p1_st);  // stage s: lb at 2s*BQ, delta at (2s+1)*BQ
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + T::p1_bar);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int kv0 = blockIdx.x * T::ROWS, head = blockIdx.y, b = blockIdx.z;
  const int ntiles = (a.nq + BQ - 1) / BQ;
  init_ring(bar, S, 33);  // full: the TMA bytes, then the producer warp's 32 lanes with the stats

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(&bar[0], 2 * T::RES);
      tma_rows<T::CB>(sK, &mk, &bar[0], T::ROWS, kv0, head, b);
      tma_rows<T::CB>(sV, &mv, &bar[0], T::ROWS, kv0, head, b);
    }
    // lb and delta of a tile's rows, BQ / 32 a lane, loaded one tile ahead
    // (in flight while the producer waits for a free stage); rows past Nq:
    // lb = +inf (so p = 0) and delta = 0
    const long long st = ((long long)b * a.h + head) * a.nq;
    float lbv[BQ / 32], dlv[BQ / 32];
    auto fetch = [&](int t) {
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        const int r = t * BQ + lane + 32 * j;
        lbv[j] = r < a.nq ? a.lb[st + r] : INFINITY;
        dlv[j] = r < a.nq ? a.delta[st + r] : 0.f;
      }
    };
    if constexpr (!PROBE) fetch(0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(&bar[1 + S + s], (t / S - 1) & 1);
      if (lane == 0) {
        unsigned char* q = sQD + s * 2 * T::QT;
        mbar_expect_tx(&bar[1 + s], 2 * T::QT);
        tma_rows<T::CB>(q, &mq, &bar[1 + s], BQ, t * BQ, head, b);
        tma_rows<T::CB>(q + T::QT, &mdo, &bar[1 + s], BQ, t * BQ, head, b);
      }
      if constexpr (!PROBE) {
        float* st_s = sST + s * 2 * BQ;
#pragma unroll
        for (int j = 0; j < BQ / 32; ++j) {
          st_s[lane + 32 * j] = lbv[j];
          st_s[BQ + lane + 32 * j] = dlv[j];
        }
        if (t + 1 < ntiles) fetch(t + 1);
      }
      mbar_arrive(&bar[1 + s]);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, qd = lane & 3;
  const uint32_t k_base = smem_addr(sK) + cw * 64 * 128, v_base = smem_addr(sV) + cw * 64 * 128;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&bar[0], 0);
  if (cw == 1 && ntiles > 0) start_after_warpgroup_0();

  // p^T and ds^T of the previous tile, packed: its dv and dk products are
  // issued behind this tile's score products, and all four are done by the
  // end of the iteration (a product left in flight across the loop's back
  // edge makes ptxas serialise every wgmma of the kernel)
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  uint32_t prev_q = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    mbar_wait(&bar[1 + s], (t / S) & 1);
    const uint32_t q_base = smem_addr(sQD) + s * 2 * T::QT, do_base = q_base + T::QT;
    // s^T = K q^T and dp^T = V do^T: this warpgroup's 64 KV rows x BQ q columns
    float sc[BQ / 2], dp[BQ / 2];
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    score_product<HD, BQ>(sc, k_base, T::ROWS, q_base, BQ);
    wgmma_commit();
    score_product<HD, BQ>(dp, v_base, T::ROWS, do_base, BQ);
    wgmma_commit();
    if (t > 0) {
      grad_product<HD, BQ>(dv, pa, prev_q + T::QT, BQ);  // dv += p^T do
      grad_product<HD, BQ>(dk, dsa, prev_q, BQ);         // dk += ds^T q
    }
    wgmma_commit();
    wgmma_wait<2>();  // s^T
    fence_regs(sc);
    if (cw == 0 && t == 0) release_warpgroup_1();

    // p^T in place of s^T, fp32 until ds is formed
    const float* st_s = sST + s * 2 * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      if constexpr (PROBE) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * j + e] *= a.c1;
      } else {
        const float2 lb = *reinterpret_cast<const float2*>(st_s + 8 * j + 2 * qd);
        sc[4 * j] = ex2(fmaf(sc[4 * j], a.c1, -lb.x));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], a.c1, -lb.y));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], a.c1, -lb.x));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], a.c1, -lb.y));
      }
    }
    wgmma_wait<1>();  // dp^T
    fence_regs(dp);

    // ds^T = p^T (dp^T - delta) scale, in place of dp^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      if constexpr (PROBE) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] *= a.c1;
      } else {
        const float2 dl = *reinterpret_cast<const float2*>(st_s + BQ + 8 * j + 2 * qd);
        dp[4 * j] = sc[4 * j] * (dp[4 * j] - dl.x) * a.scale;
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - dl.y) * a.scale;
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - dl.x) * a.scale;
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - dl.y) * a.scale;
      }
    }
    wgmma_wait<0>();  // the previous tile's dv and dk: its stage is free
    fence_regs(pa);
    fence_regs(dsa);
    if (t > 0 && lane == 0) mbar_arrive(&bar[1 + S + (t - 1) % S]);
    pack_a<BQ>(pa, sc);
    pack_a<BQ>(dsa, dp);
    prev_q = q_base;
  }
  if (ntiles > 0) {
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    grad_product<HD, BQ>(dv, pa, prev_q + T::QT, BQ);
    grad_product<HD, BQ>(dk, dsa, prev_q, BQ);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(dk);
  fence_regs(dv);
  const long long off = b * a.dkv_bs + head * a.dkv_hs;
  store_rows<HD>(static_cast<__nv_bfloat16*>(a.dk) + off, a.dkv_rs, dk, kv0 + cw * 64, a.nk);
  store_rows<HD>(static_cast<__nv_bfloat16*>(a.dv) + off, a.dkv_rs, dv, kv0 + cw * 64, a.nk);
}

// Pass 2, bf16: dq of 128 q rows (q and do resident; lb and delta in
// registers), walking over the KV tiles (K and V streamed), s and dp
// recomputed per tile.
template <int HD, bool PROBE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                      const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                      const BwdArgs a) {
  using T = BwdTiles<HD>;
  constexpr int BK = T::BK, S = STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + T::RES;
  unsigned char* sKV = smem + 2 * T::RES;  // stage s: K at 2s*KT, V at (2s+1)*KT
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + T::p2_bar);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q0 = blockIdx.x * T::ROWS, head = blockIdx.y, b = blockIdx.z;
  const int ntiles = (a.nk + BK - 1) / BK;
  init_ring(bar, S, 1);

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    mbar_expect_tx(&bar[0], 2 * T::RES);
    tma_rows<T::CB>(sQ, &mq, &bar[0], T::ROWS, q0, head, b);
    tma_rows<T::CB>(sDO, &mdo, &bar[0], T::ROWS, q0, head, b);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(&bar[1 + S + s], (t / S - 1) & 1);
      unsigned char* kv = sKV + s * 2 * T::KT;
      mbar_expect_tx(&bar[1 + s], 2 * T::KT);
      tma_rows<T::CB>(kv, &mk, &bar[1 + s], BK, t * BK, head, b);
      tma_rows<T::CB>(kv + T::KT, &mv, &bar[1 + s], BK, t * BK, head, b);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, qd = lane & 3;
  const uint32_t q_base = smem_addr(sQ) + cw * 64 * 128, do_base = smem_addr(sDO) + cw * 64 * 128;
  // this thread's two q rows (lb = +inf past Nq: p = 0)
  const int r0 = q0 + cw * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const long long st = ((long long)b * a.h + head) * a.nq;
  float lb0 = 0.f, lb1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if constexpr (!PROBE) {
    lb0 = r0 < a.nq ? a.lb[st + r0] : INFINITY;
    lb1 = r0 + 8 < a.nq ? a.lb[st + r0 + 8] : INFINITY;
    dl0 = r0 < a.nq ? a.delta[st + r0] : 0.f;
    dl1 = r0 + 8 < a.nq ? a.delta[st + r0 + 8] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(&bar[0], 0);
  if (cw == 1 && ntiles > 0) start_after_warpgroup_0();

  uint32_t dsa[BK / 16][4];  // ds of the previous tile: its dq product runs behind this tile's scores
  uint32_t prev_k = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    mbar_wait(&bar[1 + s], (t / S) & 1);
    const uint32_t k_base = smem_addr(sKV) + s * 2 * T::KT, v_base = k_base + T::KT;
    // s = q K^T and dp = do V^T: this warpgroup's 64 q rows x BK KV columns
    float sc[BK / 2], dp[BK / 2];
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dq);
    wgmma_fence();
    score_product<HD, BK>(sc, q_base, T::ROWS, k_base, BK);
    wgmma_commit();
    score_product<HD, BK>(dp, do_base, T::ROWS, v_base, BK);
    wgmma_commit();
    if (t > 0) grad_product<HD, BK>(dq, dsa, prev_k, BK);  // dq += ds K
    wgmma_commit();
    wgmma_wait<2>();  // s
    fence_regs(sc);
    if (cw == 0 && t == 0) release_warpgroup_1();
    const int lim = a.nk - t * BK;  // KV columns at or past it lie past Nk: p = 0
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int c = 8 * j + 2 * qd;
      if constexpr (!PROBE) {
        sc[4 * j] = c < lim ? ex2(fmaf(sc[4 * j], a.c1, -lb0)) : 0.f;
        sc[4 * j + 1] = c + 1 < lim ? ex2(fmaf(sc[4 * j + 1], a.c1, -lb0)) : 0.f;
        sc[4 * j + 2] = c < lim ? ex2(fmaf(sc[4 * j + 2], a.c1, -lb1)) : 0.f;
        sc[4 * j + 3] = c + 1 < lim ? ex2(fmaf(sc[4 * j + 3], a.c1, -lb1)) : 0.f;
      }
    }
    wgmma_wait<1>();  // dp
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      if constexpr (PROBE) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] *= a.c1;
      } else {
        dp[4 * j] = sc[4 * j] * (dp[4 * j] - dl0) * a.scale;
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - dl0) * a.scale;
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - dl1) * a.scale;
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - dl1) * a.scale;
      }
    }
    wgmma_wait<0>();  // the previous tile's dq: its stage is free
    fence_regs(dsa);
    if (t > 0 && lane == 0) mbar_arrive(&bar[1 + S + (t - 1) % S]);
    pack_a<BK>(dsa, dp);
    prev_k = k_base;
  }
  if (ntiles > 0) {
    fence_regs(dq);
    wgmma_fence();
    grad_product<HD, BK>(dq, dsa, prev_k, BK);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(dq);
  store_rows<HD>(static_cast<__nv_bfloat16*>(a.dq) + b * a.dq_bs + head * a.dq_hs, a.dq_rs, dq, q0 + cw * 64, a.nq);
}

template <int HD, bool PROBE>
int launch_bwd_wgmma(const BwdArgs& a, int batch, cudaStream_t stream) {
  using T = BwdTiles<HD>;
  // pass 1 streams q and do in BQ-row boxes past K and V resident in 128-row
  // ones; pass 2 the other way round, K and V in BK-row boxes
  CUtensorMap m1[4], m2[4];
  const void* base[4] = {a.q, a.dout, a.k, a.v};
  const long long st[4][3] = {{a.q_rs, a.q_hs, a.q_bs}, {a.do_rs, a.do_hs, a.do_bs},
                              {a.k_rs, a.k_hs, a.k_bs}, {a.v_rs, a.v_hs, a.v_bs}};
  for (int i = 0; i < 4; ++i) {
    const int rows = i < 2 ? a.nq : a.nk;
    cudaError_t err = operand_map(&m1[i], base[i], HD, rows, a.h, batch, st[i][0], st[i][1], st[i][2],
                                  i < 2 ? T::BQ : T::ROWS);
    if (err == cudaSuccess)
      err = operand_map(&m2[i], base[i], HD, rows, a.h, batch, st[i][0], st[i][1], st[i][2], i < 2 ? T::ROWS : T::BK);
    if (err != cudaSuccess) return (int)err;
  }
  auto k1 = attn_bwd_dkdv_wgmma<HD, PROBE>;
  auto k2 = attn_bwd_dq_wgmma<HD, PROBE>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::p1_bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::p2_bytes);
  if (err != cudaSuccess) return (int)err;
  k1<<<dim3((a.nk + T::ROWS - 1) / T::ROWS, a.h, batch), WG_THREADS, T::p1_bytes, stream>>>(m1[0], m1[1], m1[2], m1[3],
                                                                                            a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3((a.nq + T::ROWS - 1) / T::ROWS, a.h, batch), WG_THREADS, T::p2_bytes, stream>>>(m2[0], m2[1], m2[2], m2[3],
                                                                                            a);
  return (int)cudaGetLastError();
}

template <int HD>
struct BwdF32Layout {
  static constexpr int LD = HD + 4;
  static constexpr size_t tile = align128((size_t)64 * LD * 4);
  static constexpr size_t st_off = 4 * tile;  // two streamed and two resident tiles
  static constexpr size_t total = st_off + 2 * BQT * 4;
};

// Pass 1, fp32 (CUDA cores only): two threads per KV row, each holding half
// of the row's dk and dv in registers; K, V and the q/do tile in shared
// memory.
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dkdv_f32(BwdArgs a) {
  using L = BwdF32Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int HH = HD / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + L::tile);
  float* sQ = reinterpret_cast<float*>(smem + 2 * L::tile);
  float* sDO = reinterpret_cast<float*>(smem + 3 * L::tile);
  float* sLB = reinterpret_cast<float*>(smem + L::st_off);
  float* sDL = sLB + BQT;

  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const int kv0 = blockIdx.x * BKV, head = blockIdx.y, b = blockIdx.z;
  const float* Q = static_cast<const float*>(a.q) + b * a.q_bs + head * a.q_hs;
  const float* DO = static_cast<const float*>(a.dout) + b * a.do_bs + head * a.do_hs;
  const float* K = static_cast<const float*>(a.k) + b * a.k_bs + head * a.k_hs;
  const float* V = static_cast<const float*>(a.v) + b * a.v_bs + head * a.v_hs;
  const long long st = ((long long)b * a.h + head) * a.nq;
  const bool ok = kv0 + row < a.nk;

  load_rows<BKV, HD>(sK, LD, K, a.k_rs, kv0, a.nk, tid, BWD_THREADS);
  load_rows<BKV, HD>(sV, LD, V, a.v_rs, kv0, a.nk, tid, BWD_THREADS);
  const float* kr = sK + row * LD + half * HH;
  const float* vr = sV + row * LD + half * HH;

  float dk[HH], dv[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) dk[d] = dv[d] = 0.f;

  for (int q0 = 0; q0 < a.nq; q0 += BQT) {
    __syncthreads();
    load_rows<BQT, HD>(sQ, LD, Q, a.q_rs, q0, a.nq, tid, BWD_THREADS);
    load_rows<BQT, HD>(sDO, LD, DO, a.do_rs, q0, a.nq, tid, BWD_THREADS);
    load_stats(sLB, sDL, a, st, q0, tid);
    __syncthreads();
    const int qvalid = min(BQT, a.nq - q0);
    for (int i = 0; i < qvalid; ++i) {
      const float* qi = sQ + i * LD + half * HH;
      const float* di = sDO + i * LD + half * HH;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        s = fmaf(qi[d], kr[d], s);
        dpv = fmaf(di[d], vr[d], dpv);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dpv += __shfl_xor_sync(0xffffffffu, dpv, 1);
      const float p = ok ? exp2f(s * a.c1 - sLB[i]) : 0.f;
      const float ds = p * (dpv - sDL[i]) * a.scale;
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        dv[d] = fmaf(p, di[d], dv[d]);
        dk[d] = fmaf(ds, qi[d], dk[d]);
      }
    }
  }

  if (ok) {
    const long long off = b * a.dkv_bs + (long long)(kv0 + row) * a.dkv_rs + head * a.dkv_hs + half * HH;
    float* dkr = static_cast<float*>(a.dk) + off;
    float* dvr = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      dkr[d] = dk[d];
      dvr[d] = dv[d];
    }
  }
}

// Pass 2, fp32: two threads per q row, each holding half of the row's q, do
// and dq in registers; K and V tiles in shared memory.
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dq_f32(BwdArgs a) {
  using L = BwdF32Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int HH = HD / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + L::tile);

  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const int q0 = blockIdx.x * BQT, head = blockIdx.y, b = blockIdx.z;
  const float* Q = static_cast<const float*>(a.q) + b * a.q_bs + head * a.q_hs;
  const float* DO = static_cast<const float*>(a.dout) + b * a.do_bs + head * a.do_hs;
  const float* K = static_cast<const float*>(a.k) + b * a.k_bs + head * a.k_hs;
  const float* V = static_cast<const float*>(a.v) + b * a.v_bs + head * a.v_hs;
  const long long st = ((long long)b * a.h + head) * a.nq;
  const int qrow = q0 + row;
  const bool ok = qrow < a.nq;
  const float lbq = ok ? a.lb[st + qrow] : INFINITY;
  const float dlq = ok ? a.delta[st + qrow] : 0.f;

  float q[HH], dov[HH], dq[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) {
    q[d] = ok ? Q[qrow * a.q_rs + half * HH + d] : 0.f;
    dov[d] = ok ? DO[qrow * a.do_rs + half * HH + d] : 0.f;
    dq[d] = 0.f;
  }

  for (int k0 = 0; k0 < a.nk; k0 += BKV) {
    __syncthreads();
    load_rows<BKV, HD>(sK, LD, K, a.k_rs, k0, a.nk, tid, BWD_THREADS);
    load_rows<BKV, HD>(sV, LD, V, a.v_rs, k0, a.nk, tid, BWD_THREADS);
    __syncthreads();
    const int kvalid = min(BKV, a.nk - k0);
    for (int j = 0; j < kvalid; ++j) {
      const float* kj = sK + j * LD + half * HH;
      const float* vj = sV + j * LD + half * HH;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) {
        s = fmaf(q[d], kj[d], s);
        dpv = fmaf(dov[d], vj[d], dpv);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dpv += __shfl_xor_sync(0xffffffffu, dpv, 1);
      const float ds = exp2f(s * a.c1 - lbq) * (dpv - dlq) * a.scale;
#pragma unroll
      for (int d = 0; d < HH; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
    }
  }

  if (ok) {
    float* out = static_cast<float*>(a.dq) + b * a.dq_bs + (long long)qrow * a.dq_rs + head * a.dq_hs + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) out[d] = dq[d];
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int bytes, cudaStream_t stream, const BwdArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BWD_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, bool PROBE = false>
int launch_bwd_hd(const BwdArgs& a, int batch, int dtype, cudaStream_t stream) {
  if (dtype == kBFloat16) return launch_bwd_wgmma<HD, PROBE>(a, batch, stream);
  if constexpr (PROBE) {
    return (int)cudaErrorInvalidValue;
  } else {
    const dim3 kv_grid((a.nk + BKV - 1) / BKV, a.h, batch);
    const dim3 q_grid((a.nq + BQT - 1) / BQT, a.h, batch);
    cudaError_t err = launch_one(attn_bwd_dkdv_f32<HD>, kv_grid, (int)BwdF32Layout<HD>::total, stream, a);
    if (err == cudaSuccess) err = launch_one(attn_bwd_dq_f32<HD>, q_grid, (int)(2 * BwdF32Layout<HD>::tile), stream, a);
    return (int)err;
  }
}

}  // namespace cs
