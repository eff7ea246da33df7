// The two-pass flash-attention backward shared by K4, K8 and K9
// (flash_cross_bwd.cu) and K12 (lane_pad_probe.cu): pass 1 (dkdv) takes one
// block per (batch, head, 64-row KV tile) and walks over the q tiles, pass 2
// (dq) one block per (batch, head, 64-row q tile) walking over the KV tiles;
// the design and its bound are set out in flash_cross_bwd.cu.
//
// PROBE (K12, bf16 only): the recipe's transcendentals replaced by casts, as
// the TPU tool tools/lane_pad_probe.py replaces them (its `probe_kernel`):
// p = bf16(s * c1) and ds = bf16(dp * c1), with no lb and no delta; the five
// products, their fp32 accumulation and the two passes are the backward's.
// Rows past Nq or Nk load as zeros, so they add nothing, as in the recipe.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace cs {

constexpr int BWD_THREADS = 128;
constexpr int BKV = 64;  // KV rows per block (16 per warp in the bf16 path)
constexpr int BQT = 64;  // q rows per tile of the loop

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

template <int HD>
struct BwdBfLayout {
  static constexpr int LD = HD + 8;  // padded rows: ldmatrix without bank conflicts
  static constexpr size_t tile = align128((size_t)64 * LD * 2);
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = tile;
  static constexpr size_t qd_off = 2 * tile;             // two stages of (q, do)
  static constexpr size_t st_off = 6 * tile;
  static constexpr size_t total = st_off + 4 * BQT * 4;  // two stages of (lb, delta)
};

// Pass 1, bf16: dk and dv of one 64-row KV tile.
template <int HD, bool PROBE = false>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dkdv_bf16(BwdArgs a) {
  using L = BwdBfLayout<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD;
  constexpr int NKT = HD / 16;  // k-steps over hd
  constexpr int NOT = HD / 8;   // n8 tiles over hd
  constexpr int NST = BQT / 8;  // n8 tiles over a q tile
  constexpr int TILE = (int)(L::tile / 2);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sQD = reinterpret_cast<bf16*>(smem + L::qd_off);  // stage s: q at 2s*TILE, do at (2s+1)*TILE
  float* sST = reinterpret_cast<float*>(smem + L::st_off);  // stage s: lb at 2s*BQT, delta at (2s+1)*BQT

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int kv0 = blockIdx.x * BKV, head = blockIdx.y, b = blockIdx.z;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_bs + head * a.q_hs;
  const bf16* DO = static_cast<const bf16*>(a.dout) + b * a.do_bs + head * a.do_hs;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_bs + head * a.k_hs;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_bs + head * a.v_hs;
  const long long st = ((long long)b * a.h + head) * a.nq;

  cp_async_rows<BKV, HD, BWD_THREADS>(sK, LD, K, a.k_rs, kv0, a.nk, tid);
  cp_async_rows<BKV, HD, BWD_THREADS>(sV, LD, V, a.v_rs, kv0, a.nk, tid);
  cp_async_rows<BQT, HD, BWD_THREADS>(sQD, LD, Q, a.q_rs, 0, a.nq, tid);
  cp_async_rows<BQT, HD, BWD_THREADS>(sQD + TILE, LD, DO, a.do_rs, 0, a.nq, tid);
  cp_async_commit();
  if constexpr (!PROBE) load_stats(sST, sST + BQT, a, st, 0, tid);

  // this warp's KV rows: kv0 + warp*16 + g and + 8
  const int r0 = kv0 + warp * 16 + g;
  const bool ok0 = r0 < a.nk, ok1 = r0 + 8 < a.nk;

  float dk[NOT][4], dv[NOT][4];
#pragma unroll
  for (int d = 0; d < NOT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  const int ntiles = (a.nq + BQT - 1) / BQT;
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next q/do tile into the other stage
      bf16* nQ = sQD + (stage ^ 1) * 2 * TILE;
      cp_async_rows<BQT, HD, BWD_THREADS>(nQ, LD, Q, a.q_rs, (t + 1) * BQT, a.nq, tid);
      cp_async_rows<BQT, HD, BWD_THREADS>(nQ + TILE, LD, DO, a.do_rs, (t + 1) * BQT, a.nq, tid);
      cp_async_commit();
      if constexpr (!PROBE)
        load_stats(sST + (stage ^ 1) * 2 * BQT, sST + (stage ^ 1) * 2 * BQT + BQT, a, st, (t + 1) * BQT, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQ = sQD + stage * 2 * TILE;
    const bf16* sDO = sQ + TILE;
    const float* sLB = sST + stage * 2 * BQT;
    const float* sDL = sLB + BQT;

    // s^T = K Q^T and dp^T = V dO^T for this warp's 16 KV rows x 64 q columns
    float s[NST][4], dp[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_a(ka, sK + warp * 16 * LD + kk * 16, LD, lane);
      ldsm_a(va, sV + warp * 16 * LD + kk * 16, LD, lane);
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t bq[4], bd[4];
        ldsm_b_nk_x2tiles(bq, sQ + np * 16 * LD + kk * 16, LD, lane);
        ldsm_b_nk_x2tiles(bd, sDO + np * 16 * LD + kk * 16, LD, lane);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bd[0], bd[1]);
        mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // p^T and ds^T, rounded to bf16 into A fragments
    uint32_t pa[BQT / 16][4], dsa[BQT / 16][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (PROBE) {
          p[e] = s[j][e] * a.c1;
          p[2 + e] = s[j][2 + e] * a.c1;
          ds[e] = dp[j][e] * a.c1;
          ds[2 + e] = dp[j][2 + e] * a.c1;
        } else {
          const int c = j * 8 + qd * 2 + e;
          const float lbq = sLB[c], dlq = sDL[c];
          p[e] = ok0 ? ex2(fmaf(s[j][e], a.c1, -lbq)) : 0.f;
          p[2 + e] = ok1 ? ex2(fmaf(s[j][2 + e], a.c1, -lbq)) : 0.f;
          ds[e] = p[e] * (dp[j][e] - dlq) * a.scale;
          ds[2 + e] = p[2 + e] * (dp[j][2 + e] - dlq) * a.scale;
        }
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dv += p^T dO and dk += ds^T Q (k = the tile's 64 q rows)
#pragma unroll
    for (int ks = 0; ks < BQT / 16; ++ks) {
#pragma unroll
      for (int dd = 0; dd < NOT / 2; ++dd) {
        uint32_t bd[4], bq[4];
        ldsm_b_kn_x2tiles(bd, sDO + ks * 16 * LD + dd * 16, LD, lane);
        ldsm_b_kn_x2tiles(bq, sQ + ks * 16 * LD + dd * 16, LD, lane);
        mma_bf16(dv[2 * dd], pa[ks], bd[0], bd[1]);
        mma_bf16(dv[2 * dd + 1], pa[ks], bd[2], bd[3]);
        mma_bf16(dk[2 * dd], dsa[ks], bq[0], bq[1]);
        mma_bf16(dk[2 * dd + 1], dsa[ks], bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is refilled next iteration
  }

  bf16* DK = static_cast<bf16*>(a.dk) + b * a.dkv_bs + head * a.dkv_hs + qd * 2;
  bf16* DV = static_cast<bf16*>(a.dv) + b * a.dkv_bs + head * a.dkv_hs + qd * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= a.nk) continue;
#pragma unroll
    for (int d = 0; d < NOT; ++d) {
      *reinterpret_cast<uint32_t*>(DK + (long long)r * a.dkv_rs + d * 8) = pack_bf16(dk[d][2 * hh], dk[d][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(DV + (long long)r * a.dkv_rs + d * 8) = pack_bf16(dv[d][2 * hh], dv[d][2 * hh + 1]);
    }
  }
}

// Pass 2, bf16: dq of one 64-row q tile. The forward's structure: q and do
// fragments stay in registers, K and V tiles stream through shared memory
// (cp.async, two stages), s and dp are recomputed per tile and ds K
// accumulates in fp32 registers.
template <int HD>
struct BwdDqLayout {
  static constexpr int LD = HD + 8;
  static constexpr size_t tile = align128((size_t)64 * LD * 2);
  static constexpr size_t kv_off = 2 * tile;          // q and do tiles first
  static constexpr size_t total = kv_off + 4 * tile;  // K and V, two stages
};

template <int HD, bool PROBE = false>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dq_bf16(BwdArgs a) {
  using L = BwdDqLayout<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD;
  constexpr int NKT = HD / 16;
  constexpr int NOT = HD / 8;
  constexpr int NST = BKV / 8;
  constexpr int TILE = (int)(L::tile / 2);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + TILE;
  bf16* sKV = reinterpret_cast<bf16*>(smem + L::kv_off);  // stage s: K at 2s*TILE, V at (2s+1)*TILE

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int q0 = blockIdx.x * BQT, head = blockIdx.y, b = blockIdx.z;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_bs + head * a.q_hs;
  const bf16* DO = static_cast<const bf16*>(a.dout) + b * a.do_bs + head * a.do_hs;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_bs + head * a.k_hs;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_bs + head * a.v_hs;
  const long long st = ((long long)b * a.h + head) * a.nq;

  cp_async_rows<BQT, HD, BWD_THREADS>(sQ, LD, Q, a.q_rs, q0, a.nq, tid);
  cp_async_rows<BQT, HD, BWD_THREADS>(sDO, LD, DO, a.do_rs, q0, a.nq, tid);
  cp_async_rows<BKV, HD, BWD_THREADS>(sKV, LD, K, a.k_rs, 0, a.nk, tid);
  cp_async_rows<BKV, HD, BWD_THREADS>(sKV + TILE, LD, V, a.v_rs, 0, a.nk, tid);
  cp_async_commit();
  // this thread's q rows: q0 + warp*16 + g and + 8 (lb = +inf past Nq: p = 0)
  const int r0 = q0 + warp * 16 + g;
  const float lb0 = PROBE ? 0.f : r0 < a.nq ? a.lb[st + r0] : INFINITY;
  const float lb1 = PROBE ? 0.f : r0 + 8 < a.nq ? a.lb[st + r0 + 8] : INFINITY;
  const float dl0 = PROBE ? 0.f : r0 < a.nq ? a.delta[st + r0] : 0.f;
  const float dl1 = PROBE ? 0.f : r0 + 8 < a.nq ? a.delta[st + r0 + 8] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[NKT][4], da[NKT][4];
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    ldsm_a(qa[kk], sQ + warp * 16 * LD + kk * 16, LD, lane);
    ldsm_a(da[kk], sDO + warp * 16 * LD + kk * 16, LD, lane);
  }

  float dq[NOT][4];
#pragma unroll
  for (int d = 0; d < NOT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;

  const int ntiles = (a.nk + BKV - 1) / BKV;
  for (int t = 0; t < ntiles; ++t) {
    const bf16* sK = sKV + (t & 1) * 2 * TILE;
    const bf16* sV = sK + TILE;
    if (t + 1 < ntiles) {  // prefetch the next K/V tile into the other stage
      bf16* nK = sKV + ((t + 1) & 1) * 2 * TILE;
      cp_async_rows<BKV, HD, BWD_THREADS>(nK, LD, K, a.k_rs, (t + 1) * BKV, a.nk, tid);
      cp_async_rows<BKV, HD, BWD_THREADS>(nK + TILE, LD, V, a.v_rs, (t + 1) * BKV, a.nk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's 16 q rows x 64 KV columns
    float s[NST][4], dp[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_b_nk_x2tiles(bk, sK + np * 16 * LD + kk * 16, LD, lane);
        ldsm_b_nk_x2tiles(bv, sV + np * 16 * LD + kk * 16, LD, lane);
        mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * np], da[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], da[kk], bv[2], bv[3]);
      }
    }

    // ds, rounded to bf16 into A fragments; KV columns past Nk get p = 0
    uint32_t dsa[BKV / 16][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (PROBE) {
          ds[e] = dp[j][e] * a.c1;
          ds[2 + e] = dp[j][2 + e] * a.c1;
        } else {
          const bool ok = t * BKV + j * 8 + qd * 2 + e < a.nk;
          const float p0 = ok ? ex2(fmaf(s[j][e], a.c1, -lb0)) : 0.f;
          const float p1 = ok ? ex2(fmaf(s[j][2 + e], a.c1, -lb1)) : 0.f;
          ds[e] = p0 * (dp[j][e] - dl0) * a.scale;
          ds[2 + e] = p1 * (dp[j][2 + e] - dl1) * a.scale;
        }
      }
      dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dq += ds K (k = the tile's 64 KV rows)
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
#pragma unroll
      for (int dd = 0; dd < NOT / 2; ++dd) {
        uint32_t bk[4];
        ldsm_b_kn_x2tiles(bk, sK + ks * 16 * LD + dd * 16, LD, lane);
        mma_bf16(dq[2 * dd], dsa[ks], bk[0], bk[1]);
        mma_bf16(dq[2 * dd + 1], dsa[ks], bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  bf16* DQ = static_cast<bf16*>(a.dq) + b * a.dq_bs + head * a.dq_hs + qd * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= a.nq) continue;
#pragma unroll
    for (int d = 0; d < NOT; ++d)
      *reinterpret_cast<uint32_t*>(DQ + (long long)r * a.dq_rs + d * 8) = pack_bf16(dq[d][2 * hh], dq[d][2 * hh + 1]);
  }
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
  const dim3 kv_grid((a.nk + BKV - 1) / BKV, a.h, batch);
  const dim3 q_grid((a.nq + BQT - 1) / BQT, a.h, batch);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = launch_one(attn_bwd_dkdv_bf16<HD, PROBE>, kv_grid, (int)BwdBfLayout<HD>::total, stream, a);
    if (err == cudaSuccess)
      err = launch_one(attn_bwd_dq_bf16<HD, PROBE>, q_grid, (int)BwdDqLayout<HD>::total, stream, a);
  } else if constexpr (PROBE) {
    return (int)cudaErrorInvalidValue;
  } else {
    err = launch_one(attn_bwd_dkdv_f32<HD>, kv_grid, (int)BwdF32Layout<HD>::total, stream, a);
    if (err == cudaSuccess) err = launch_one(attn_bwd_dq_f32<HD>, q_grid, (int)(2 * BwdF32Layout<HD>::tile), stream, a);
  }
  return (int)err;
}

}  // namespace cs

