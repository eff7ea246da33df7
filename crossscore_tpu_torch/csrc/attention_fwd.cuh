// Flash-attention forward shared by K1 and K5 (flash_qkv.cu) and K3, K6 and
// K7 (flash_cross.cu), and the timing modes K11 and K7' (below;
// attention_modes.cu).
//
// softmax(Q K^T * scale) V for one (batch, head, 128-row q tile) per block,
// with an online softmax over 128-row KV tiles, so the Nq x Nk score matrix
// never reaches device memory. Q, K, V and O are addressed by batch, head and
// row strides with the HD columns of a row contiguous: K1 passes the three
// sections of the fused (B, N, 3D) qkv projection and K3 the separate
// (B, N, D) q/k/v projections (head stride HD: heads side by side in a
// token-major row), K7 head-major (B, H, N, HD) tensors or their strided
// views (any head stride). The statistics l (sum of exp(scaled - m)) and m
// (row max of the scaled logits, natural units) go to (B, H, Nq) fp32, the
// JAX package's (o, l, m) convention.
// Ragged tails are masked on both sides: q rows past Nq are computed from
// zeros and never stored, KV columns past Nk get -inf logits (and zero V).
//
// It replaces the TPU kernels crossscore_tpu/ops/flash_attention.py
// `_fwd_kernel_qkv` (:1347, K1), `_fwd_kernel_qkv_biased` (:1227, K5),
// `_fwd_kernel_cross_ln` (:799, K3 and, with `per_item`, K6) and the bodies of
// `_flash_fwd` (:285): `_fwd_kernel` (:69), `_fwd_kernel_single` (:118),
// `_fwd_kernel_v2` (:186) and `_fwd_kernel_single_v2` (:231) (K7).
//
// K5 and K6 are the same kernels with BIAS = true: an fp32 additive bias over
// the KV tokens (0 for a valid token, -1e30 for a bucket-padded one), one row
// shared by the batch (bias_bs = 0) or one row per batch item (bias_bs = Nk,
// selected by blockIdx.z). The score becomes s * c1 + bias[col] * log2(e) in
// fp32 before the row max; -1e30 * log2(e) stays finite in fp32 and exp2 of
// it is 0. The tail mask is applied after the bias, so the two combine. With
// BIAS = false the unmasked K1 and K3 compile exactly as without the bias.
//
// Timing modes (template parameter MODE of the bf16 kernel; kExact is every
// kernel above). They are the counterparts of the TPU timing bodies, each
// computing what its TPU body computes, wrong math included, and no model
// path reaches them. They are variants of the same kernel's score epilogue,
// so they split the kernel that the model runs:
//   K11 (`_fwd_kernel_qkv_probe`, `_fwd_kernel_qkv_chunked`, off K1's fused
//   qkv; flash_qkv.cu):
//     kNoMax   p = bf16(exp2(s * c1 - 8)), no row max; l = sum p, o / l, and
//              the m output is l * scale (the TPU probe stores m = l);
//     kNoSum   the running row max of the raw scores, p = bf16(exp2((s - m)
//              * c1)), no row sum; o / m, l = m;
//     kMxu     p = bf16(s) unscaled, o = p v unnormalised, l = m = 0;
//     kPartial K1's exact softmax over one KV chunk per block (blockIdx.x
//              selects the chunk), writing the unnormalised fp32 o, l and m
//              (log2 units) of the chunk; flash_qkv.cu merges the chunks.
//   K7' (`_fwd_kernel_v2_mxu_probe`, the `noexp` / `bf16` options of
//   `_fwd_kernel_single_v2`, head-major; flash_cross.cu):
//     kMxuProbe p = bf16(s * c1), o = p v unnormalised, l = sum p, m = 0;
//     kNoExp    p = bf16(s * c1 - m), no exp; o / l, l = sum p;
//     kBf16Exp  p = exp2 of bf16(s * c1 - m) in bf16, as JAX computes a
//               bf16 exp2: bf16(exp(bf16(x * bf16(ln 2)))); o / l, l = sum p.
//   The TPU computes kNoExp and kBf16Exp in its single-KV-block body, where
//   m is the exact row max before any p is formed. A block here streams KV
//   tiles, and a linear p (noexp) cannot be rescaled by a later max, so for
//   these two modes the producer streams every K tile twice: a Q K^T-only
//   pass takes the exact row max, then the P V pass runs with m fixed (the
//   TPU's function and rounding, at the price of a third product: 6 N^2 hd
//   operations per head against 4). Every mode but kExact sums the
//   bf16-rounded p into l, as the TPU bodies do. KV columns past Nk
//   contribute nothing in any mode. The modes run on bf16 only and take no
//   bias.
//
// Bound on the H100 (SXM, 700 W): per head, 4 Nq Nk hd product operations at
// 989 TFLOP/s (bf16 tensor cores) and Nq Nk exponentials at ~3.9 T/s (the
// special-function units: 16 a clock on each of 132 SMs; FlashAttention-3,
// arXiv 2407.08608, section 1) against (2 Nq + 2 Nk) hd * 2 bytes at 3.35
// TB/s. The bytes are far below both: at hd 64 the products' and the
// exponentials' floors are equal, at hd 48 the exponentials' is a third
// higher. A kernel that runs a tile's products and then its exponentials
// one after the other cannot pass half the bound, so the design overlaps
// them (bf16):
// - products on wgmma: S = Q K^T with both operands K-major in shared memory
//   (m64n128, N the KV tile), O += P V with P packed to bf16 straight from the
//   S accumulators into A registers and V read MN-major from the same
//   128-byte swizzled tile (m64n{HD});
// - loads by TMA: Q once per block, K and V through a ring of mbarrier stages
//   fed by one producer warp, from one 4-D tensor map per operand (hd, rows,
//   heads, batch), so that any stride layout maps in place and a ragged box
//   reads zeros, never the next head's or batch item's rows;
// - two consumer warpgroups of 64 q rows each, taking turns on the tensor
//   cores (named barriers 2 and 3, FlashAttention-3's "ping-pong") and on
//   the special-function units (4 and 5): one warpgroup's exponentials run
//   while the other's products do, and the two softmaxes never share the
//   units;
// - inside a warpgroup, the previous tile's P V is issued behind this tile's
//   Q K^T, its P packed in one of two register buffers while the other is
//   this tile's. Every product is done by the end of its iteration: one
//   left in flight across the loop's back edge makes ptxas serialise every
//   wgmma of the kernel (C7515). ptxas places the wait for that P V right
//   after the wait for Q K^T, ahead of the exponentials, whatever the source
//   order (PERF.md), so within a warpgroup the softmax follows both of its
//   products; the overlap is between the warpgroups.
// fp32 inputs take their own body on the tensor cores in 3xTF32 (three TF32
// products a product, fp32-level error; attention_fwd_f32.cuh), which shares
// AttnArgs, the ring's turns and tile_softmax with this one.
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace cs {

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;
  float* m;
  long long q_bs, q_hs, q_rs;  // batch, head and row strides, in elements
  long long k_bs, k_hs, k_rs;
  long long v_bs, v_hs, v_rs;
  long long o_bs, o_hs, o_rs;
  int h, nq, nk;
  float c1;  // softmax scale * log2(e)
  const float* bias = nullptr;  // K5/K6: (Nk,) or (B, Nk) fp32, natural units
  long long bias_bs = 0;        // batch stride of bias: 0 (shared row) or Nk
  // kPartial: KV rows per chunk and the chunks' partial o (C, B, H, Nq, hd),
  // l and m (C, B, H, Nq), fp32
  int kv_chunk = 0;
  float* part_o = nullptr;
  float* part_l = nullptr;
  float* part_m = nullptr;
  const void* kv_tiles = nullptr;  // fp32: the pre-pass's split K / V stages (attention_fwd_f32.cuh)
};

// the score-epilogue modes of attn_fwd_wgmma (see the top of this file)
constexpr int kExact = 0;
constexpr int kNoMax = 1;
constexpr int kNoSum = 2;
constexpr int kMxu = 3;
constexpr int kPartial = 4;
constexpr int kMxuProbe = 5;
constexpr int kNoExp = 6;
constexpr int kBf16Exp = 7;

// p of one score s (c: the scale applied to s; shift: this row's exponent
// shift in scaled units; ok: the column lies inside Nk). In the exp modes a
// column past Nk arrives as s = -inf and gives p = 0. kBf16Exp takes its
// pairs through bf16_exp2_pair instead.
template <int MODE>
__device__ __forceinline__ float score_to_p(float s, float c, float shift, bool ok) {
  if constexpr (MODE == kMxu) return ok ? s : 0.f;
  else if constexpr (MODE == kMxuProbe) return ok ? s * c : 0.f;
  else if constexpr (MODE == kNoExp) return ok ? fmaf(s, c, -shift) : 0.f;
  else return ex2(fmaf(s, c, -shift));
}

// kBf16Exp's p of two scores of one row: exp(bf16(bf16(t - m) * bf16(ln 2)))
// with t = s * c, JAX's bf16 exp2, on packed pairs (one conversion and one
// bf16x2 product for the two arguments, rounded as JAX rounds them)
__device__ __forceinline__ float2 bf16_exp2_pair(float s0, float s1, float c, float shift, bool ok0, bool ok1) {
  __nv_bfloat162 t = __floats2bfloat162_rn(fmaf(s0, c, -shift), fmaf(s1, c, -shift));
  t = __hmul2(t, __float2bfloat162_rn(0.69140625f));
  const float2 u = __bfloat1622float2(t);
  return make_float2(ok0 ? ex2(u.x * kLog2e) : 0.f, ok1 ? ex2(u.y * kLog2e) : 0.f);
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The bf16 tile plan of head dim HD. Shared rows are hd padded to CB
// 64-column SW128 blocks (the padding read as zeros from TMA and never by a
// product: Q K^T stops at hd, P V is m64n{HD}). A consumer holds S (BK/2
// fp32 registers), O (HD/2) and two buffers of P packed to bf16 (BK/4 each):
// BK = 128 costs 128 + HD/2, within the consumers' 240 at every HD. The ring
// holds the tile that P V still reads, the tile under Q K^T and the next:
// four stages of 32 KB up to HD 64, three of 64 KB above (231,992 bytes with
// Q and the bias rows, of the 232,448 a block may take); the block runs
// alone on its SM, held there by its registers. K5 and K6 stage each tile's
// bias row beside it (BK fp32 a stage, written by the producer warp).
template <int HD>
struct FwdTiles {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  static constexpr int CB = (HD + 63) / 64;
  static constexpr int ROWS = 128;  // q rows a block: 64 per consumer warpgroup
  static constexpr int BK = 128;    // KV rows a tile
  static constexpr int STAGES = CB == 1 ? 4 : 3;
  static constexpr uint32_t QB = CB * ROWS * 128;  // bytes of the Q tile
  static constexpr uint32_t KT = CB * BK * 128;    // of a K or V tile
  static constexpr uint32_t bias_off = QB + STAGES * 2 * KT;  // stage s: BK fp32 at bias_off + s*BK*4
  static constexpr uint32_t bar_off = bias_off + STAGES * BK * 4;
  static constexpr uint32_t bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

// The two consumer warpgroups take turns to issue their products (named
// barrier 2 + cw: warpgroup cw's turn) and to run their softmax (barrier
// 4 + cw); warpgroup 1 arrives first on both, so warpgroup 0 starts. (A
// single offset of half an iteration, as the backward's passes start, was
// slower on the H100 at hd 48 and 64.)
__device__ __forceinline__ void wait_turn(int cw) { asm volatile("bar.sync %0, 256;\n" ::"r"(2 + cw) : "memory"); }
__device__ __forceinline__ void pass_turn(int cw) { asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - cw) : "memory"); }
__device__ __forceinline__ void wait_sm_turn(int cw) { asm volatile("bar.sync %0, 256;\n" ::"r"(4 + cw) : "memory"); }
__device__ __forceinline__ void pass_sm_turn(int cw) { asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - cw) : "memory"); }

// One consumer thread's softmax of a TILE-column tile: p in place of its
// scores sc (rows g and g + 8 of its warp's 16; TILE/8 column pairs each),
// with bc the bias of its columns (BIAS) and lim the tile's valid columns.
// Keeps the running row maxima m_run (scaled log2 units) and the thread's
// partial row sums l_run; alpha: the factor that rescales the earlier
// tiles' o.
template <int TILE, int MODE, bool BIAS>
__device__ __forceinline__ void tile_softmax(float (&sc)[TILE / 2], const float (&bc)[TILE / 8][2], int lim, float c1,
                                             float cs, int qd, float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  constexpr bool TRACK_MAX = MODE == kExact || MODE == kNoSum || MODE == kPartial;
  constexpr bool HAS_L = MODE != kNoSum && MODE != kMxu;
  if constexpr (BIAS) {
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = fmaf(sc[4 * j + e], c1, bc[j][e]);
        sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], c1, bc[j][e]);
      }
  }
  if (lim < TILE) {  // the ragged last tile: columns at or past Nk
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * qd + e >= lim) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sh;  // this row's exponent shift, scaled units
    alpha[h] = 1.f;
    if constexpr (TRACK_MAX) {
      // four independent chains, then their max: a short dependency path
      float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) m4[j % 4] = fmaxf(m4[j % 4], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      float mx = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // running maxima in scaled units (c1 > 0, so scaling keeps the max)
      const float mn = fmaxf(m_run[h], mx * cs);
      alpha[h] = ex2(m_run[h] - mn);
      m_run[h] = sh = mn;
    } else if constexpr (MODE == kNoMax) {
      sh = 8.f;  // the TPU probe's constant shift in place of the row max
    } else {
      sh = m_run[h];  // FIXED_MAX: the exact row max (unused by the MXU modes)
    }
    float r4[4] = {0.f, 0.f, 0.f, 0.f};  // the row sum in four chains
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      float& s0 = sc[4 * j + 2 * h];
      float& s1 = sc[4 * j + 2 * h + 1];
      const bool ok0 = s0 > -INFINITY, ok1 = s1 > -INFINITY;  // inside Nk
      float p0, p1;
      if constexpr (MODE == kBf16Exp) {
        const float2 p = bf16_exp2_pair(s0, s1, cs, sh, ok0, ok1);
        p0 = p.x, p1 = p.y;
      } else {
        p0 = score_to_p<MODE>(s0, cs, sh, ok0);
        p1 = score_to_p<MODE>(s1, cs, sh, ok1);
      }
      if constexpr (MODE != kExact) {  // l sums the bf16 p that P V multiplies, as the TPU bodies do
        p0 = bf16_round(p0);
        p1 = bf16_round(p1);
      }
      r4[j % 4] += p0 + p1;
      s0 = p0;
      s1 = p1;
    }
    if constexpr (HAS_L) l_run[h] = l_run[h] * alpha[h] + ((r4[0] + r4[1]) + (r4[2] + r4[3]));
  }
}

// bf16, on Hopper: one producer warp (TMA), two consumer warpgroups (wgmma;
// see the top of this file). Grid: (q tiles [x KV chunks for kPartial],
// heads, batch).
template <int HD, bool BIAS, int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    attn_fwd_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const AttnArgs a) {
  static_assert(MODE == kExact || !BIAS, "the timing modes take no bias");
  using T = FwdTiles<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int BKV = T::BK, S = T::STAGES;
  // modes that keep an online row max (and rescale o by it); that take the
  // exact row max first, in a pass of their own
  constexpr bool TRACK_MAX = MODE == kExact || MODE == kNoSum || MODE == kPartial;
  constexpr bool FIXED_MAX = MODE == kNoExp || MODE == kBf16Exp;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + T::QB;  // stage s: K at 2s*KT, V at (2s+1)*KT
  float* sBias = reinterpret_cast<float*>(smem + T::bias_off);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  // kPartial: blockIdx.x = chunk * (q tiles) + q tile; the block sees KV
  // rows [kv0, kv0 + nk) only
  int qblk = blockIdx.x, nk = a.nk, chunk = 0, kv0 = 0;
  if constexpr (MODE == kPartial) {
    const int nqt = (a.nq + T::ROWS - 1) / T::ROWS;
    chunk = blockIdx.x / nqt;
    qblk = blockIdx.x - chunk * nqt;
    kv0 = chunk * a.kv_chunk;
    nk = min(a.kv_chunk, a.nk - kv0);
  }
  const int q0 = qblk * T::ROWS, head = blockIdx.y, b = blockIdx.z;
  const int ntiles = (nk + BKV - 1) / BKV;
  const float* bias = BIAS ? a.bias + b * a.bias_bs : nullptr;
  init_ring(bar, S, BIAS ? 33 : 1);  // full: the TMA bytes (with a bias, then the producer warp's 32 lanes)

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (BIAS ? tid >= 32 : tid != 0) return;
    if (lane == 0) {
      mbar_expect_tx(&bar[0], T::QB);
      tma_rows<T::CB>(sQ, &mq, &bar[0], T::ROWS, q0, head, b);
    }
    // FIXED_MAX streams the K tiles once alone (the row-max pass), then K and V
    const int total = (FIXED_MAX ? 2 : 1) * ntiles;
    for (int it = 0; it < total; ++it) {
      const int s = it % S, t = it < ntiles ? it : it - ntiles;
      const bool with_v = !FIXED_MAX || it >= ntiles;
      if (it >= S) mbar_wait(&bar[1 + S + s], (it / S - 1) & 1);
      if (lane == 0) {
        unsigned char* kv = sKV + s * 2 * T::KT;
        mbar_expect_tx(&bar[1 + s], (with_v ? 2 : 1) * T::KT);
        tma_rows<T::CB>(kv, &mk, &bar[1 + s], BKV, kv0 + t * BKV, head, b);
        if (with_v) tma_rows<T::CB>(kv + T::KT, &mv, &bar[1 + s], BKV, kv0 + t * BKV, head, b);
      }
      if constexpr (BIAS) {  // the tile's bias row in log2 units, 0 past Nk
        float* sb = sBias + s * BKV;
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i) {
          const int col = t * BKV + lane + 32 * i;
          sb[lane + 32 * i] = col < nk ? __ldg(bias + col) * kLog2e : 0.f;
        }
        mbar_arrive(&bar[1 + s]);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, qd = lane & 3;
  const uint32_t q_base = smem_addr(sQ) + cw * 64 * 128, kv_base = smem_addr(sKV);
  // with a bias the scores are scaled (and biased) in place, so the softmax
  // runs at scale 1; without one it folds c1 into its FMAs
  const float cs = BIAS ? 1.f : a.c1;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(&bar[0], 0);

  int it = 0;  // the ring's position, across both passes of FIXED_MAX
  if constexpr (FIXED_MAX) {
    // the exact row max of the scaled scores, from a Q K^T-only pass
    float mx[2] = {-INFINITY, -INFINITY};
    for (int t = 0; t < ntiles; ++t, ++it) {
      const int s = it % S;
      mbar_wait(&bar[1 + s], (it / S) & 1);
      float sc[BKV / 2];
      fence_regs(sc);
      wgmma_fence();
      score_product<HD, BKV>(sc, q_base, T::ROWS, kv_base + s * 2 * T::KT, BKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&bar[1 + S + s]);
      const int lim = nk - t * BKV;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * qd + e < lim) {
            mx[0] = fmaxf(mx[0], sc[4 * j + e]);
            mx[1] = fmaxf(mx[1], sc[4 * j + 2 + e]);
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = mx[h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      m_run[h] = v * cs;
    }
  }

  if (cw == 1) {  // warpgroup 0 goes first
    pass_turn(1);
    pass_sm_turn(1);
  }
  // P of the previous tile, packed: its P V runs behind this tile's Q K^T.
  // Two buffers, one tile each in turn: this tile's P is packed while the
  // previous tile's P V still reads the other (on the H100 no slower than
  // one buffer packed after the wait).
  uint32_t pa0[BKV / 16][4], pa1[BKV / 16][4];
  uint32_t prev_v = 0;
  int prev_s = 0;
  auto step = [&](int t, const uint32_t(&pa_prev)[BKV / 16][4], uint32_t(&pa_next)[BKV / 16][4]) {
    const int s = it % S;
    mbar_wait(&bar[1 + s], (it / S) & 1);
    const uint32_t k_base = kv_base + s * 2 * T::KT, v_base = k_base + T::KT;
    float sc[BKV / 2];
    fence_regs(sc);
    fence_regs(o);
    wait_turn(cw);
    wgmma_fence();
    score_product<HD, BKV>(sc, q_base, T::ROWS, k_base, BKV);  // S = Q K^T
    wgmma_commit();
    if (t > 0) grad_product<HD, BKV>(o, pa_prev, prev_v, BKV);  // O += P V, the previous tile's
    wgmma_commit();
    pass_turn(cw);
    float bc[BKV / 8][2];  // this thread's columns of the staged bias row
    if constexpr (BIAS) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(sBias + s * BKV + 8 * j + 2 * qd);
        bc[j][0] = v.x;
        bc[j][1] = v.y;
      }
    }
    wgmma_wait<1>();  // S
    fence_regs(sc);
    float alpha[2];
    wait_sm_turn(cw);
    tile_softmax<BKV, MODE, BIAS>(sc, bc, nk - t * BKV, a.c1, cs, qd, m_run, l_run, alpha);
    pass_sm_turn(cw);
    pack_a<BKV>(pa_next, sc);
    fence_regs(pa_next);
    wgmma_wait<0>();  // the previous tile's P V: its stage is free
    fence_regs(o);
    if (t > 0 && lane == 0) mbar_arrive(&bar[1 + S + prev_s]);
    if constexpr (TRACK_MAX) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    prev_v = v_base;
    prev_s = s;
    ++it;
  };
  for (int t = 0; t < ntiles; t += 2) {
    step(t, pa1, pa0);
    if (t + 1 < ntiles) step(t + 1, pa0, pa1);
  }
  if (ntiles > 0) {  // the last tile's P V: its P is in pa0 after an even tile, pa1 after an odd one
    fence_regs(o);
    wgmma_fence();
    if ((ntiles - 1) % 2 == 0) {
      grad_product<HD, BKV>(o, pa0, prev_v, BKV);
    } else {
      grad_product<HD, BKV>(o, pa1, prev_v, BKV);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(o);
  if (cw == 0) {  // warpgroup 1's last hand-overs
    wait_turn(0);
    wait_sm_turn(0);
  }

  const int warp = (tid >> 5) & 3, g = lane >> 2;
  bf16* out = static_cast<bf16*>(a.o) + b * a.o_bs + head * a.o_hs + qd * 2;
  const long long stat = ((long long)b * a.h + head) * a.nq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = q0 + cw * 64 + warp * 16 + g + 8 * h;
    if (r >= a.nq) continue;
    if constexpr (MODE == kPartial) {  // the chunk's unnormalised fp32 o, its l and m (log2 units)
      const long long pr = (long long)chunk * gridDim.z * a.h * a.nq + stat + r;
      float* po = a.part_o + pr * HD + qd * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(po + j * 8) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (qd == 0) {
        a.part_l[pr] = l;
        a.part_m[pr] = m_run[h];
      }
      continue;
    }
    // what o is divided by, and the l and m outputs
    float inv, l_out, m_out;
    if constexpr (MODE == kNoSum) {
      const float mr = m_run[h] / a.c1;  // the raw row max
      inv = mr == 0.f ? 1.f : 1.f / mr;
      l_out = mr;
      m_out = m_run[h] * (1.f / kLog2e);
    } else if constexpr (MODE == kMxu) {
      inv = 1.f;
      l_out = m_out = 0.f;
    } else if constexpr (MODE == kMxuProbe) {
      inv = 1.f;
      l_out = l;
      m_out = 0.f;
    } else {
      inv = l == 0.f ? 1.f : 1.f / l;
      l_out = l;
      m_out = MODE == kNoMax ? l * (a.c1 * (1.f / kLog2e)) : m_run[h] * (1.f / kLog2e);
    }
    bf16* row = out + (long long)r * a.o_rs;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) = pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if (qd == 0) {
      a.l[stat + r] = l_out;
      a.m[stat + r] = m_out;
    }
  }
}

// The bf16 kernel at head dim HD: one tensor map per operand (Q in boxes of
// the block's 128 rows, K and V in boxes of a KV tile), then the launch;
// kPartial's grid takes `nchunks` q-tile rows. A map takes at least one row,
// so Nk = 0 launches with no KV tile (o = 0, l = 0, m = -inf).
template <int HD, bool BIAS, int MODE>
int launch_fwd_wgmma(const AttnArgs& a, int batch, int nchunks, cudaStream_t st) {
  using T = FwdTiles<HD>;
  if (a.nq == 0 || a.h == 0 || batch == 0) return 0;
  CUtensorMap mq, mk, mv;
  const int nk_rows = a.nk > 0 ? a.nk : 1;
  cudaError_t err = operand_map(&mq, a.q, HD, a.nq, a.h, batch, a.q_rs, a.q_hs, a.q_bs, T::ROWS);
  if (err == cudaSuccess) err = operand_map(&mk, a.k, HD, nk_rows, a.h, batch, a.k_rs, a.k_hs, a.k_bs, T::BK);
  if (err == cudaSuccess) err = operand_map(&mv, a.v, HD, nk_rows, a.h, batch, a.v_rs, a.v_hs, a.v_bs, T::BK);
  if (err != cudaSuccess) return (int)err;
  auto kernel = attn_fwd_wgmma<HD, BIAS, MODE>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nq + T::ROWS - 1) / T::ROWS * nchunks, a.h, batch);
  kernel<<<grid, WG_THREADS, T::bytes, st>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

// bf16 only: fp32 takes the entries of attention_fwd_f32.cuh, which need the
// wrapper's scratch for the split K / V
template <int HD, bool BIAS>
int launch_attention_hd(const AttnArgs& a, int batch, int dtype, cudaStream_t st) {
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  return launch_fwd_wgmma<HD, BIAS, kExact>(a, batch, 1, st);
}

// A timing mode (bf16, no bias) at head dims 48 and 64, the two shapes of
// the microbenchmark, and 128, the ViT-L decoder's (the wrappers reject the
// rest); kPartial's grid takes `nchunks` q-tile rows.
template <int MODE>
int launch_attention_mode(const AttnArgs& a, int batch, int hd, int nchunks, cudaStream_t st) {
  switch (hd) {
    case 48: return launch_fwd_wgmma<48, false, MODE>(a, batch, nchunks, st);
    case 64: return launch_fwd_wgmma<64, false, MODE>(a, batch, nchunks, st);
    case 128: return launch_fwd_wgmma<128, false, MODE>(a, batch, nchunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// head dims: multiples of 16 up to 128 (the wrappers reject the rest).
// BIAS selects the unmasked (K1/K3) or the masked (K5/K6) instantiation; a
// source instantiates only the ones its entry points launch.
template <bool BIAS>
int launch_attention(const AttnArgs& a, int batch, int hd, int dtype, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_attention_hd<16, BIAS>(a, batch, dtype, st);
    case 32: return launch_attention_hd<32, BIAS>(a, batch, dtype, st);
    case 48: return launch_attention_hd<48, BIAS>(a, batch, dtype, st);
    case 64: return launch_attention_hd<64, BIAS>(a, batch, dtype, st);
    case 80: return launch_attention_hd<80, BIAS>(a, batch, dtype, st);
    case 96: return launch_attention_hd<96, BIAS>(a, batch, dtype, st);
    case 112: return launch_attention_hd<112, BIAS>(a, batch, dtype, st);
    case 128: return launch_attention_hd<128, BIAS>(a, batch, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 tile plan of head dim hd (FwdTiles): out[0..3] = q rows a block,
// KV rows a tile, ring stages and dynamic shared memory in bytes.
template <int HD>
void fwd_plan(int* out) {
  using T = FwdTiles<HD>;
  const int p[4] = {T::ROWS, T::BK, T::STAGES, (int)T::bytes};
  for (int i = 0; i < 4; ++i) out[i] = p[i];
}

// The arguments of the fused-qkv entries (K1, K5, K11): q, k and v at column
// offsets 0, D and 2D of the (B, N, 3D) projection, heads side by side in a row.
inline AttnArgs qkv_args(const void* qkv, void* o, void* l, void* m, int n, int heads, int hd,
                         int dtype, float scale) {
  const long long d = (long long)heads * hd;
  const size_t esize = dtype == kBFloat16 ? 2 : 4;
  AttnArgs a;
  a.q = qkv;
  a.k = static_cast<const char*>(qkv) + d * esize;
  a.v = static_cast<const char*>(qkv) + 2 * d * esize;
  a.q_bs = a.k_bs = a.v_bs = (long long)n * 3 * d;
  a.q_rs = a.k_rs = a.v_rs = 3 * d;
  a.q_hs = a.k_hs = a.v_hs = a.o_hs = hd;  // heads side by side in a row
  a.o = o;
  a.o_bs = (long long)n * d;
  a.o_rs = d;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = heads;
  a.nq = a.nk = n;
  a.c1 = scale * kLog2e;
  return a;
}

// The arguments of the head-major entries (K7, K7'): strides, the batch,
// head and row strides of q, k and v in elements; o a contiguous (B, H, Nq, hd).
inline AttnArgs head_major_args(const void* q, const void* k, const void* v, const long long* strides,
                                void* o, void* l, void* m, int heads, int nq, int nk, int hd, float scale) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_bs = strides[0], a.q_hs = strides[1], a.q_rs = strides[2];
  a.k_bs = strides[3], a.k_hs = strides[4], a.k_rs = strides[5];
  a.v_bs = strides[6], a.v_hs = strides[7], a.v_rs = strides[8];
  a.o = o;  // contiguous (B, H, Nq, hd)
  a.o_rs = hd;
  a.o_hs = (long long)nq * hd;
  a.o_bs = (long long)heads * nq * hd;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = heads;
  a.nq = nq;
  a.nk = nk;
  a.c1 = scale * kLog2e;
  return a;
}

}  // namespace cs
