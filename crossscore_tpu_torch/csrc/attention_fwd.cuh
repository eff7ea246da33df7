// Flash-attention forward shared by K1 and K5 (flash_qkv.cu) and K3, K6 and
// K7 (flash_cross.cu), and the timing modes K11 and K7' (below).
//
// softmax(Q K^T * scale) V for one (batch, head, q tile) per block,
// with an online softmax over 64-row KV tiles, so the Nq x Nk score matrix
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
// path reaches them:
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
//   tiles, and a linear p (noexp) cannot be rescaled by a later max, so these
//   two modes first take the exact row max in a QK-only pass over every KV
//   tile and then run the PV pass with m fixed: the TPU's function and
//   rounding, at the price of a third product (6 N^2 hd operations per head
//   against 4). Every mode but kExact sums the bf16-rounded p into l, as the
//   TPU bodies do. KV columns past Nk contribute nothing in any mode. The
//   modes run on bf16 only and take no bias.
//
// Bound on the H100: at the main-path shapes (hd 64 and 48, N >= 1369) the
// work is ~4*N*N*hd operations per head against ~N*hd*8 bytes, far above the
// card's ~295 op/byte ridge, so the tensor cores bound it. bf16 runs both
// products as mma.sync m16n8k16 (fp32 accumulators in registers, operands
// through ldmatrix, K/V double-buffered with cp.async) and keeps S, P and O
// in registers; fp32 inputs take a CUDA-core path in full fp32, because the
// tensor cores' fp32 route is TF32. Not yet used: wgmma, TMA, warp
// specialisation.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace cs {

constexpr int BQ = 64;  // q rows per block of the fp32 path (two threads per row)
constexpr int BK = 64;  // KV rows per tile
constexpr int ATTN_THREADS = 128;

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
  // kPartial: KV rows per chunk (a multiple of BK) and the chunks' partial
  // o (C, B, H, Nq, hd), l and m (C, B, H, Nq), fp32
  int kv_chunk = 0;
  float* part_o = nullptr;
  float* part_l = nullptr;
  float* part_m = nullptr;
};

// the score-epilogue modes of attn_fwd_bf16 (see the top of this file)
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

// bf16 tiling: MW 16-row m-atoms per warp (two when hd <= 64, so every K and
// V fragment loaded from shared memory feeds two products), 4 warps, so a
// block takes 64 * MW q rows.
template <int HD>
struct BfLayout {
  static constexpr int MW = HD <= 64 ? 2 : 1;
  static constexpr int ROWS = 64 * MW;  // q rows per block
  static constexpr int LD = HD + 8;     // padded rows: ldmatrix without bank conflicts
  static constexpr size_t tile = align128((size_t)BK * LD * 2);
  static constexpr size_t kv_off = align128((size_t)ROWS * LD * 2);
  static constexpr size_t total = kv_off + 4 * tile;  // K and V, two stages
};

// S = Q K^T for the MW m-atoms of this warp over one BK-row K tile in shared
// memory (row stride LD): fp32 accumulators, K fragments through ldmatrix.
template <int HD, int MW, int LD>
__device__ __forceinline__ void qk_scores(float (&s)[MW][BK / 8][4], const uint32_t (&qa)[MW][HD / 16][4],
                                          const __nv_bfloat16* sK, int lane) {
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bb[4];
      ldsm_b_nk_x2tiles(bb, sK + np * 16 * LD + kk * 16, LD, lane);
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        mma_bf16(s[mi][2 * np], qa[mi][kk], bb[0], bb[1]);
        mma_bf16(s[mi][2 * np + 1], qa[mi][kk], bb[2], bb[3]);
      }
    }
  }
}

// bf16: Q fragments stay in registers; K/V tiles stream through shared
// memory (cp.async, two stages). S = Q K^T and O += P V run as mma.sync
// m16n8k16 with fp32 accumulators in registers, and P is rounded to bf16
// straight from the S accumulators into A fragments.
template <int HD, bool BIAS, int MODE = kExact>
__global__ void __launch_bounds__(ATTN_THREADS) attn_fwd_bf16(AttnArgs a) {
  static_assert(MODE == kExact || !BIAS, "the timing modes take no bias");
  using L = BfLayout<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int MW = L::MW;
  constexpr int NKT = HD / 16;  // k-steps of Q K^T
  constexpr int NOT = HD / 8;   // n8 tiles of O
  constexpr int NST = BK / 8;   // n8 tiles of S
  constexpr int TILE = (int)(L::tile / 2);  // elements per K or V tile
  // modes that keep an online row max (and rescale o by it), and that sum l
  constexpr bool TRACK_MAX = MODE == kExact || MODE == kNoSum || MODE == kPartial;
  constexpr bool FIXED_MAX = MODE == kNoExp || MODE == kBf16Exp;
  constexpr bool HAS_L = MODE != kNoSum && MODE != kMxu;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = reinterpret_cast<bf16*>(smem + L::kv_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  // kPartial: blockIdx.x = chunk * (q tiles) + q tile; the block sees KV
  // rows [kv0, kv0 + nk) only
  int qblk = blockIdx.x, nk = a.nk, chunk = 0;
  long long kv0 = 0;
  if constexpr (MODE == kPartial) {
    const int nqt = (a.nq + L::ROWS - 1) / L::ROWS;
    chunk = blockIdx.x / nqt;
    qblk = blockIdx.x - chunk * nqt;
    kv0 = (long long)chunk * a.kv_chunk;
    nk = min(a.kv_chunk, a.nk - (int)kv0);
  }
  const int q0 = qblk * L::ROWS, head = blockIdx.y, b = blockIdx.z;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_bs + head * a.q_hs;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_bs + head * a.k_hs + kv0 * a.k_rs;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_bs + head * a.v_hs + kv0 * a.v_rs;
  const float* bias = BIAS ? a.bias + b * a.bias_bs : nullptr;
  // with a bias the scores are scaled (and biased) in place, so the softmax
  // below runs at scale 1; without one it folds c1 into its FMAs
  const float cs = BIAS ? 1.f : a.c1;

  cp_async_rows<L::ROWS, HD, ATTN_THREADS>(sQ, L::LD, Q, a.q_rs, q0, a.nq, tid);
  cp_async_rows<BK, HD, ATTN_THREADS>(sKV, L::LD, K, a.k_rs, 0, nk, tid);
  cp_async_rows<BK, HD, ATTN_THREADS>(sKV + TILE, L::LD, V, a.v_rs, 0, nk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[MW][NKT][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk)
      ldsm_a(qa[mi][kk], sQ + (warp * MW + mi) * 16 * L::LD + kk * 16, L::LD, lane);

  float o[MW][NOT][4];
  float m_run[MW][2], l_run[MW][2];  // rows g and g + 8 of each m-atom
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int d = 0; d < NOT; ++d) o[mi][d][0] = o[mi][d][1] = o[mi][d][2] = o[mi][d][3] = 0.f;
    m_run[mi][0] = m_run[mi][1] = -INFINITY;
    l_run[mi][0] = l_run[mi][1] = 0.f;
  }

  const int ntiles = (nk + BK - 1) / BK;
  if constexpr (FIXED_MAX) {
    // the exact row max of the scaled scores, from a QK-only pass through
    // the second stage's K slot (the first keeps tile 0 for the PV pass)
    bf16* sK1 = sKV + 2 * TILE;
    float mx[MW][2];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) mx[mi][0] = mx[mi][1] = -INFINITY;
    for (int t = 0; t < ntiles; ++t) {
      cp_async_rows<BK, HD, ATTN_THREADS>(sK1, L::LD, K, a.k_rs, t * BK, nk, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float s[MW][NST][4];
      qk_scores<HD, MW, L::LD>(s, qa, sK1, lane);
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int j = 0; j < NST; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (t * BK + j * 8 + qd * 2 + e < nk) {
              mx[mi][0] = fmaxf(mx[mi][0], s[mi][j][e]);
              mx[mi][1] = fmaxf(mx[mi][1], s[mi][j][2 + e]);
            }
      __syncthreads();  // sK1 is refilled next tile
    }
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[mi][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        m_run[mi][h] = v * cs;
      }
  }

  for (int t = 0; t < ntiles; ++t) {
    const bf16* sK = sKV + (t & 1) * 2 * TILE;
    const bf16* sV = sK + TILE;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other stage
      bf16* nK = sKV + ((t + 1) & 1) * 2 * TILE;
      cp_async_rows<BK, HD, ATTN_THREADS>(nK, L::LD, K, a.k_rs, (t + 1) * BK, nk, tid);
      cp_async_rows<BK, HD, ATTN_THREADS>(nK + TILE, L::LD, V, a.v_rs, (t + 1) * BK, nk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[MW][NST][4];
    qk_scores<HD, MW, L::LD>(s, qa, sK, lane);

    // bias, then mask the KV tail; online softmax in fp32, exp2 base (scale
    // folded into the FMA unless the bias pass applied it)
    float bcol[NST][2];
    if constexpr (BIAS) {
#pragma unroll
      for (int j = 0; j < NST; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t * BK + j * 8 + qd * 2 + e;
          bcol[j][e] = col < nk ? __ldg(bias + col) * kLog2e : 0.f;
        }
    }
    uint32_t pa[MW][BK / 16][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NST; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = t * BK + j * 8 + qd * 2 + e < nk;
          if constexpr (BIAS) {
            s[mi][j][e] = fmaf(s[mi][j][e], a.c1, bcol[j][e]);
            s[mi][j][2 + e] = fmaf(s[mi][j][2 + e], a.c1, bcol[j][e]);
          }
          s[mi][j][e] = ok ? s[mi][j][e] : -INFINITY;
          s[mi][j][2 + e] = ok ? s[mi][j][2 + e] : -INFINITY;
          mx0 = fmaxf(mx0, s[mi][j][e]);
          mx1 = fmaxf(mx1, s[mi][j][2 + e]);
        }
      }
      // al: the rescale of the earlier tiles; sh: this tile's exponent shift
      float al0 = 1.f, al1 = 1.f, sh0, sh1;
      if constexpr (TRACK_MAX) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // running maxima in scaled units (c1 > 0, so scaling keeps the max)
        const float mn0 = fmaxf(m_run[mi][0], mx0 * cs), mn1 = fmaxf(m_run[mi][1], mx1 * cs);
        al0 = ex2(m_run[mi][0] - mn0);
        al1 = ex2(m_run[mi][1] - mn1);
        m_run[mi][0] = sh0 = mn0;
        m_run[mi][1] = sh1 = mn1;
      } else if constexpr (MODE == kNoMax) {
        sh0 = sh1 = 8.f;  // the TPU probe's constant shift in place of the row max
      } else {
        sh0 = m_run[mi][0];  // FIXED_MAX: the exact row max (unused by the MXU modes)
        sh1 = m_run[mi][1];
      }
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NST; ++j) {
        float p[4];
        if constexpr (MODE == kBf16Exp) {
          const int col = t * BK + j * 8 + qd * 2;
          const float2 p01 = bf16_exp2_pair(s[mi][j][0], s[mi][j][1], cs, sh0, col < nk, col + 1 < nk);
          const float2 p23 = bf16_exp2_pair(s[mi][j][2], s[mi][j][3], cs, sh1, col < nk, col + 1 < nk);
          p[0] = p01.x, p[1] = p01.y, p[2] = p23.x, p[3] = p23.y;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = t * BK + j * 8 + qd * 2 + e < nk;
            p[e] = score_to_p<MODE>(s[mi][j][e], cs, sh0, ok);
            p[2 + e] = score_to_p<MODE>(s[mi][j][2 + e], cs, sh1, ok);
          }
        }
        const uint32_t w0 = pack_bf16(p[0], p[1]), w1 = pack_bf16(p[2], p[3]);
        pa[mi][j / 2][(j % 2) * 2] = w0;
        pa[mi][j / 2][(j % 2) * 2 + 1] = w1;
        if constexpr (MODE == kExact) {
          rs0 += p[0] + p[1];
          rs1 += p[2] + p[3];
        } else if constexpr (HAS_L) {  // l sums the bf16 p that P V multiplies, as the TPU bodies do
          rs0 += __uint_as_float(w0 << 16) + __uint_as_float(w0 & 0xffff0000u);
          rs1 += __uint_as_float(w1 << 16) + __uint_as_float(w1 & 0xffff0000u);
        }
      }
      if constexpr (HAS_L) {
        l_run[mi][0] = l_run[mi][0] * al0 + rs0;
        l_run[mi][1] = l_run[mi][1] * al1 + rs1;
      }
      if constexpr (TRACK_MAX) {
#pragma unroll
        for (int d = 0; d < NOT; ++d) {
          o[mi][d][0] *= al0;
          o[mi][d][1] *= al0;
          o[mi][d][2] *= al1;
          o[mi][d][3] *= al1;
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
      for (int dp = 0; dp < NOT / 2; ++dp) {
        uint32_t bb[4];
        ldsm_b_kn_x2tiles(bb, sV + ks * 16 * L::LD + dp * 16, L::LD, lane);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma_bf16(o[mi][2 * dp], pa[mi][ks], bb[0], bb[1]);
          mma_bf16(o[mi][2 * dp + 1], pa[mi][ks], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  bf16* out = static_cast<bf16*>(a.o) + b * a.o_bs + head * a.o_hs + qd * 2;
  const long long stat = ((long long)b * a.h + head) * a.nq;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[mi][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = q0 + (warp * MW + mi) * 16 + g + 8 * h;
      if (r >= a.nq) continue;
      if constexpr (MODE == kPartial) {  // the chunk's unnormalised fp32 o, its l and m (log2 units)
        const long long pr = (long long)chunk * gridDim.z * a.h * a.nq + stat + r;
        float* po = a.part_o + pr * HD + qd * 2;
#pragma unroll
        for (int d = 0; d < NOT; ++d)
          *reinterpret_cast<float2*>(po + d * 8) = make_float2(o[mi][d][2 * h], o[mi][d][2 * h + 1]);
        if (qd == 0) {
          a.part_l[pr] = l;
          a.part_m[pr] = m_run[mi][h];
        }
        continue;
      }
      // what o is divided by, and the l and m outputs
      float inv, l_out, m_out;
      if constexpr (MODE == kNoSum) {
        const float mr = m_run[mi][h] / a.c1;  // the raw row max
        inv = mr == 0.f ? 1.f : 1.f / mr;
        l_out = mr;
        m_out = m_run[mi][h] * (1.f / kLog2e);
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
        m_out = MODE == kNoMax ? l * (a.c1 * (1.f / kLog2e)) : m_run[mi][h] * (1.f / kLog2e);
      }
#pragma unroll
      for (int d = 0; d < NOT; ++d)
        *reinterpret_cast<uint32_t*>(out + r * a.o_rs + d * 8) =
            pack_bf16(o[mi][d][2 * h] * inv, o[mi][d][2 * h + 1] * inv);
      if (qd == 0) {
        a.l[stat + r] = l_out;
        a.m[stat + r] = m_out;
      }
    }
  }
}

template <int HD>
struct F32Layout {
  static constexpr int LD = HD + 4;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(BK * LD * 4);
  static constexpr size_t s_off = align128(v_off + BK * LD * 4);
  static constexpr size_t total = align128(s_off + BQ * (BK + 1) * 4);
};

// fp32: CUDA cores only. Two threads per q row, each holding half of the
// row's q and o in registers; K/V tiles and the row's scores in shared memory.
template <int HD, bool BIAS>
__global__ void __launch_bounds__(ATTN_THREADS) attn_fwd_f32(AttnArgs a) {
  using L = F32Layout<HD>;
  constexpr int HH = HD / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::k_off);
  float* sV = reinterpret_cast<float*>(smem + L::v_off);
  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  float* srow = reinterpret_cast<float*>(smem + L::s_off) + row * (BK + 1);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const float* Q = static_cast<const float*>(a.q) + b * a.q_bs + head * a.q_hs;
  const float* K = static_cast<const float*>(a.k) + b * a.k_bs + head * a.k_hs;
  const float* V = static_cast<const float*>(a.v) + b * a.v_bs + head * a.v_hs;
  const float* bias = BIAS ? a.bias + b * a.bias_bs : nullptr;

  const int qrow = q0 + row;
  float q[HH], o[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) {
    q[d] = qrow < a.nq ? Q[qrow * a.q_rs + half * HH + d] : 0.f;
    o[d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < a.nk; k0 += BK) {
    __syncthreads();
    load_rows<BK, HD>(sK, L::LD, K, a.k_rs, k0, a.nk, tid, ATTN_THREADS);
    load_rows<BK, HD>(sV, L::LD, V, a.v_rs, k0, a.nk, tid, ATTN_THREADS);
    __syncthreads();
    const int kvalid = min(BK, a.nk - k0);
    float mx = -INFINITY;
    for (int j = 0; j < kvalid; ++j) {
      const float* kr = sK + j * L::LD + half * HH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HH; ++d) s = fmaf(q[d], kr[d], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      const float t = BIAS ? fmaf(s, a.c1, __ldg(bias + k0 + j) * kLog2e) : s * a.c1;
      if (half == 0) srow[j] = t;
      mx = fmaxf(mx, t);
    }
    __syncwarp();
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
#pragma unroll
    for (int d = 0; d < HH; ++d) o[d] *= alpha;
    float sum = 0.f;
    for (int j = 0; j < kvalid; ++j) {
      const float p = exp2f(srow[j] - m_new);
      sum += p;
      const float* vr = sV + j * L::LD + half * HH;
#pragma unroll
      for (int d = 0; d < HH; ++d) o[d] = fmaf(p, vr[d], o[d]);
    }
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();
  }

  if (qrow < a.nq) {
    const float inv = l_run == 0.f ? 1.f : 1.f / l_run;
    float* out = static_cast<float*>(a.o) + b * a.o_bs + qrow * a.o_rs + head * a.o_hs + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) out[d] = o[d] * inv;
    if (half == 0) {
      const long long i = ((long long)b * a.h + head) * a.nq + qrow;
      a.l[i] = l_run;
      a.m[i] = m_run * (1.f / kLog2e);
    }
  }
}

template <int HD, bool BIAS>
int launch_attention_hd(const AttnArgs& a, int batch, int dtype, cudaStream_t st) {
  const int rows = dtype == kBFloat16 ? BfLayout<HD>::ROWS : BQ;
  const dim3 grid((a.nq + rows - 1) / rows, a.h, batch);
  cudaError_t err;
  if (dtype == kBFloat16) {
    const int bytes = (int)BfLayout<HD>::total;
    err = cudaFuncSetAttribute(attn_fwd_bf16<HD, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attn_fwd_bf16<HD, BIAS><<<grid, ATTN_THREADS, bytes, st>>>(a);
  } else {
    const int bytes = (int)F32Layout<HD>::total;
    err = cudaFuncSetAttribute(attn_fwd_f32<HD, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attn_fwd_f32<HD, BIAS><<<grid, ATTN_THREADS, bytes, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// A timing mode (bf16, no bias) at head dims 48 and 64, the two shapes of
// the microbenchmark (the wrappers reject the rest); kPartial's grid takes
// `nchunks` q-tile rows.
template <int HD, int MODE>
int launch_attention_mode_hd(const AttnArgs& a, int batch, int nchunks, cudaStream_t st) {
  using L = BfLayout<HD>;
  const dim3 grid((a.nq + L::ROWS - 1) / L::ROWS * (MODE == kPartial ? nchunks : 1), a.h, batch);
  const int bytes = (int)L::total;
  const cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_bf16<HD, false, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_bf16<HD, false, MODE><<<grid, ATTN_THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_attention_mode(const AttnArgs& a, int batch, int hd, int nchunks, cudaStream_t st) {
  switch (hd) {
    case 48: return launch_attention_mode_hd<48, MODE>(a, batch, nchunks, st);
    case 64: return launch_attention_mode_hd<64, MODE>(a, batch, nchunks, st);
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

}  // namespace cs
