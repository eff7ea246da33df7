// The fp32 flash-attention forward of K1 and K5 (flash_qkv.cu) and K3, K6
// and K7 (flash_cross.cu), on Hopper's tensor cores in 3xTF32.
//
// The function is attention_fwd.cuh's: softmax(Q K^T * scale [+ bias]) V for
// one (batch, head, q tile) per block with an online softmax over KV tiles;
// o in fp32, l and m in (B, H, Nq) fp32 (m in natural units); Nk = 0 gives o
// = 0, l = 0, m = -inf. It replaces the same TPU kernels of
// crossscore_tpu/ops/flash_attention.py on fp32 inputs: `_fwd_kernel_qkv`
// (:1347, K1), `_fwd_kernel_qkv_biased` (:1227, K5), `_fwd_kernel_cross_ln`
// (:799, K3 and, with `per_item`, K6) and `_flash_fwd`'s bodies (:69, :118,
// :186, :231; K7). Operands are addressed by batch, head and row strides
// with the hd columns of a row contiguous, as the bf16 entries take them.
//
// Precision. The tensor cores' fp32 route is TF32, a 10-bit mantissa: one
// TF32 product keeps ~11 bits. Each fp32 operand x is split into hi =
// rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32: nearest, ties away from
// zero; a tf32 wgmma ignores the container's low 13 bits, which would
// truncate), and each product is lo*hi' + hi*lo' + hi*hi' into fp32
// accumulators. The dropped lo*lo' is ~2^-22 relative: fp32-level error, so
// the fp32 tolerances of the CUDA-core kernel this replaces hold unchanged.
//
// Bound on the H100 (SXM, 700 W): per head, three TF32 products of 4 Nq Nk hd
// operations at 495 TFLOP/s, against Nq Nk exponentials at ~3.9 T/s and
// (2 Nq + 2 Nk) hd * 4 bytes at 3.35 TB/s. The products bind, at hd 64 six
// times the exponentials' floor; the CUDA cores' floor (one fp32 product at
// 67 TFLOP/s) is 2.5 times the 3xTF32 floor.
//
// Design:
// - a pre-pass (attn_fwd_split_kv<HD>), once a call: K as (hi, lo) and V
//   transposed as (hi, lo), each KV tile written as one stage of the body's
//   ring, 128-byte swizzled, its padding zero. A tf32 wgmma takes B K-major
//   only (there is no transpose flag for tf32), and P V contracts over the
//   keys while V lies hd-contiguous, so V's tile is stored key-contiguous (Vt:
//   hd rows of BK keys). Every KV tile is read by every q block of its head
//   (11 at N 1370), so the split and the transpose are done once, not once a
//   block; the pre-pass moves 3 fp32 copies of K and V (~0.9 GB at K1's main
//   shape);
// - the body (attn_fwd_tf32<HD, BIAS>; the bf16 body's block of a producer
//   warpgroup and two consumer warpgroups, of which one consumes at hd 112
//   and 128 and the other idles): one producer warp loads each stage
//   with one bulk copy into a ring of mbarrier stages (K5/K6/K7: and the
//   tile's bias row, by the warp's 32 lanes); NCW consumer warpgroups of 64
//   q rows load their rows of Q and split them into hi and lo, the resident
//   A operand of S: in registers up to hd 64 (wgmma rs), in shared memory
//   above (ss), and run S = Q K^T (m64n{BK}k8, three a k8 step) and
//   O += P V (wgmma rs, m64n{HD}k8, three a k8 step) with P split from the
//   S accumulators into A registers. The rs score product reads a third
//   less shared memory a product and frees Q's 64 KB for a third ring stage
//   at hd 64 (PERF.md has both forms' times on the H100);
// - the tf32 A registers of a k8 step hold columns q and q + 4 in the thread
//   whose accumulators hold columns 2q and 2q + 1, so a k8 step of P takes
//   its keys in the order (0, 2, 4, 6, 1, 3, 5, 7) (tf32_pair_key), and the
//   pre-pass stores Vt's keys in that order within each 8;
// - as the bf16 body: the previous tile's P V is issued behind this tile's
//   Q K^T and waited for in the same iteration (nothing in flight across the
//   loop's back edge), the two consumer warpgroups take turns on the tensor
//   cores and on the softmax, and the softmax is tile_softmax's (exp2 with
//   c1 folded in, the bias first, -inf past Nk). P is split after the
//   previous P V's wait, into one register buffer. Each tile's P V starts a
//   fresh accumulator, added to o on the CUDA cores (the tensor cores'
//   accumulation over a whole KV row lost fp32's bound at long rows).
// The plan (F32Tiles): shared memory holds Q's hi and lo above hd 64 (128
// rows, 64 at hd 112-128 where one consumer warpgroup runs) and at least two
// stages; hd is padded to 32-column blocks in Q and K (never read by a
// product).
#pragma once

#include "attention_fwd.cuh"

namespace cs {

// the tf32 container nearest to x, ties away from zero: the low 13 mantissa
// bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative: hi = rna(x), lo = rna(x - hi), lo = 0
// where hi is not finite (inf, nan, or a finite x that rounds past the
// largest float)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = (hi & 0x7f800000u) != 0x7f800000u ? tf32_rna(x - __uint_as_float(hi)) : 0u;
}

// the key (0-7 of a k8 step) that the tf32 A column c takes when the A
// registers come from an accumulator pair (columns 2q, 2q + 1)
__host__ __device__ constexpr int tf32_pair_key(int c) { return c < 4 ? 2 * c : 2 * c - 7; }

// The fp32 tile plan of head dim HD. Q and K rows are hd padded to CB
// 32-column SW128 blocks; a stage is [K hi | K lo | Vt hi | Vt lo], Vt as
// BK / 32 blocks of HD rows of 32 keys. A consumer holds S (BK/2 fp32
// registers), O and a tile's P V (HD/2 each), P split (BK) and up to hd 64
// Q split (HD): 3 BK / 2 + 2 HD, 224 at hd 64, of its 240.
template <int HD>
struct F32Tiles {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  static constexpr int CB = (HD + 31) / 32;
  static constexpr int NCW = HD <= 96 ? 2 : 1;  // consumer warpgroups (of the block's two)
  static constexpr int ROWS = 64 * NCW;         // q rows a block
  static constexpr int BK = HD <= 64 ? 64 : 32;  // KV rows a tile
  // Q's hi and lo as A registers (HD of them) where they fit, else in
  // shared memory: the rs score product reads a third less shared memory
  static constexpr bool QREG = HD <= 64;
  static constexpr uint32_t QB = QREG ? 0 : CB * ROWS * 128;  // Q hi (then Q lo)
  static constexpr uint32_t KT = CB * BK * 128;    // K hi or lo of a tile
  static constexpr uint32_t VT = HD * BK * 4;      // Vt hi or lo of a tile
  static constexpr uint32_t TILE = 2 * KT + 2 * VT;
  static constexpr int FIT = (232448 - 2 * (int)QB - 1024 - 128) / ((int)TILE + BK * 4);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "two ring stages at least");
  static constexpr uint32_t ring_off = 2 * QB;
  static constexpr uint32_t bias_off = ring_off + STAGES * TILE;  // stage s: BK fp32 at bias_off + s*BK*4
  static constexpr uint32_t bar_off = bias_off + STAGES * BK * 4;
  static constexpr uint32_t bytes = bar_off + 2 * STAGES * 8 + 1024;  // + alignment slack
};

// The pre-pass: tile blockIdx.x of head blockIdx.y of batch item blockIdx.z
// of K and V into its stage at `tiles` (rows past Nk zero).
template <int HD>
__global__ void __launch_bounds__(256) attn_fwd_split_kv(const AttnArgs a, float* tiles) {
  using T = F32Tiles<HD>;
  constexpr int BKV = T::BK, LK = HD + 4, LV = HD + 1;
  __shared__ __align__(16) float sK[BKV * LK];
  __shared__ float sV[BKV * LV];
  const int t = blockIdx.x, head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const float* K = static_cast<const float*>(a.k) + b * a.k_bs + head * a.k_hs;
  const float* V = static_cast<const float*>(a.v) + b * a.v_bs + head * a.v_hs;
  for (int i = tid; i < BKV * HD / 4; i += 256) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, row = t * BKV + r;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (row < a.nk) {
      kv = *reinterpret_cast<const float4*>(K + row * a.k_rs + c);
      vv = *reinterpret_cast<const float4*>(V + row * a.v_rs + c);
    }
    *reinterpret_cast<float4*>(sK + r * LK + c) = kv;
    float* sv = sV + r * LV + c;
    sv[0] = vv.x, sv[1] = vv.y, sv[2] = vv.z, sv[3] = vv.w;
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(tiles + (((long long)b * gridDim.y + head) * gridDim.x + t) * (T::TILE / 4));
  for (int i = tid; i < (int)(T::TILE / 16); i += 256) {
    const uint32_t byte = i * 16;
    float x[4];
    bool low;
    if (byte < 2 * T::KT) {  // K: row r, columns c0..c0+3 in the 16-byte chunk's swizzled place
      low = byte >= T::KT;
      const uint32_t o = byte - (low ? T::KT : 0);
      const int blk = o / (BKV * 128), r = (o / 128) % BKV, ch = (o / 16) % 8;
      const int c0 = blk * 32 + ((ch ^ (r & 7)) << 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = c0 < HD ? sK[r * LK + c0 + e] : 0.f;
    } else {  // Vt: hd row n, four key positions of a 32-key block, keys paired as the A registers take them
      const uint32_t ov = byte - 2 * T::KT;
      low = ov >= T::VT;
      const uint32_t o = ov - (low ? T::VT : 0);
      const int blk = o / (HD * 128), n = (o / 128) % HD, ch = (o / 16) % 8;
      const int p0 = (ch ^ (n & 7)) << 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + e, key = blk * 32 + (p & ~7) + tf32_pair_key(p & 7);
        x[e] = sV[key * LV + n];
      }
    }
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      tf32_split(x[e], hi, lo);
      w[e] = low ? lo : hi;
    }
    out[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// S = Q K^T over hd in 3xTF32: A the warpgroup's 64 resident rows of Q hi
// and lo (a_rows per column block), B a stage's K hi and lo (b_rows)
template <int HD, int N>
__device__ __forceinline__ void score_product_tf32x3(float (&acc)[N / 2], uint32_t a_hi, uint32_t a_lo, int a_rows,
                                                     uint32_t b_hi, uint32_t b_lo, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint32_t kin = (kk % 4) * 32, cb = kk / 4;
    const uint32_t ao = cb * a_rows * 128 + kin, bo = cb * b_rows * 128 + kin;
    WgmmaTf32<N>::ss(acc, sw128_desc_at(a_lo + ao, 16), sw128_desc_at(b_hi + bo, 16), kk > 0);
    WgmmaTf32<N>::ss(acc, sw128_desc_at(a_hi + ao, 16), sw128_desc_at(b_lo + bo, 16), 1);
    WgmmaTf32<N>::ss(acc, sw128_desc_at(a_hi + ao, 16), sw128_desc_at(b_hi + bo, 16), 1);
  }
}

// acc = P V over the K keys of a stage in 3xTF32 (acc overwritten): P's hi
// and lo A registers, B the stage's Vt hi and lo (K / 32 blocks of HD rows)
template <int HD, int K>
__device__ __forceinline__ void pv_product_tf32x3(float (&acc)[HD / 2], const uint32_t (&phi)[K / 8][4],
                                                  const uint32_t (&plo)[K / 8][4], uint32_t v_hi, uint32_t v_lo) {
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    const uint32_t off = (ks / 4) * HD * 128 + (ks % 4) * 32;
    WgmmaTf32<HD>::rs(acc, plo[ks], sw128_desc_at(v_hi + off, 16), ks > 0);
    WgmmaTf32<HD>::rs(acc, phi[ks], sw128_desc_at(v_lo + off, 16), 1);
    WgmmaTf32<HD>::rs(acc, phi[ks], sw128_desc_at(v_hi + off, 16), 1);
  }
}

// an accumulator tile's p (finite, in [0, 1]) split into the hi and lo A
// registers of its k8 steps: step j takes keys 8j + tf32_pair_key(c)
template <int N>
__device__ __forceinline__ void split_a(uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4], const float (&v)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int src[4] = {4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3};  // (g, 2q), (g + 8, 2q), (g, 2q + 1), (g + 8, 2q + 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[j][e] = tf32_rna(v[src[e]]);
      lo[j][e] = tf32_rna(v[src[e]] - __uint_as_float(hi[j][e]));
    }
  }
}

// fp32 on Hopper's tensor cores (see the top of this file). Grid: (q tiles,
// heads, batch); a.kv_tiles the pre-pass's stages of this call's K and V.
template <int HD, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS, 1) attn_fwd_tf32(const AttnArgs a) {
  using T = F32Tiles<HD>;
  constexpr int BKV = T::BK, S = T::STAGES, NCW = T::NCW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sQ = smem;  // Q hi, then Q lo at QB
  unsigned char* ring = smem + T::ring_off;
  float* sBias = reinterpret_cast<float*>(smem + T::bias_off);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + T::bar_off);  // bar[s] stage s full, bar[S + s] empty
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q0 = blockIdx.x * T::ROWS, head = blockIdx.y, b = blockIdx.z;
  const int nk = a.nk, ntiles = (nk + BKV - 1) / BKV;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&bar[s], BIAS ? 33 : 1);  // the bulk copy's bytes (with a bias, then the producer warp's 32 lanes)
      mbar_init(&bar[S + s], 4 * NCW);    // the consumers' warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0 || wg > NCW) {  // the producer; with one consumer warpgroup, warpgroup 2 idles
    setmaxnreg_dec<PRODUCER_REGS>();
    if (wg > NCW || (BIAS ? tid >= 32 : tid != 0)) return;
    const unsigned char* src =
        static_cast<const unsigned char*>(a.kv_tiles) + ((long long)b * a.h + head) * ntiles * T::TILE;
    const float* bias = BIAS ? a.bias + b * a.bias_bs : nullptr;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      if (t >= S) mbar_wait(&bar[S + s], (t / S - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&bar[s], T::TILE);
        bulk_load(ring + s * T::TILE, src + (long long)t * T::TILE, T::TILE, &bar[s]);
      }
      if constexpr (BIAS) {  // the tile's bias row in log2 units, 0 past Nk
        float* sb = sBias + s * BKV;
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i) {
          const int col = t * BKV + lane + 32 * i;
          sb[lane + 32 * i] = col < nk ? __ldg(bias + col) * kLog2e : 0.f;
        }
        mbar_arrive(&bar[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, qd = lane & 3;
  const float* Q = static_cast<const float*>(a.q) + b * a.q_bs + head * a.q_hs;
  uint32_t qa_hi[T::QREG ? HD / 8 : 1][4], qa_lo[T::QREG ? HD / 8 : 1][4];  // QREG: Q's A registers
  if constexpr (T::QREG) {  // rows g and g + 8 of this thread's warp, columns q and q + 4 of each k8 step
    const int r0 = q0 + cw * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int c = 8 * kk + qd;
      tf32_split(r0 < a.nq ? Q[r0 * a.q_rs + c] : 0.f, qa_hi[kk][0], qa_lo[kk][0]);
      tf32_split(r1 < a.nq ? Q[r1 * a.q_rs + c] : 0.f, qa_hi[kk][1], qa_lo[kk][1]);
      tf32_split(r0 < a.nq ? Q[r0 * a.q_rs + c + 4] : 0.f, qa_hi[kk][2], qa_lo[kk][2]);
      tf32_split(r1 < a.nq ? Q[r1 * a.q_rs + c + 4] : 0.f, qa_hi[kk][3], qa_lo[kk][3]);
    }
  } else {  // this warpgroup's 64 rows of Q, split, in the K-major swizzled layout (zeros past Nq)
    for (int i = tid - wg * 128; i < 64 * HD / 4; i += 128) {
      const int r = cw * 64 + i / (HD / 4), c = (i % (HD / 4)) * 4, row = q0 + r;
      const float4 v = row < a.nq ? *reinterpret_cast<const float4*>(Q + row * a.q_rs + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t off = (c >> 5) * T::ROWS * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4);
      uint4 hi, lo;
      tf32_split(v.x, hi.x, lo.x);
      tf32_split(v.y, hi.y, lo.y);
      tf32_split(v.z, hi.z, lo.z);
      tf32_split(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(sQ + off) = hi;
      *reinterpret_cast<uint4*>(sQ + T::QB + off) = lo;
    }
    fence_async_shared();  // the generic stores, visible to wgmma
    asm volatile("bar.sync %0, 128;\n" ::"r"(6 + cw) : "memory");
  }
  const uint32_t q_hi = smem_addr(sQ) + cw * 64 * 128, q_lo = q_hi + T::QB, ring_base = smem_addr(ring);
  // with a bias the scores are scaled and biased in place once S has
  // arrived (the bias row read then, so that it holds no registers across
  // the products), and the softmax runs at scale 1; without one it folds c1
  // into its FMAs
  const float cs = BIAS ? 1.f : a.c1;
  // o: the tiles so far, summed on the CUDA cores; pv: one tile's P V from
  // the tensor cores. Their accumulators keep a chain of one tile's products
  // only: summed over every key of a long KV row (Nk 10952) they read ~7e-5
  // of o's relative L2 off fp32 (PERF.md).
  float o[HD / 2], pv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  if (NCW == 2 && cw == 1) {  // warpgroup 0 goes first
    pass_turn(1);
    pass_sm_turn(1);
  }
  uint32_t phi[BKV / 8][4], plo[BKV / 8][4];  // the previous tile's P, split
  uint32_t prev_v = 0;
  int prev_s = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % S;
    mbar_wait(&bar[s], (t / S) & 1);
    const uint32_t k_base = ring_base + s * T::TILE, v_base = k_base + 2 * T::KT;
    float sc[BKV / 2];
    fence_regs(sc);
    fence_regs(pv);
    if constexpr (NCW == 2) wait_turn(cw);
    wgmma_fence();
    if constexpr (T::QREG) {  // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t bo = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        WgmmaTf32<BKV>::rs(sc, qa_lo[kk], sw128_desc_at(k_base + bo, 16), kk > 0);
        WgmmaTf32<BKV>::rs(sc, qa_hi[kk], sw128_desc_at(k_base + T::KT + bo, 16), 1);
        WgmmaTf32<BKV>::rs(sc, qa_hi[kk], sw128_desc_at(k_base + bo, 16), 1);
      }
    } else {
      score_product_tf32x3<HD, BKV>(sc, q_hi, q_lo, T::ROWS, k_base, k_base + T::KT, BKV);
    }
    wgmma_commit();
    if (t > 0) pv_product_tf32x3<HD, BKV>(pv, phi, plo, prev_v, prev_v + T::VT);  // P V, the previous tile's
    wgmma_commit();
    if constexpr (NCW == 2) pass_turn(cw);
    wgmma_wait<1>();  // S
    fence_regs(sc);
    if constexpr (BIAS) {  // s * c1 + this thread's columns of the staged bias row
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(sBias + s * BKV + 8 * j + 2 * qd);
        sc[4 * j] = fmaf(sc[4 * j], a.c1, v.x);
        sc[4 * j + 1] = fmaf(sc[4 * j + 1], a.c1, v.y);
        sc[4 * j + 2] = fmaf(sc[4 * j + 2], a.c1, v.x);
        sc[4 * j + 3] = fmaf(sc[4 * j + 3], a.c1, v.y);
      }
    }
    float alpha[2], no_bias[BKV / 8][2];  // tile_softmax's bias operand, unused
    if constexpr (NCW == 2) wait_sm_turn(cw);
    tile_softmax<BKV, kExact, false>(sc, no_bias, nk - t * BKV, a.c1, cs, qd, m_run, l_run, alpha);
    if constexpr (NCW == 2) pass_sm_turn(cw);
    wgmma_wait<0>();  // the previous tile's P V: its stage and P's registers are free
    fence_regs(pv);
    fence_regs(phi);
    fence_regs(plo);
    if (t > 0) {
      if (lane == 0) mbar_arrive(&bar[S + prev_s]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] += pv[i];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    split_a<BKV>(phi, plo, sc);
    fence_regs(phi);
    fence_regs(plo);
    prev_v = v_base;
    prev_s = s;
  }
  if (ntiles > 0) {  // the last tile's P V
    fence_regs(pv);
    wgmma_fence();
    pv_product_tf32x3<HD, BKV>(pv, phi, plo, prev_v, prev_v + T::VT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] += pv[i];
  }
  if (NCW == 2 && cw == 0) {  // warpgroup 1's last hand-overs
    wait_turn(0);
    wait_sm_turn(0);
  }

  const int warp = (tid >> 5) & 3, g = lane >> 2;
  float* out = static_cast<float*>(a.o) + b * a.o_bs + head * a.o_hs + qd * 2;
  const long long stat = ((long long)b * a.h + head) * a.nq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = q0 + cw * 64 + warp * 16 + g + 8 * h;
    if (r >= a.nq) continue;
    const float inv = l == 0.f ? 1.f : 1.f / l;
    float* row = out + r * a.o_rs;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(row + j * 8) = make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if (qd == 0) {
      a.l[stat + r] = l;
      a.m[stat + r] = m_run[h] * (1.f / kLog2e);
    }
  }
}

template <int HD>
int launch_split_kv(const AttnArgs& a, int batch, float* tiles, cudaStream_t st) {
  const int ntiles = (a.nk + F32Tiles<HD>::BK - 1) / F32Tiles<HD>::BK;
  if (ntiles == 0 || a.h == 0 || batch == 0) return 0;
  attn_fwd_split_kv<HD><<<dim3(ntiles, a.h, batch), 256, 0, st>>>(a, tiles);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd_tf32(const AttnArgs& a, int batch, cudaStream_t st) {
  using T = F32Tiles<HD>;
  if (a.nq == 0 || a.h == 0 || batch == 0) return 0;
  auto kernel = a.bias != nullptr ? attn_fwd_tf32<HD, true> : attn_fwd_tf32<HD, false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((a.nq + T::ROWS - 1) / T::ROWS, a.h, batch), WG_THREADS, T::bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
void f32_plan(int* out) {
  using T = F32Tiles<HD>;
  const int p[6] = {T::ROWS, T::BK, T::STAGES, (int)T::bytes, (int)T::TILE, T::NCW};
  for (int i = 0; i < 6; ++i) out[i] = p[i];
}

// fn<HD>() at a head dim the fp32 body takes (multiples of 16 up to 128)
template <template <int> class F, typename... A>
int f32_dispatch(int hd, A... args) {
  switch (hd) {
    case 16: return F<16>::run(args...);
    case 32: return F<32>::run(args...);
    case 48: return F<48>::run(args...);
    case 64: return F<64>::run(args...);
    case 80: return F<80>::run(args...);
    case 96: return F<96>::run(args...);
    case 112: return F<112>::run(args...);
    case 128: return F<128>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int HD>
struct SplitKv {
  static int run(const AttnArgs* a, int batch, float* tiles, cudaStream_t st) {
    return launch_split_kv<HD>(*a, batch, tiles, st);
  }
};
template <int HD>
struct FwdTf32 {
  static int run(const AttnArgs* a, int batch, cudaStream_t st) { return launch_fwd_tf32<HD>(*a, batch, st); }
};
template <int HD>
struct PlanF32 {
  static int run(int* out) {
    f32_plan<HD>(out);
    return 0;
  }
};

}  // namespace cs

// The fp32 entries, shared by flash_qkv.cu (K1, K5) and flash_cross.cu (K3,
// K6, K7); each source builds into its own library. A call runs the
// pre-pass, then the body, on the same stream; the wrapper allocates `tiles`
// (cs_attention_f32_plan: batch * heads * ceil(Nk / BK) stages of TILE bytes).

// K and V, (batch, heads, nk, hd) fp32 with element strides (k: batch, head,
// row; then v's), into the body's stages at `tiles`
extern "C" int cs_attention_f32_split_kv(const void* k, const void* v, const long long* strides, void* tiles,
                                         int batch, int heads, int nk, int hd, void* stream) {
  cs::AttnArgs a;
  a.k = k;
  a.v = v;
  a.k_bs = strides[0], a.k_hs = strides[1], a.k_rs = strides[2];
  a.v_bs = strides[3], a.v_hs = strides[4], a.v_rs = strides[5];
  a.h = heads;
  a.nk = nk;
  return cs::f32_dispatch<cs::SplitKv>(hd, &a, batch, static_cast<float*>(tiles), static_cast<cudaStream_t>(stream));
}

// o = softmax(q k^T * scale [+ bias]) v from q (batch, heads, nq, hd) and
// the stages at `tiles`; strides: q's batch, head and row strides, then o's,
// in elements; bias null, or (Nk,) fp32 with bias_bs 0, or (B, Nk) with
// bias_bs Nk (natural units); l, m (batch, heads, nq) fp32
extern "C" int cs_attention_f32_fwd(const void* q, const void* tiles, const long long* strides, const void* bias,
                                    long long bias_bs, void* o, void* l, void* m, int batch, int heads, int nq,
                                    int nk, int hd, float scale, void* stream) {
  cs::AttnArgs a;
  a.q = q;
  a.kv_tiles = tiles;
  a.q_bs = strides[0], a.q_hs = strides[1], a.q_rs = strides[2];
  a.o_bs = strides[3], a.o_hs = strides[4], a.o_rs = strides[5];
  a.o = o;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = heads;
  a.nq = nq;
  a.nk = nk;
  a.c1 = scale * cs::kLog2e;
  a.bias = static_cast<const float*>(bias);
  a.bias_bs = bias_bs;
  return cs::f32_dispatch<cs::FwdTf32>(hd, &a, batch, static_cast<cudaStream_t>(stream));
}

// The fp32 tile plan of head dim hd (F32Tiles): out[0..5] = q rows a block,
// KV rows a tile, ring stages, dynamic shared memory in bytes, bytes of a
// tile in `tiles`, consumer warpgroups.
extern "C" int cs_attention_f32_plan(int hd, int* out) { return cs::f32_dispatch<cs::PlanF32>(hd, out); }
