// K2: the fused LayerNorm -> fc1 -> GELU -> fc2 -> LayerScale -> residual
// half of a ViT block:  out = x + ls2 * (fc2(gelu(fc1(ln(x)) + b1)) + b2).
//
// Replaces the TPU kernel crossscore_tpu/ops/fused_mlp.py `_ln_mlp_kernel` /
// `_ln_mlp_body` (launched by `_fused_ln_mlp_fwd_pallas`). The TPU kernel
// keeps both weight matrices resident in VMEM; a Hopper block cannot
// (W1 + W2 are 2.4 MB bf16 at D=384), so the weights stream through shared
// memory in chunks of the hidden dimension (cp.async, the next chunk's load
// overlapping this chunk's products) while the activation side stays on
// chip: a block takes BM rows, writes LN(x) as bf16 into shared memory, and
// for each chunk computes h = GELU(LN(x) W1[chunk]^T + b1) into a bf16 tile
// in shared memory and acc += h W2[:, chunk]^T into fp32 accumulators held
// in registers across the whole hidden dimension. The 4D-wide hidden never
// reaches device memory, which is what the TPU kernel achieves.
//
// Bound on the H100: 4*D*F operations per row against ~4*D bytes of
// activations (bf16 in and out), ~1150 op/byte at D=384, so the tensor cores
// bound it. At D = 64 and 384 both products run on Hopper wgmma (operands
// read by the tensor cores straight from swizzled shared memory, fp32
// accumulators in registers); at D = 768 and 1024, where a warpgroup cannot
// hold 64 x D/2 accumulators, on mma.sync m16n8k16 fed by ldmatrix. Every
// block re-reads W1 and W2 from L2 (3.6 GB per main-path launch at 64-row
// blocks), which a later version can halve with larger row tiles or
// clusters sharing the weight loads. The fp32 variant (the parity preset)
// runs on the CUDA cores in full fp32, because the tensor cores' fp32 route
// is TF32.
//
// Numerics follow the TPU kernel: LN statistics in fp32, bf16 products with
// fp32 accumulation, GELU in fp32 (the tanh form on bf16 by default, else the
// exact form through XLA's f32 erf polynomial), LayerScale and residual in
// fp32, one rounding to the input dtype at the end.
//
// K10 is the same kernels with RES = true, replacing the TPU kernel
// `_ln_mlp_res_kernel` (launched by `_fused_res_ln_mlp_fwd_pallas`), which
// folds the attention half's LayerScale residual in as well:
//   x2 = x + attn * ls1 (fp32, ls1 rounded to x's dtype first),
//   out = x2 + ls2 * (fc2(gelu(fc1(ln(x2)) + b1)) + b2),
// with LN on x2 and x2 added unrounded in the epilogue. A row's x2 is
// computed from x and attn once for LN (held in registers by the bf16
// kernel) and again in the epilogue (the second reads hit L2), so nothing but
// the output is written. Its GELU has no option, as on the TPU: the tanh form on
// bf16, the erf polynomial on fp32. It adds one (B*N, D) read to K2's bytes
// and no operation of note, so the same tensor-core bound holds. RES = false
// compiles K2 exactly as before. K10 takes D = 64 and 384 in bf16 (the wgmma
// kernels) and the fp32 widths; no model path calls it (nor the TPU's).

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace cs {

constexpr int MLP_THREADS = 256;
constexpr int F32_BM = 16;  // rows per block (fp32 path)
constexpr size_t kMaxSmem = 232448;

struct MlpArgs {
  const void* x;
  const void* lns;
  const void* lnb;
  const void* w1;  // (F, D), torch Linear layout
  const void* b1;
  const void* w2;  // (D, F)
  const void* b2;
  const void* ls2;
  void* out;
  int rows, d, f;
  float eps;
  int tanh_gelu;
  const void* attn = nullptr;  // K10: the attention half's output (rows, D)
  const void* ls1 = nullptr;   // K10: its LayerScale (D,), in x's dtype
};

// The residual stream entering LN at row-major index gi (column c): x for
// K2; for K10 x2 = x + attn * ls1 in fp32, rounded as the TPU kernel rounds
// it (a product, then a sum: no fused multiply-add).
template <bool RES, typename T>
__device__ __forceinline__ float stream_in(const T* X, const T* ATT, const T* LS1, long long gi, int c) {
  if constexpr (RES) return __fadd_rn(to_f32(X[gi]), __fmul_rn(to_f32(ATT[gi]), to_f32(LS1[c])));
  else return to_f32(X[gi]);
}

__device__ __forceinline__ float erf_f32(float x) {
  // XLA's f32 erf rational approximation (as crossscore_tpu/ops/fused_mlp.py)
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float p = 0.00022905065861350646f;
  p = p * x2 + 0.0034082910107109506f;
  p = p * x2 + 0.050955695062380861f;
  p = p * x2 + 0.18520832239976145f;
  p = p * x2 + 1.128379143519084f;
  float q = -1.1791602954361697e-7f;
  q = q * x2 + 2.3547966471313185e-5f;
  q = q * x2 + 1.0179625278914885e-3f;
  q = q * x2 + 1.4070470171167667e-2f;
  q = q * x2 + 1.1098505178285362e-1f;
  q = q * x2 + 4.9746925110067538e-1f;
  q = q * x2 + 1.0f;
  return x * p / q;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tanh form is only taken on bf16, whose hidden tile is rounded to bf16
// (2^-8) right after: the hardware tanh (relative error < 2^-10.9) suffices.
__device__ __forceinline__ float gelu(float h, int tanh_form) {
  if (tanh_form) return 0.5f * h * (1.f + tanh_approx(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erf_f32(h * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of `nrows` rows from m0 into a shared tile (row stride ld), fp32
// statistics; rows past `rows` are zero. RES: of K10's x + ATT * LS1.
template <int NW, bool RES = false, typename T, typename TO>
__device__ void layer_norm_rows(TO* dst, int ld, const T* X, const T* S, const T* B, int m0,
                                int nrows, int rows, int D, float eps, const T* ATT = nullptr,
                                const T* LS1 = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < nrows; rr += NW) {
    const int g = m0 + rr;
    TO* out = dst + rr * ld;
    if (g >= rows) {
      for (int c = lane; c < D; c += 32) out[c] = from_f32<TO>(0.f);
      continue;
    }
    const long long r0 = (long long)g * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += stream_in<RES>(X, ATT, LS1, r0 + c, c);
    const float mean = warp_sum(sum) / D;
    float var = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = stream_in<RES>(X, ATT, LS1, r0 + c, c) - mean;
      var += t * t;
    }
    const float rstd = rsqrtf(warp_sum(var) / D + eps);
    for (int c = lane; c < D; c += 32)
      out[c] = from_f32<TO>((stream_in<RES>(X, ATT, LS1, r0 + c, c) - mean) * rstd * to_f32(S[c]) + to_f32(B[c]));
  }
}

// bf16 tiling: RG row groups x CG column groups of warps (RG * CG = 8);
// BM = 16 * RG rows per block, each warp owns 16 rows x NT*8 output columns
// of the accumulator and FCH/CG columns of each hidden chunk.
template <int RG, int NT, int FCH, int NW>
struct MmaMlp {
  static constexpr int THREADS = 32 * NW;
  static constexpr int CG = NW / RG;
  static constexpr int D = CG * NT * 8;
  static constexpr int BM = 16 * RG;
  static constexpr int NT1 = FCH / CG / 8;  // fc1 n8 tiles per warp
  static constexpr int LDL = D + 8;         // LN tile and W1 chunk rows
  static constexpr int LDC = FCH + 8;       // W2 chunk and hidden tile rows
  static constexpr size_t w1_off = align128((size_t)BM * LDL * 2);
  static constexpr size_t w2_off = w1_off + align128((size_t)FCH * LDL * 2);
  static constexpr size_t h_off = w2_off + align128((size_t)D * LDC * 2);
  static constexpr size_t total = h_off + align128((size_t)BM * LDC * 2);
};

template <int RG, int NT, int FCH, int NW>
__global__ void __launch_bounds__(32 * NW) ln_mlp_bf16(MlpArgs a) {
  using L = MmaMlp<RG, NT, FCH, NW>;
  using bf16 = __nv_bfloat16;
  static_assert(NT % 2 == 0 && (L::NT1 == 1 || L::NT1 % 2 == 0), "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sLn = reinterpret_cast<bf16*>(smem);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L::w1_off);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + L::w2_off);
  bf16* sH = reinterpret_cast<bf16*>(smem + L::h_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % RG, cg = warp / RG, g = lane >> 2, qd = lane & 3;
  const int m0 = blockIdx.x * L::BM, F = a.f;
  const bf16* X = static_cast<const bf16*>(a.x);
  const bf16* W1 = static_cast<const bf16*>(a.w1);
  const bf16* W2 = static_cast<const bf16*>(a.w2);
  const bf16* B1 = static_cast<const bf16*>(a.b1);
  // W1 chunk: rows f0..f0+FCH of (F, D); W2 chunk: columns f0..f0+FCH of (D, F)
  auto load_w1 = [&](int f0) {
    cp_async_rows<FCH, L::D, L::THREADS>(sW1, L::LDL, W1, L::D, f0, F, tid);
    cp_async_commit();
  };
  auto load_w2 = [&](int f0) {
    cp_async_rows<L::D, FCH, L::THREADS>(sW2, L::LDC, W2 + f0, F, 0, L::D, tid);
    cp_async_commit();
  };
  load_w1(0);
  load_w2(0);
  layer_norm_rows<NW>(sLn, L::LDL, X, static_cast<const bf16*>(a.lns), static_cast<const bf16*>(a.lnb),
                      m0, L::BM, a.rows, L::D, a.eps);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* lnw = sLn + rg * 16 * L::LDL;
  const int nchunks = F / FCH;
  for (int c = 0; c < nchunks; ++c) {
    const int f0 = c * FCH;
    cp_async_wait<1>();  // W1 chunk c (W2 chunk c may still be in flight)
    __syncthreads();

    // fc1: this warp's 16 rows x FCH/CG hidden columns, then bias + GELU
    float hc[L::NT1][4];
#pragma unroll
    for (int j = 0; j < L::NT1; ++j) hc[j][0] = hc[j][1] = hc[j][2] = hc[j][3] = 0.f;
    const bf16* w1t = sW1 + cg * (FCH / L::CG) * L::LDL;
#pragma unroll 4
    for (int kk = 0; kk < L::D / 16; ++kk) {
      uint32_t af[4];
      ldsm_a(af, lnw + kk * 16, L::LDL, lane);
      if constexpr (L::NT1 == 1) {
        uint32_t bb[2];
        ldsm_b_nk_1tile(bb, w1t + kk * 16, L::LDL, lane);
        mma_bf16(hc[0], af, bb[0], bb[1]);
      } else {
#pragma unroll
        for (int np = 0; np < L::NT1 / 2; ++np) {
          uint32_t bb[4];
          ldsm_b_nk_x2tiles(bb, w1t + np * 16 * L::LDL + kk * 16, L::LDL, lane);
          mma_bf16(hc[2 * np], af, bb[0], bb[1]);
          mma_bf16(hc[2 * np + 1], af, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < L::NT1; ++j) {
      const int col = cg * (FCH / L::CG) + j * 8 + qd * 2;
      const float c0 = to_f32(B1[f0 + col]), c1 = to_f32(B1[f0 + col + 1]);
      const int row = rg * 16 + g;
      *reinterpret_cast<uint32_t*>(sH + row * L::LDC + col) =
          pack_bf16(gelu(hc[j][0] + c0, a.tanh_gelu), gelu(hc[j][1] + c1, a.tanh_gelu));
      *reinterpret_cast<uint32_t*>(sH + (row + 8) * L::LDC + col) =
          pack_bf16(gelu(hc[j][2] + c0, a.tanh_gelu), gelu(hc[j][3] + c1, a.tanh_gelu));
    }
    __syncthreads();  // the hidden tile is complete and W1 chunk c is free
    if (c + 1 < nchunks) {
      load_w1(f0 + FCH);
      cp_async_wait<1>();  // W2 chunk c
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // fc2: acc (16 rows x NT*8 columns) += h W2[cols, chunk]^T
    const bf16* w2t = sW2 + cg * NT * 8 * L::LDC;
    const bf16* hw = sH + rg * 16 * L::LDC;
#pragma unroll
    for (int ks = 0; ks < FCH / 16; ++ks) {
      uint32_t af[4];
      ldsm_a(af, hw + ks * 16, L::LDC, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_b_nk_x2tiles(bb, w2t + np * 16 * L::LDC + ks * 16, L::LDC, lane);
        mma_bf16(acc[2 * np], af, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], af, bb[2], bb[3]);
      }
    }
    __syncthreads();  // W2 chunk c and the hidden tile are free
    if (c + 1 < nchunks) load_w2(f0 + FCH);
  }

  const bf16* B2 = static_cast<const bf16*>(a.b2);
  const bf16* LS2 = static_cast<const bf16*>(a.ls2);
  bf16* OUT = static_cast<bf16*>(a.out);
  const int r0 = m0 + rg * 16 + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = cg * NT * 8 + j * 8 + qd * 2;
    const float bb0 = to_f32(B2[col]), bb1 = to_f32(B2[col + 1]);
    const float s0 = to_f32(LS2[col]), s1 = to_f32(LS2[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < a.rows) {
        const long long gi = (long long)r * L::D + col;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(X + gi);
        *reinterpret_cast<uint32_t*>(OUT + gi) =
            pack_bf16(__low2float(xv) + (acc[j][2 * h] + bb0) * s0,
                      __high2float(xv) + (acc[j][2 * h + 1] + bb1) * s1);
      }
    }
  }
}

// bf16 at D = 64 and 384 (dinov2-test, dinov2-small): Hopper wgmma. Two
// warpgroups; each computes the block's 64 rows x 32 of the 64 hidden
// columns of a chunk (m64n32k16 over D), and 64 rows x D/2 output columns of
// the accumulator (m64n{D/2}k16 over the chunk). All four tiles are K-major
// in the 128-byte swizzled layout of wgmma.cuh.
template <int D>
struct WgMlp {
  static constexpr int BM = 64, FCH = 64, THREADS = 256;
  static constexpr int N2 = D / 2;  // fc2 columns per warpgroup
  static constexpr size_t w1_off = (size_t)BM * D * 2;      // LN tile [64][D]
  static constexpr size_t w2_off = w1_off + (size_t)FCH * D * 2;  // W1 chunk [64][D]
  static constexpr size_t h_off = w2_off + (size_t)D * FCH * 2;   // W2 chunk [D][64]
  static constexpr size_t total = h_off + (size_t)BM * FCH * 2 + 1024;  // + alignment slack
};

template <int D, bool RES = false>
__global__ void __launch_bounds__(256) ln_mlp_wgmma(MlpArgs a) {
  using L = WgMlp<D>;
  using bf16 = __nv_bfloat16;
  static_assert(D % 64 == 0 && (L::N2 == 32 || L::N2 == 192), "wgmma tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sLn = smem;
  unsigned char* sW1 = smem + L::w1_off;
  unsigned char* sW2 = smem + L::w2_off;
  unsigned char* sH = smem + L::h_off;
  const int tid = threadIdx.x, wg = tid >> 7, wwarp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int m0 = blockIdx.x * L::BM, F = a.f;
  const bf16* X = static_cast<const bf16*>(a.x);
  const bf16* ATT = static_cast<const bf16*>(a.attn);
  const bf16* LS1 = static_cast<const bf16*>(a.ls1);
  const bf16* W1 = static_cast<const bf16*>(a.w1);
  const bf16* W2 = static_cast<const bf16*>(a.w2);
  const bf16* B1 = static_cast<const bf16*>(a.b1);
  auto load_w1 = [&](int f0) {  // rows f0..f0+64 of W1 (F, D)
    for (int i = tid; i < L::FCH * D / 8; i += L::THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(sW1 + sw128_offset(r, c, L::FCH), W1 + (long long)(f0 + r) * D + c, 16);
    }
    cp_async_commit();
  };
  auto load_w2 = [&](int f0) {  // columns f0..f0+64 of W2 (D, F)
    for (int i = tid; i < D * L::FCH / 8; i += L::THREADS) {
      const int n = i / (L::FCH / 8), c = (i % (L::FCH / 8)) * 8;
      cp_async16(sW2 + sw128_offset(n, c, D), W2 + (long long)n * F + f0 + c, 16);
    }
    cp_async_commit();
  };
  load_w1(0);
  load_w2(0);

  // LayerNorm (fp32 statistics) into the swizzled bf16 A tile of fc1
  const bf16* S = static_cast<const bf16*>(a.lns);
  const bf16* Bn = static_cast<const bf16*>(a.lnb);
  for (int rr = tid >> 5; rr < L::BM; rr += L::THREADS / 32) {
    const int row = m0 + rr;
    if (row >= a.rows) {
      for (int c = lane; c < D; c += 32) *reinterpret_cast<bf16*>(sLn + sw128_offset(rr, c, L::BM)) = __float2bfloat16(0.f);
      continue;
    }
    const long long r0 = (long long)row * D;
    if constexpr (RES) {  // K10: x2 = x + attn * ls1 once into registers, then LN
      float xv[D / 32];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        xv[i] = stream_in<true>(X, ATT, LS1, r0 + lane + 32 * i, lane + 32 * i);
        sum += xv[i];
      }
      const float mean = warp_sum(sum) / D;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) var += (xv[i] - mean) * (xv[i] - mean);
      const float rstd = rsqrtf(warp_sum(var) / D + a.eps);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const int c = lane + 32 * i;
        *reinterpret_cast<bf16*>(sLn + sw128_offset(rr, c, L::BM)) =
            __float2bfloat16((xv[i] - mean) * rstd * __bfloat162float(S[c]) + __bfloat162float(Bn[c]));
      }
      continue;
    }
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += stream_in<RES>(X, ATT, LS1, r0 + c, c);
    const float mean = warp_sum(sum) / D;
    float var = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = stream_in<RES>(X, ATT, LS1, r0 + c, c) - mean;
      var += t * t;
    }
    const float rstd = rsqrtf(warp_sum(var) / D + a.eps);
    for (int c = lane; c < D; c += 32)
      *reinterpret_cast<bf16*>(sLn + sw128_offset(rr, c, L::BM)) = __float2bfloat16(
          (stream_in<RES>(X, ATT, LS1, r0 + c, c) - mean) * rstd * __bfloat162float(S[c]) +
          __bfloat162float(Bn[c]));
  }

  float acc[L::N2 / 2];
#pragma unroll
  for (int i = 0; i < L::N2 / 2; ++i) acc[i] = 0.f;
  const int nchunks = F / L::FCH;
  for (int c = 0; c < nchunks; ++c) {
    const int f0 = c * L::FCH;
    cp_async_wait<1>();  // W1 chunk c
    fence_async_shared();
    __syncthreads();

    // fc1: this warpgroup's 32 hidden columns of the chunk, all 64 rows
    float hc[16];
    fence_regs(hc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t kb = (kk / 4) * 64 * 128, kin = (kk % 4) * 32;
      wgmma_m64n32k16(hc, sw128_desc(sLn + kb, kin), sw128_desc(sW1 + kb + wg * 32 * 128, kin), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(hc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wg * 32 + j * 8 + qd * 2;
      const float c0 = __bfloat162float(B1[f0 + col]), c1 = __bfloat162float(B1[f0 + col + 1]);
      const int row = wwarp * 16 + g;
      *reinterpret_cast<uint32_t*>(sH + sw128_offset(row, col, L::BM)) =
          pack_bf16(gelu(hc[4 * j] + c0, a.tanh_gelu), gelu(hc[4 * j + 1] + c1, a.tanh_gelu));
      *reinterpret_cast<uint32_t*>(sH + sw128_offset(row + 8, col, L::BM)) =
          pack_bf16(gelu(hc[4 * j + 2] + c0, a.tanh_gelu), gelu(hc[4 * j + 3] + c1, a.tanh_gelu));
    }
    fence_async_shared();
    __syncthreads();  // the hidden tile is complete and W1 chunk c is free
    if (c + 1 < nchunks) {
      load_w1(f0 + L::FCH);
      cp_async_wait<1>();  // W2 chunk c
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // fc2: acc (64 rows x this warpgroup's D/2 columns) += h W2[cols, chunk]^T
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::FCH / 16; ++ks) {
      const uint64_t da = sw128_desc(sH, ks * 32), db = sw128_desc(sW2 + wg * L::N2 * 128, ks * 32);
      if constexpr (L::N2 == 192) {
        wgmma_m64n192k16(acc, da, db, 1);
      } else {
        wgmma_m64n32k16(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // W2 chunk c and the hidden tile are free
    if (c + 1 < nchunks) load_w2(f0 + L::FCH);
  }

  const bf16* B2 = static_cast<const bf16*>(a.b2);
  const bf16* LS2 = static_cast<const bf16*>(a.ls2);
  bf16* OUT = static_cast<bf16*>(a.out);
  const int r0 = m0 + wwarp * 16 + g;
#pragma unroll
  for (int j = 0; j < L::N2 / 8; ++j) {
    const int col = wg * L::N2 + j * 8 + qd * 2;
    const float bb0 = __bfloat162float(B2[col]), bb1 = __bfloat162float(B2[col + 1]);
    const float s0 = __bfloat162float(LS2[col]), s1 = __bfloat162float(LS2[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < a.rows) {
        const long long gi = (long long)r * D + col;
        float x0, x1;  // the residual stream, unrounded (K10: x2 in fp32)
        if constexpr (RES) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(X + gi);
          const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(ATT + gi);
          const __nv_bfloat162 lv = *reinterpret_cast<const __nv_bfloat162*>(LS1 + col);
          x0 = __fadd_rn(__low2float(xv), __fmul_rn(__low2float(av), __low2float(lv)));
          x1 = __fadd_rn(__high2float(xv), __fmul_rn(__high2float(av), __high2float(lv)));
        } else {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(X + gi);
          x0 = __low2float(xv);
          x1 = __high2float(xv);
        }
        *reinterpret_cast<uint32_t*>(OUT + gi) =
            pack_bf16(x0 + (acc[4 * j + 2 * h] + bb0) * s0, x1 + (acc[4 * j + 2 * h + 1] + bb1) * s1);
      }
    }
  }
}

template <int D, bool RES = false>
int launch_wgmma(const MlpArgs& a, cudaStream_t st) {
  using L = WgMlp<D>;
  if (a.d != D || a.f % L::FCH || L::total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(ln_mlp_wgmma<D, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_wgmma<D, RES><<<(a.rows + L::BM - 1) / L::BM, L::THREADS, L::total, st>>>(a);
  return (int)cudaGetLastError();
}

// fp32 layout: LN tile (F32_BM x D), the W1 chunk (FC x D) and the W2 chunk
// (D x FC) staged with one padding column so that neighbouring threads read
// neighbouring banks, and the hidden chunk (F32_BM x FC).
struct F32MlpLayout {
  size_t w1_off, w2_off, h_off, total;
  __host__ __device__ F32MlpLayout(int d, int fc) {
    w1_off = align128((size_t)F32_BM * d * 4);
    w2_off = w1_off + align128((size_t)fc * (d + 1) * 4);
    h_off = w2_off + align128((size_t)d * (fc + 1) * 4);
    total = h_off + align128((size_t)F32_BM * fc * 4);
  }
};

// fp32 (parity preset): CUDA cores, F32_BM rows per block, exact GELU. The
// weight chunks are copied into shared memory with coalesced loads, then
// every thread reads them along its own row.
template <int FC, bool RES = false>
__global__ void __launch_bounds__(MLP_THREADS) ln_mlp_f32(MlpArgs a) {
  constexpr int NJ = 4;                     // output columns per thread: D <= 4 * MLP_THREADS
  constexpr int RSTEP = MLP_THREADS / FC;   // fc1: one hidden column, F32_BM / RSTEP rows
  constexpr int RPT = F32_BM / RSTEP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.d, F = a.f, m0 = blockIdx.x * F32_BM, tid = threadIdx.x;
  const F32MlpLayout L(D, FC);
  float* sLn = reinterpret_cast<float*>(smem);
  float* sW1 = reinterpret_cast<float*>(smem + L.w1_off);
  float* sW2 = reinterpret_cast<float*>(smem + L.w2_off);
  float* sH = reinterpret_cast<float*>(smem + L.h_off);
  const float* X = static_cast<const float*>(a.x);
  const float* ATT = static_cast<const float*>(a.attn);
  const float* LS1 = static_cast<const float*>(a.ls1);
  const float* W1 = static_cast<const float*>(a.w1);
  const float* W2 = static_cast<const float*>(a.w2);
  const float* B1 = static_cast<const float*>(a.b1);

  layer_norm_rows<MLP_THREADS / 32, RES>(sLn, D, X, static_cast<const float*>(a.lns),
                                         static_cast<const float*>(a.lnb), m0, F32_BM, a.rows, D, a.eps, ATT, LS1);
  float acc[NJ][F32_BM];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < F32_BM; ++r) acc[j][r] = 0.f;

  const int f = tid % FC, rg = tid / FC;
  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // the previous chunk is consumed (and the LN tile written)
    for (int i = tid; i < FC * D; i += MLP_THREADS) {
      const int ff = i / D, k = i % D;
      sW1[ff * (D + 1) + k] = W1[(long long)(f0 + ff) * D + k];
    }
    for (int i = tid; i < D * FC; i += MLP_THREADS) {
      const int n = i / FC, k = i % FC;
      sW2[n * (FC + 1) + k] = W2[(long long)n * F + f0 + k];
    }
    __syncthreads();
    float h[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) h[i] = 0.f;
    const float* w1r = sW1 + f * (D + 1);
    for (int k = 0; k < D; ++k) {
      const float w = w1r[k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) h[i] = fmaf(sLn[(rg + RSTEP * i) * D + k], w, h[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) sH[(rg + RSTEP * i) * FC + f] = gelu(h[i] + B1[f0 + f], 0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FC; ++k) {
      float hv[F32_BM];
#pragma unroll
      for (int r = 0; r < F32_BM; ++r) hv[r] = sH[r * FC + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tid + j * MLP_THREADS;
        if (n < D) {
          const float w = sW2[n * (FC + 1) + k];
#pragma unroll
          for (int r = 0; r < F32_BM; ++r) acc[j][r] = fmaf(hv[r], w, acc[j][r]);
        }
      }
    }
  }

  const float* B2 = static_cast<const float*>(a.b2);
  const float* LS2 = static_cast<const float*>(a.ls2);
  float* OUT = static_cast<float*>(a.out);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = tid + j * MLP_THREADS;
    if (n >= D) continue;
#pragma unroll
    for (int r = 0; r < F32_BM; ++r) {
      const int g = m0 + r;
      if (g < a.rows) {
        const long long gi = (long long)g * D + n;
        OUT[gi] = stream_in<RES>(X, ATT, LS1, gi, n) + (acc[j][r] + B2[n]) * LS2[n];
      }
    }
  }
}

template <int FC, bool RES = false>
int launch_f32(const MlpArgs& a, cudaStream_t st) {
  const size_t bytes = F32MlpLayout(a.d, FC).total;
  if (a.d > 4 * MLP_THREADS || a.f % FC || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(ln_mlp_f32<FC, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_f32<FC, RES><<<(a.rows + F32_BM - 1) / F32_BM, MLP_THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int RG, int NT, int FCH, int NW>
int launch_bf16(const MlpArgs& a, cudaStream_t st) {
  using L = MmaMlp<RG, NT, FCH, NW>;
  if (a.d != L::D || a.f % FCH || L::total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(ln_mlp_bf16<RG, NT, FCH, NW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_bf16<RG, NT, FCH, NW><<<(a.rows + L::BM - 1) / L::BM, L::THREADS, L::total, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace cs

// Shapes the wrappers guarantee: for bf16 D in {64, 384, 768, 1024} (the ViT
// presets' widths), for fp32 D % 8 == 0 and D <= 1024; F % 64 == 0;
// contiguous row-major tensors of one dtype.
extern "C" int cs_fused_ln_mlp(const void* x, const void* lns, const void* lnb, const void* w1,
                               const void* b1, const void* w2, const void* b2, const void* ls2,
                               void* out, int rows, int d, int f, float eps, int tanh_gelu,
                               int dtype, void* stream) {
  cs::MlpArgs a{x, lns, lnb, w1, b1, w2, b2, ls2, out, rows, d, f, eps, tanh_gelu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::kBFloat16) {
    switch (d) {
      case 64: return cs::launch_wgmma<64>(a, st);
      case 384: return cs::launch_wgmma<384>(a, st);
      case 768: return cs::launch_bf16<2, 24, 32, 8>(a, st);
      case 1024: return cs::launch_bf16<2, 32, 32, 8>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return d <= 512 ? cs::launch_f32<32>(a, st) : cs::launch_f32<16>(a, st);
}

// K10: x2 = x + attn * ls1, then K2 on x2 with x2 as the residual; the GELU
// by the dtype (tanh on bf16, erf on fp32). Shapes as K2's, with D in {64,
// 384} for bf16; attn (rows, D) and ls1 (D,) in x's dtype.
extern "C" int cs_fused_res_ln_mlp(const void* x, const void* attn, const void* ls1, const void* lns,
                                   const void* lnb, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* ls2, void* out, int rows, int d, int f,
                                   float eps, int dtype, void* stream) {
  cs::MlpArgs a{x, lns, lnb, w1, b1, w2, b2, ls2, out, rows, d, f, eps, dtype == cs::kBFloat16, attn, ls1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::kBFloat16) {
    switch (d) {
      case 64: return cs::launch_wgmma<64, true>(a, st);
      case 384: return cs::launch_wgmma<384, true>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return d <= 512 ? cs::launch_f32<32, true>(a, st) : cs::launch_f32<16, true>(a, st);
}
