// K2: the fused LayerNorm -> fc1 -> GELU -> fc2 -> LayerScale -> residual
// half of a ViT block:  out = x + ls2 * (fc2(gelu(fc1(ln(x)) + b1)) + b2).
//
// Replaces the TPU kernel crossscore_tpu/ops/fused_mlp.py `_ln_mlp_kernel` /
// `_ln_mlp_body` (launched by `_fused_ln_mlp_fwd_pallas`). The TPU kernel
// keeps both weight matrices resident in VMEM; a Hopper block cannot
// (W1 + W2 are 2.4 MB bf16 at D=384), so the weights stream through shared
// memory in chunks of the hidden dimension while the activation side stays
// on chip: a block takes a tile of rows, writes LN(x) as bf16 into shared
// memory, and for each chunk computes h = GELU(LN(x) W1[chunk]^T + b1) and
// acc += h W2[:, chunk]^T into fp32 accumulators held in registers across
// the whole hidden dimension. The 4D-wide hidden never reaches device
// memory, which is what the TPU kernel achieves.
//
// Bound on the H100: 4*D*F operations per row against ~4*D bytes of
// activations (bf16 in and out), ~1150 op/byte at D=384, so the tensor cores
// bound it (0.235 ms at the predict point's 98,640 rows).
//
// bf16 at D = 64 and 384 (`ln_mlp_tma`): blocks of 64 rows in clusters of
// two, each block four warpgroups with their own register ceilings
// (setmaxnreg): two producer warps (TMA), an fc1 warpgroup and two fc2
// warpgroups (wgmma).
// - Registers decide the split. 64 rows x D = 384 outputs in fp32 are 192
//   registers a thread of one warpgroup, and fc1's 64 x 64 hidden chunk 32
//   more: past the 240 that setmaxnreg allows, so one warpgroup cannot own
//   both. Here fc2 warpgroup p owns output columns p D/2.. (96 accumulator
//   registers), and the fc1 warpgroup holds LN(x) as its A registers (96)
//   and two hidden chunks (64). 128-row blocks would need 192 accumulators
//   a warpgroup again.
// - Loads by TMA through two mbarrier rings, one producer warp each: ring 1
//   (24 KB slots at D = 384) takes the block's x rows (K10: and its attn
//   rows), then W1's rows of each 64-column hidden chunk in two pieces along
//   D, then the x (and attn) rows again for the epilogue; ring 2 takes W2's
//   columns of each chunk, the rows of one fc2 warpgroup a slot. Four slots
//   each at D = 384 (eight at 64), beside two hidden tiles.
// - Weight bytes from L2: the two blocks of a cluster share every weight
//   box, each block's producer loading half of its rows and multicasting
//   them into both, so each weight byte is read from L2 once per 128 rows
//   (1.82 GB per launch at the predict point, against 3.64 GB for 64-row
//   blocks that each read them). A slot is free again when its consumer
//   warps of both blocks have released it, an arrival on each block's empty
//   barrier. A block whose rows all lie past the end (the grid is a whole
//   number of clusters) runs the rings all the same, on rows from 0, and
//   stores nothing; each producer stays until both blocks have released its
//   last slots, since their arrivals land on its barriers.
// - LN: the fc2 warpgroups, idle until the first hidden tile, normalise the
//   block's rows (fp32 statistics, 8 rows a warp) over the x rows in place
//   while the first weights load; the fc1 warpgroup reads LN(x) into its A
//   registers once.
// - Products on wgmma: fc1 is m64n64k16 with A from registers and W1 from
//   the ring, into one of two register buffers; the bias and the GELU run
//   in fp32 and go to one of two bf16 hidden tiles in shared memory; fc2 is
//   m64n{D/2}k16 with both operands in shared memory. The fc1 warpgroup
//   issues fc1 of chunk c + 1 before chunk c's GELU, so its GELU overlaps
//   its own next product and the fc2 warpgroups' products of chunk c - 1.
//   Every product is waited for inside its step, and no barrier wait (a
//   spin loop) or branch sits between a product's issue and its wait:
//   ptxas then serialises every wgmma (C7514-C7517).
// - The epilogue writes out = x + ls2 (acc + b2) over the reloaded x rows
//   and stores them by TMA (rows past the end are not written).
// - Deterministic: a fixed order, no atomics, no split over blocks.
//
// At D = 768 and 1024, where a warpgroup cannot hold 64 x D accumulators,
// both products run on mma.sync m16n8k16 fed by ldmatrix with cp.async
// double buffers (`ln_mlp_bf16`). The fp32 variant (the parity preset) runs
// on the CUDA cores in full fp32, because the tensor cores' fp32 route is
// TF32.
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
// computed from x and attn once for LN and again in the epilogue (the bf16
// kernel loads both tiles twice through ring 1), so nothing but the output
// is written. Its GELU has no option, as on the TPU: the tanh form on bf16,
// the erf polynomial on fp32. It adds one (B*N, D) read to K2's bytes
// and no operation of note, so the same tensor-core bound holds. RES = false
// compiles K2. K10 takes D = 64 and 384 in bf16 (`ln_mlp_tma`) and the fp32
// widths; no model path calls it (nor the TPU's).

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"
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

// XLA's f32 erf rational approximation (as crossscore_tpu/ops/fused_mlp.py).
// FAST: the final division at 2 ulp (__fdividef, q >= 1 here), for the bf16
// kernel, whose hidden tile is rounded to bf16 (2^-8) right after, so the
// ulps never show; the IEEE division costs that kernel more than its fc1.
template <bool FAST = false>
__device__ __forceinline__ float erf_f32(float x) {
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
  if constexpr (FAST) return __fdividef(x * p, q);
  return x * p / q;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tanh form is only taken on bf16, whose hidden tile is rounded to bf16
// (2^-8) right after: the hardware tanh (relative error < 2^-10.9) suffices.
template <bool FAST = false>
__device__ __forceinline__ float gelu(float h, int tanh_form) {
  if (tanh_form) return 0.5f * h * (1.f + tanh_approx(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erf_f32<FAST>(h * 0.7071067811865476f));
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

// bf16 at D = 64 and 384 (dinov2-test, dinov2-small) on Hopper: per block of
// 64 rows two producer warps (TMA), an fc1 warpgroup and two fc2
// warpgroups (wgmma), blocks in clusters of MLP_CLUSTER. See the top of
// this file.
constexpr int MLP_CLUSTER = 2;
constexpr int MLP_WG_THREADS = 512;  // the producer's, the fc1 and the two fc2 warpgroups
constexpr int FC1_REGS = 216;        // 24 + 216 + 2 * 136 = 512 registers a thread-slot
constexpr int FC2_REGS = 136;

template <int D>
struct MlpTiles {
  static_assert(D % 64 == 0, "D");
  static constexpr int ROWS = 64;              // rows a block
  static constexpr int FCH = 64;               // hidden columns a chunk
  static constexpr int CL = MLP_CLUSTER;       // blocks a cluster, sharing every weight load
  static constexpr int KB = D / 64;            // 64-column blocks of a row of x or W1
  static constexpr int NP1 = KB > 1 ? 2 : 1;   // W1 pieces a chunk, split along D
  static constexpr int KB1 = KB / NP1;         // column blocks a W1 piece
  static constexpr uint32_t SLOT1 = FCH * KB1 * 128;  // a W1-ring slot: one W1 piece
  static constexpr int RX = SLOT1 / (2 * D);   // rows of x (K10: of attn) a W1-ring slot holds
  static constexpr int XP = ROWS / RX;         // slots of the x tile
  static constexpr int N2 = D / 2;             // output columns of each fc2 warpgroup
  static constexpr uint32_t SLOT2 = N2 * 128;  // a W2-ring slot: its W2 rows of a chunk
  static constexpr uint32_t HB = ROWS * FCH * 2;  // a hidden tile
  static constexpr int NB = 2;                 // hidden tiles: fc1 runs a chunk ahead of fc2
  static constexpr int S2 = D > 64 ? 4 : 8;     // ring-2 stages; ring 1 takes what is left, up to 8
  static constexpr int NBAR = 2 * 8 + 2 * S2 + 2 * NB;  // full and empty barriers of each ring and tile
  static constexpr int FIT = (int)((kMaxSmem - NB * HB - S2 * SLOT2 - NBAR * 8 - 1024) / SLOT1);
  static constexpr int S1 = FIT < 8 ? FIT : 8;
  static constexpr uint32_t ring1_off = NB * HB;
  static constexpr uint32_t ring2_off = ring1_off + S1 * SLOT1;
  static constexpr uint32_t bar_off = ring2_off + S2 * SLOT2;
  static constexpr uint32_t bytes = bar_off + NBAR * 8 + 1024;  // + alignment slack
  static_assert(2 * XP <= S1 && KB1 * NP1 == KB && N2 % 16 == 0, "tile plan");
};

template <int D, bool RES, bool TANH>
__global__ void __cluster_dims__(MLP_CLUSTER, 1, 1) __launch_bounds__(MLP_WG_THREADS, 1)
    ln_mlp_tma(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
               const __grid_constant__ CUtensorMap mo, const MlpArgs a) {
  using T = MlpTiles<D>;
  using bf16 = __nv_bfloat16;
  constexpr int S1 = T::S1, S2 = T::S2, NB = T::NB, CL = T::CL;
  constexpr int NX = RES ? 2 * T::XP : T::XP;  // W1-ring positions before the weights: x (and attn)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sH = smem;
  unsigned char* ring1 = smem + T::ring1_off;
  unsigned char* ring2 = smem + T::ring2_off;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty1 = full1 + S1;
  uint64_t* full2 = empty1 + S1;
  uint64_t* empty2 = full2 + S2;
  uint64_t* hfull = empty2 + S2;
  uint64_t* hempty = hfull + NB;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, qd = lane & 3;
  const int m0 = blockIdx.x * T::ROWS, nchunks = a.f / T::FCH;
  if (tid == 0) {
    for (int s = 0; s < S1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 4 * CL);  // four warps of every block: fc1's (fc2 0's for the epilogue rows)
    }
    for (int s = 0; s < S2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 4 * CL);  // one fc2 warpgroup's warps of every block
    }
    for (int b = 0; b < NB; ++b) {
      mbar_init(&hfull[b], 128);  // every thread of the fc1 warpgroup
      mbar_init(&hempty[b], 8);   // every warp of the two fc2 warpgroups
    }
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers exist before any multicast or remote arrival
  // one arrival of this warp on the barrier at `bar`'s offset in every block of the cluster
  auto release = [&](uint64_t* bar) {
    __syncwarp();  // the warp's reads of the slot are done
    if (lane == 0)
      for (uint32_t cta = 0; cta < CL; ++cta) mbar_arrive_cluster(bar, cta);
  };

  if (wg == 0) {  // the producers: warp 0 feeds ring 1, warp 1 ring 2
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0 && tid != 32) return;
    const uint32_t rank = cluster_rank();
    const uint16_t mask = (1u << CL) - 1;
    if (tid == 0) {
      // the block's own x rows (K10: then its attn rows), RX a slot, for the
      // LN first and again after the weights for the epilogue's residual; a
      // block whose rows all lie past the end (the grid is a whole number of
      // clusters) reads rows from 0 instead and stores nothing
      const int mload = m0 < a.rows ? m0 : 0;
      int it = 0;
      auto acquire = [&]() {
        const int s = it % S1;
        if (it >= S1) mbar_wait(&empty1[s], (it / S1 - 1) & 1);
        mbar_expect_tx(&full1[s], T::SLOT1);
        return s;
      };
      auto load_rows = [&]() {
        for (int q = 0; q < NX; ++q, ++it) {
          const int s = acquire();
          for (int kb = 0; kb < T::KB; ++kb)
            tma_load_4d(ring1 + s * T::SLOT1 + kb * T::RX * 128, q < T::XP ? &mx : &ma, &full1[s], kb * 64,
                        mload + (q % T::XP) * T::RX, 0, 0);
        }
      };
      load_rows();
      // W1's rows f0.. f0 + FCH of each chunk in NP1 pieces along D; each
      // rank loads 1 / CL of every box's rows into every block at once
      constexpr int H1 = T::FCH / CL;
      for (int c = 0; c < nchunks; ++c)
        for (int p = 0; p < T::NP1; ++p, ++it) {
          const int s = acquire();
          for (int kb = 0; kb < T::KB1; ++kb)
            tma_load_4d_multicast(ring1 + s * T::SLOT1 + kb * T::FCH * 128 + rank * H1 * 128, &mw1, &full1[s],
                                  (p * T::KB1 + kb) * 64, c * T::FCH + rank * H1, 0, 0, mask);
        }
      load_rows();
      // stay until every block of the cluster has released the last slots:
      // their arrivals land on this block's barriers
      for (int j = it > S1 ? it - S1 : 0; j < it; ++j) mbar_wait(&empty1[j % S1], (j / S1) & 1);
    } else {
      // W2's columns f0.. f0 + FCH of each chunk, the rows of fc2 warpgroup p
      constexpr int H2 = T::N2 / CL;
      int it = 0;
      for (int c = 0; c < nchunks; ++c)
        for (int p = 0; p < 2; ++p, ++it) {
          const int s = it % S2;
          if (it >= S2) mbar_wait(&empty2[s], (it / S2 - 1) & 1);
          mbar_expect_tx(&full2[s], T::SLOT2);
          tma_load_4d_multicast(ring2 + s * T::SLOT2 + rank * H2 * 128, &mw2, &full2[s], c * T::FCH,
                                p * T::N2 + rank * H2, 0, 0, mask);
        }
      for (int j = it > S2 ? it - S2 : 0; j < it; ++j) mbar_wait(&empty2[j % S2], (j / S2) & 1);
    }
    return;
  }

  // the residual stream at (row r of the block, column col), a pair, from the
  // row tiles at ring-1 positions pos0..: x, or K10's x2 = x + attn * ls1
  // rounded as the TPU kernel rounds it (a product, then a sum)
  auto pair = [](const bf16* q) { return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q)); };
  auto row_at = [&](int pos0, int r, int col) {
    return ring1 + ((pos0 + r / T::RX) % S1) * T::SLOT1 + sw128_offset(r % T::RX, col, T::RX);
  };
  auto xin = [&](int pos0, int r, int col) {
    float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row_at(pos0, r, col)));
    if constexpr (RES) {
      const float2 at = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row_at(pos0 + T::XP, r, col)));
      const float2 l1 = pair(static_cast<const bf16*>(a.ls1) + col);
      v.x = __fadd_rn(v.x, __fmul_rn(at.x, l1.x));
      v.y = __fadd_rn(v.y, __fmul_rn(at.y, l1.y));
    }
    return v;
  };
  for (int q = 0; q < NX; ++q) mbar_wait(&full1[q], 0);

  if (wg == 1) {  // LN, fc1 and the GELU
    setmaxnreg_inc<FC1_REGS>();
    // LN(x), which the fc2 warpgroups wrote over the x rows, straight into
    // fc1's A registers: af[k] holds rows r, r + 8 at columns 16 k + 2 qd, + 1
    // and + 8 (wgmma.cuh)
    const int rw[2] = {warp * 16 + g, warp * 16 + g + 8};
    asm volatile("bar.sync 1, 384;\n" ::: "memory");  // LN(x) is in shared memory
    uint32_t af[D / 16][4];
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // e: (row h = e % 2, column half e / 2)
        af[k][e] = *reinterpret_cast<const uint32_t*>(row_at(0, rw[e % 2], 16 * k + 8 * (e / 2) + 2 * qd));
    for (int q = 0; q < NX; ++q) release(&empty1[q]);

    const uint32_t ring1_base = smem_addr(ring1);
    const bf16* B1 = static_cast<const bf16*>(a.b1) + 2 * qd;
    int it1 = NX;
    // No barrier wait (a spin loop) and no branch may sit between a product's
    // issue and its wait: ptxas then serialises every wgmma. So each step
    // waits for its slots and its hidden tile first, and the loop is peeled
    // so that every product it issues it also waits for.
    // fc1 of the next chunk into hc: this warpgroup's 64 rows x the chunk's 64
    // hidden columns, A from registers, W1's pieces from the ring
    auto fc1 = [&](float(&hc)[T::FCH / 2]) {
#pragma unroll
      for (int p = 0; p < T::NP1; ++p) mbar_wait(&full1[(it1 + p) % S1], ((it1 + p) / S1) & 1);
      fence_regs(hc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < T::NP1; ++p) {
        uint32_t w1 = ring1_base + ((it1 + p) % S1) * T::SLOT1;
        asm volatile("" : "+r"(w1));  // descriptors computed at their products, not all ahead
#pragma unroll
        for (int kk = 0; kk < T::KB1 * 4; ++kk)
          Wgmma<T::FCH>::rs(hc, af[p * T::KB1 * 4 + kk], sw128_desc_at(w1 + (kk / 4) * T::FCH * 128 + (kk % 4) * 32, 16),
                            p > 0 || kk > 0);
      }
      wgmma_commit();
    };
    auto fc1_done = [&](float(&hc)[T::FCH / 2]) {
      wgmma_wait<0>();
      fence_regs(hc);
#pragma unroll
      for (int p = 0; p < T::NP1; ++p) release(&empty1[(it1 + p) % S1]);
      it1 += T::NP1;
    };
    // hidden tile c % NB is free once fc2 has read what chunk c - NB left there
    auto tile_free = [&](int c) {
      if (c >= NB) mbar_wait(&hempty[c % NB], (c / NB - 1) & 1);
    };
    // chunk c's bias and GELU (fp32) into its hidden tile as bf16
    auto gelu_out = [&](int c, const float(&hc)[T::FCH / 2]) {
      unsigned char* hb = sH + (c % NB) * T::HB;
      const bf16* b1 = B1 + c * T::FCH;
#pragma unroll
      for (int j = 0; j < T::FCH / 8; ++j) {
        const float2 bb = pair(b1 + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(hb + sw128_offset(rw[h], 8 * j + 2 * qd, T::ROWS)) =
              pack_bf16(gelu<true>(hc[4 * j + 2 * h] + bb.x, TANH), gelu<true>(hc[4 * j + 2 * h + 1] + bb.y, TANH));
      }
      fence_async_shared();  // the tile is read next by fc2's wgmma
      mbar_arrive(&hfull[c % NB]);
    };
    // chunk c's GELU while fc1 of chunk c + 1 runs
    auto step = [&](int c, float(&cur)[T::FCH / 2], float(&next)[T::FCH / 2]) {
      tile_free(c);
      fc1(next);
      gelu_out(c, cur);
      fc1_done(next);
    };
    float hc0[T::FCH / 2], hc1[T::FCH / 2];
    fc1(hc0);
    fc1_done(hc0);
    int c = 0;
    for (; c + 2 < nchunks; c += 2) {
      step(c, hc0, hc1);
      step(c + 1, hc1, hc0);
    }
    if (c + 1 < nchunks) {  // two chunks left
      step(c, hc0, hc1);
      tile_free(c + 1);
      gelu_out(c + 1, hc1);
    } else {
      tile_free(c);
      gelu_out(c, hc0);
    }
    return;
  }

  // fc2: warpgroup p = wg - 2 owns output columns p N2.. of the block's 64
  // rows: acc += h W2[p N2.., chunk]^T over every chunk
  const int p = wg - 2;
  setmaxnreg_inc<FC2_REGS>();
  {  // first the LayerNorm of 8 rows a warp (fp32 statistics, two passes),
     // written as bf16 over its x rows; a lane holds columns 64 i + 2 lane, + 1
    float2 sc[T::KB], bi[T::KB];
#pragma unroll
    for (int i = 0; i < T::KB; ++i) {
      sc[i] = pair(static_cast<const bf16*>(a.lns) + 64 * i + 2 * lane);
      bi[i] = pair(static_cast<const bf16*>(a.lnb) + 64 * i + 2 * lane);
    }
#pragma unroll 2
    for (int r = p * 32 + warp * 8; r < p * 32 + warp * 8 + 8; ++r) {
      float2 v[T::KB];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < T::KB; ++i) {
        v[i] = xin(0, r, 64 * i + 2 * lane);
        sum += v[i].x + v[i].y;
      }
      const float mean = warp_sum(sum) / D;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < T::KB; ++i) var += (v[i].x - mean) * (v[i].x - mean) + (v[i].y - mean) * (v[i].y - mean);
      const float rstd = rsqrtf(warp_sum(var) / D + a.eps);
#pragma unroll
      for (int i = 0; i < T::KB; ++i)
        *reinterpret_cast<uint32_t*>(row_at(0, r, 64 * i + 2 * lane)) = pack_bf16(
            (v[i].x - mean) * rstd * sc[i].x + bi[i].x, (v[i].y - mean) * rstd * sc[i].y + bi[i].y);
    }
    asm volatile("bar.arrive 1, 384;\n" ::: "memory");
  }
  float acc[T::N2 / 2];
  const uint32_t h_base = smem_addr(sH), ring2_base = smem_addr(ring2);
  for (int c = 0; c < nchunks; ++c) {
    const int b = c % NB, pos = 2 * c + p, s = pos % S2;
    mbar_wait(&hfull[b], (c / NB) & 1);
    mbar_wait(&full2[s], (pos / S2) & 1);
    uint32_t hb = h_base + b * T::HB, w2 = ring2_base + s * T::SLOT2;
    asm volatile("" : "+r"(hb), "+r"(w2));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < T::FCH / 16; ++ks)
      Wgmma<T::N2>::ss(acc, sw128_desc_at(hb + ks * 32, 16), sw128_desc_at(w2 + ks * 32, 16), c > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&hempty[b]);
    release(&empty2[s]);
  }

  // out = x + ls2 * (acc + b2) in fp32, one rounding (K10: x2, unrounded),
  // from the row tiles the producer loaded again after the weights (ring-1
  // positions e0..) and written over their x rows, then stored by TMA (rows
  // past the end are not written)
  const int e0 = NX + T::NP1 * nchunks;
  for (int q = 0; q < NX; ++q) mbar_wait(&full1[(e0 + q) % S1], ((e0 + q) / S1) & 1);
  const bf16* B2 = static_cast<const bf16*>(a.b2);
  const bf16* LS2 = static_cast<const bf16*>(a.ls2);
#pragma unroll
  for (int j = 0; j < T::N2 / 8; ++j) {
    const int col = p * T::N2 + 8 * j + 2 * qd;
    const float2 bb = pair(B2 + col), ls = pair(LS2 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      const float2 xv = xin(e0, r, col);
      *reinterpret_cast<uint32_t*>(row_at(e0, r, col)) =
          pack_bf16(xv.x + (acc[4 * j + 2 * h] + bb.x) * ls.x, xv.y + (acc[4 * j + 2 * h + 1] + bb.y) * ls.y);
    }
    asm volatile("" ::: "memory");  // one column step at a time: no loads hoisted over the accumulators
  }
  fence_async_shared();  // the output tile is read next by TMA
  asm volatile("bar.sync 2, 256;\n" ::: "memory");  // both fc2 warpgroups have written theirs
  if (p == 0) {
    if (tid == 256 && m0 < a.rows) {
      for (int q = 0; q < T::XP; ++q)
        for (int kb = 0; kb < T::KB; ++kb)
          tma_store_4d(&mo, ring1 + ((e0 + q) % S1) * T::SLOT1 + kb * T::RX * 128, kb * 64, m0 + q * T::RX, 0, 0);
      tma_store_drain();
    }
    for (int q = 0; q < NX; ++q) release(&empty1[(e0 + q) % S1]);
  }
}

// The bf16 kernel at width D: one tensor map per operand, each a 2-D matrix
// read as a 4-D map of one head and one batch item (x and attn (rows, D) in
// boxes of a W1-ring slot's rows, W1 (F, D) and W2 (D, F) in boxes of 1 / CL
// of a piece's rows), then the launch on a whole number of clusters.
template <int D, bool RES, bool TANH>
int launch_tma(const MlpArgs& a, cudaStream_t st) {
  using T = MlpTiles<D>;
  if (a.d != D || a.f % T::FCH || a.f <= 0 || T::bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (a.rows == 0) return 0;
  const long long xs = (long long)a.rows * D, ws = (long long)a.f * D;
  CUtensorMap mx, ma, mw1, mw2;
  cudaError_t err = operand_map(&mx, a.x, D, a.rows, 1, 1, D, xs, xs, T::RX);
  if (err == cudaSuccess) err = operand_map(&ma, RES ? a.attn : a.x, D, a.rows, 1, 1, D, xs, xs, T::RX);
  if (err == cudaSuccess) err = operand_map(&mw1, a.w1, D, a.f, 1, 1, D, ws, ws, T::FCH / T::CL);
  if (err == cudaSuccess) err = operand_map(&mw2, a.w2, a.f, D, 1, 1, a.f, ws, ws, T::N2 / T::CL);
  CUtensorMap mo;
  if (err == cudaSuccess) err = operand_map(&mo, a.out, D, a.rows, 1, 1, D, xs, xs, T::RX);
  if (err != cudaSuccess) return (int)err;
  auto kernel = ln_mlp_tma<D, RES, TANH>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.rows + T::ROWS - 1) / T::ROWS;
  kernel<<<(tiles + T::CL - 1) / T::CL * T::CL, MLP_WG_THREADS, T::bytes, st>>>(mx, ma, mw1, mw2, mo, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_k2_tma(const MlpArgs& a, cudaStream_t st) {
  return a.tanh_gelu ? launch_tma<D, false, true>(a, st) : launch_tma<D, false, false>(a, st);
}

// The bf16 plan at width D (MlpTiles): out[0..6] = rows a block, blocks a
// cluster, hidden columns a chunk, the W1 ring's and the W2 ring's stages,
// dynamic shared memory in bytes, and the bytes of W1 and W2 read from L2
// per 1000 rows at F = 4 D (each cluster reads both matrices once).
template <int D>
void mlp_plan(int* out) {
  using T = MlpTiles<D>;
  const long long weights = 2LL * D * (4 * D) * 2;
  const int p[7] = {T::ROWS, T::CL, T::FCH, T::S1, T::S2, (int)T::bytes, (int)(weights * 1000 / (T::ROWS * T::CL))};
  for (int i = 0; i < 7; ++i) out[i] = p[i];
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
      case 64: return cs::launch_k2_tma<64>(a, st);
      case 384: return cs::launch_k2_tma<384>(a, st);
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
      case 64: return cs::launch_tma<64, true, true>(a, st);
      case 384: return cs::launch_tma<384, true, true>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return d <= 512 ? cs::launch_f32<32, true>(a, st) : cs::launch_f32<16, true>(a, st);
}

// The bf16 plan of width d (64 or 384) into out[0..6]; see cs::mlp_plan.
extern "C" int cs_fused_ln_mlp_plan(int d, int* out) {
  switch (d) {
    case 64: cs::mlp_plan<64>(out); return 0;
    case 384: cs::mlp_plan<384>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}
