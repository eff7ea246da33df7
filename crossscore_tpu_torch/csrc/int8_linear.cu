// Q1 and Q2: the W8A8 dynamic int8 linear of the backbone
// (model.gpu.backbone_quant=int8; ops/quant.py).
//
// Neither replaces a Pallas kernel: the JAX package's int8 path
// (crossscore_tpu/ops/quant.py:35-58, `quantize_rowwise`, `quantize_colwise`,
// `int8_matmul`) is left to XLA, which fuses the dequantisation into the
// product's epilogue. PyTorch has no such fusion: torch._int_mm writes its
// int32 products to memory, twice the bytes of a bf16 output, and the
// dequantisation reads them back. So the port computes both halves itself.
//
// Q1, `quantize_rows_kernel`: (rows, K) fp32 or bf16 -> int8 codes and one
// fp32 scale a row, s = max(absmax, 1e-8) / 127 and q = clamp(rn(x / s),
// -127, 127), both divisions IEEE (__fdiv_rn) and the rounding half to even
// (__float2int_rn), as the plain version and JAX compute them (the build has
// no --use_fast_math). One warp a row: a shuffle absmax over 4-element
// vector loads, then a second pass over the row (from L1/L2) for the codes.
// Bound on the H100: bytes, rows K (2 or 4) in, rows K out.
//
// Q2, `int8_linear_kernel<T>`: int8 A (M, K) row major times the int8 weight
// (N, K) as stored, then out = rn_T((float(acc) * sx[m]) * sw[n]) and, with a
// bias, rn_T(out + bias[n]) in the output's type T (bf16 or fp32): the plain
// version's order, each step rounded (__fmul_rn, __fadd_rn: no FMA
// contraction). T = int is Q2's int32 form (below). Neither form replaces a
// Pallas kernel: XLA runs the JAX package's `int8_matmul`
// (crossscore_tpu/ops/quant.py:51-58).
// Bound on the H100: bytes. At the backbone's products the 2 M N K
// operations at 1,979 TOP/s take less time than moving A, W and above all the
// output (fc1 over 98,640 rows writes 303 MB of bf16, 606 MB of int32, against
// 38 MB of A), so the kernel has to keep the output stream going while it
// multiplies, and read its operands once.
// The design, for Hopper:
// - Products on wgmma.mma_async m64n128k32.s32.s8.s8, both operands K-major
//   in shared memory as the 8-bit forms require: A's rows and the weight's
//   rows as stored, 128-byte swizzled, nothing transposed.
// - 128 x 128 output tiles: two consumer warpgroups of 64 rows each (64
//   int32 accumulators a thread) and a producer warpgroup, whose registers go
//   to the consumers (setmaxnreg) and one of whose threads issues every TMA
//   load into an mbarrier ring of 128-byte K chunks. TMA zero-fills the boxes
//   past M, N and K (K % 32 == 0, N % 8 == 0, any M).
// - Persistent blocks: one a SM (227 KB of shared memory each), each taking
//   one contiguous run of the row-major tile order (the runs differ by at
//   most one tile), so that a block's consecutive tiles share their A rows.
// - K <= 384 (qkv, out and fc1 of dinov2-small, every product of
//   dinov2-test, the tensor-parallel row shards at K 96-256): a block keeps
//   its A tile's whole K resident (16 KB a 128-byte chunk at 128 rows, three
//   chunks at most) in one of two slots, loaded once per run of tiles on
//   those rows while the other slot is in use, and streams the weight's
//   column tiles from L2 (the weights are at most 8 MB). A is read from
//   device memory once (twice for the rows at a run's start). A tile's K
//   chunks (one instantiation for each count, 1-3) are one chain of products,
//   waited for once; past K the last chunk's boxes read as zeros.
// - Larger K (fc2, and dinov2-base / -large): a ring stage holds one chunk
//   of A and one of the weight, multiplied as it arrives; consecutive tiles
//   of a block read the same A chunks, so the repeat reads hit L2.
// - The epilogue: the scales and the bias of a thread's columns are loaded
//   before the products; each warpgroup then dequantises its 64 x 128
//   accumulators into a staged tile in shared memory (128-byte swizzled
//   boxes, no bank conflicts; 4-byte outputs in two halves of 64 columns)
//   and one thread stores it with asynchronous TMA bulk stores, which run on
//   beside the next tile's products. The producer fills the ring while the
//   warpgroups dequantise. (A second staging buffer a warpgroup, tried at
//   one and two resident chunks, where the stores bind, moved nothing.)
// - Ring depth: as many stages as fit beside the staged tiles and the A
//   slots, for every output type: 6 with K streamed or three resident
//   chunks, 8 with two, 10 with one.
// - What binds it (tools/matmul_microbench.py --against, chip_smoke.py
//   steps 21 and 22): the warpgroups work in step, so the tensor cores wait
//   while they dequantise, whose conversions (int to fp32, fp32 to bf16) run
//   at a quarter of the FMA rate; at fc2's K 1536, the L2 reads of the
//   streamed chunks (A again for each column tile, the weight for each row
//   tile). Q2's int32 form is bound by its output stream (4 bytes an
//   output).
//
// The split forms of the tensor-parallel row layer (parallel/tensor_parallel.py:
// `attention.output.dense` and `fc2` under `tp`, whose input features and
// weight columns are sharded over the model group). The JAX package takes each
// token's absmax over the whole feature axis and sums the int32 partial
// products exactly before the dequantisation (GSPMD), so a rank cannot run Q1
// or Q2 whole on its shard:
// - Q1a, `row_absmax_kernel`: Q1's first pass alone, the fp32 max |x| of each
//   row of the shard; the wrapper all-reduces it (MAX) over the group;
// - Q1b, `quantize_given_kernel`: Q1's second pass from a given absmax m,
//   s = max(m, 1e-8) / 127 (__fdiv_rn) and the codes as Q1 rounds them, so
//   Q1a over a whole row, then Q1b, is Q1 bit for bit;
// - Q2's int32 form (`int8_linear_kernel` with T = int): Q2's kernel, its
//   epilogue staging the int32 accumulators as they are (exact in any order
//   of the sums); the wrapper all-reduces them (SUM) and dequantises in Q2's
//   order.
// Bound on the H100: bytes, as Q1 and Q2 (Q2's int32 form writes 4 bytes an
// output). Simple forms: the split costs Q1 a second read of x and Q2 its
// int32 output, which is later work to fuse.

#include <limits.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kQ1Warps = 8;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ int code(float v, float s) {
  return min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
}

// the absmax of one row, reduced over its warp (every lane gets it)
template <typename T>
__device__ __forceinline__ float warp_row_absmax(const T* xr, int k, int lane) {
  float amax = 0.f;
  for (int c = lane * 4; c < k; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  return amax;
}

// one row's codes at the scale sc, by its warp
template <typename T>
__device__ __forceinline__ void warp_row_codes(const T* xr, int8_t* qr, int k, float sc, int lane) {
  for (int c = lane * 4; c < k; c += 128) {
    float v[4];
    load4(xr + c, v);
    *reinterpret_cast<char4*>(qr + c) =
        make_char4((signed char)code(v[0], sc), (signed char)code(v[1], sc), (signed char)code(v[2], sc),
                   (signed char)code(v[3], sc));
  }
}

template <typename T>
__global__ void __launch_bounds__(kQ1Warps * 32)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                         long long rows, int k, float qmax) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kQ1Warps + threadIdx.x / 32;
  if (row >= rows) return;
  const float sc = __fdiv_rn(fmaxf(warp_row_absmax(x + row * k, k, lane), 1e-8f), qmax);
  warp_row_codes(x + row * k, q + row * k, k, sc, lane);
  if (lane == 0) s[row] = sc;
}

// Q1a: m[row] = max |x[row]|
template <typename T>
__global__ void __launch_bounds__(kQ1Warps * 32)
    row_absmax_kernel(const T* __restrict__ x, float* __restrict__ m, long long rows, int k) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kQ1Warps + threadIdx.x / 32;
  if (row >= rows) return;
  const float amax = warp_row_absmax(x + row * k, k, lane);
  if (lane == 0) m[row] = amax;
}

// Q1b: Q1's codes and scale of each row from its given absmax m[row]
template <typename T>
__global__ void __launch_bounds__(kQ1Warps * 32)
    quantize_given_kernel(const T* __restrict__ x, const float* __restrict__ m, int8_t* __restrict__ q,
                          float* __restrict__ s, long long rows, int k) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kQ1Warps + threadIdx.x / 32;
  if (row >= rows) return;
  const float sc = __fdiv_rn(fmaxf(m[row], 1e-8f), 127.f);
  warp_row_codes(x + row * k, q + row * k, k, sc, lane);
  if (lane == 0) s[row] = sc;
}

// Q2's shape: 128 x 128 output tiles (two consumer warpgroups of 64 rows, one
// producer warpgroup), K in 128-byte chunks (one swizzled row, four k32 steps)
constexpr int kBM = 128, kBN = 128, kKC = 128;
constexpr int kConsumers = 256, kQ2Threads = cs::WG_THREADS;  // two consumer warpgroups, then the producer
constexpr int kChunkA = kBM * kKC;           // one K chunk of A's tile, bytes
constexpr int kChunkW = kBN * kKC;           // one K chunk of the weight's tile
constexpr int kOutBox = 64 * 128;            // a staged box: 64 rows x 128 bytes
constexpr int kSmemMax = 232448;             // a block's shared memory on the H100
constexpr int kBarBytes = 256;

// Shared memory of one instantiation, after 1024-byte alignment: the two
// warpgroups' staged output tiles, the two A slots (resident K only), the
// ring, the barriers. RC: the K chunks of a resident A tile (1-3), or 0 when
// K streams through the ring with A.
template <typename T, int RC>
struct Q2Layout {
  // a warpgroup's 64 x 128 outputs are staged whole (bf16) or in two halves
  // of 64 columns (4-byte outputs), so that the ring keeps its depth
  static constexpr int kHalves = sizeof(T) == 4 ? 2 : 1;
  static constexpr int kColsH = kBN / kHalves;
  static constexpr int kOutBoxes = kColsH * (int)sizeof(T) / 128;  // boxes a warpgroup's staged half
  static constexpr int kOut = 2 * kOutBoxes * kOutBox;
  static constexpr int kASlot = RC * kChunkA;
  static constexpr int kA = 2 * kASlot;
  static constexpr int kStage = (RC ? 0 : kChunkA) + kChunkW;
  static constexpr int kStages = (kSmemMax - 1024 - kBarBytes - kOut - kA) / kStage;
  static constexpr int kSmem = 1024 + kOut + kA + kStages * kStage + kBarBytes;
  static_assert(kStages > (RC ? RC : 1) && (2 * kStages + 4) * 8 <= kBarBytes, "Q2's ring");
};

// two adjacent outputs of one row, in the plain version's order: y =
// rn_T((float(acc) * s) * w), then with a bias rn_T(y + b) (the sum in fp32);
// each step rounded (__fmul_rn, __fadd_rn: no FMA contraction); a bf16 pair
// is rounded by one cvt.rn.bf16x2, the same bits as two roundings
__device__ __forceinline__ void dequant2(__nv_bfloat16* p, int a0, int a1, float s, float2 w, bool has_bias,
                                         float2 b) {
  __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(__int2float_rn(a0), s), w.x),
                                           __fmul_rn(__fmul_rn(__int2float_rn(a1), s), w.y));
  if (has_bias) {
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(__fadd_rn(f.x, b.x), __fadd_rn(f.y, b.y));
  }
  *reinterpret_cast<__nv_bfloat162*>(p) = y;
}
__device__ __forceinline__ void dequant2(float* p, int a0, int a1, float s, float2 w, bool has_bias, float2 b) {
  float y0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), s), w.x), y1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), s), w.y);
  if (has_bias) {
    y0 = __fadd_rn(y0, b.x);
    y1 = __fadd_rn(y1, b.y);
  }
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}

// two adjacent int32 products, as they are (Q2's int32 form)
__device__ __forceinline__ void store2(int* p, int a, int b) { *reinterpret_cast<int2*>(p) = make_int2(a, b); }

// two adjacent values of T as one load, and widened to fp32 (exactly)
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 zero() { return __float2bfloat162_rn(0.f); }
};
template <>
struct Pair<int> {  // Q2's int32 form: no bias
  using type = int2;
  static __device__ __forceinline__ int2 zero() { return make_int2(0, 0); }
};
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// element (row, col) of a warpgroup's staged 64-row tile of T: 128-byte
// boxes of 64 rows side by side, each 128-byte swizzled as the output's
// tensor map stores it (16-byte chunk index XOR row % 8)
template <typename T>
__device__ __forceinline__ T* staged(unsigned char* tile, int row, int col) {
  const int byte = col * (int)sizeof(T), in = byte % 128;
  return reinterpret_cast<T*>(tile + (byte / 128) * kOutBox + row * 128 + ((((in >> 4) ^ (row & 7)) << 4) | (in & 15)));
}

// the 128 threads of consumer warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <typename T, int RC>
__global__ void __launch_bounds__(kQ2Threads, 1)
    int8_linear_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_out, const float* __restrict__ sx,
                       const float* __restrict__ sw, const T* __restrict__ bias, int m, int n, int k) {
  using L = Q2Layout<T, RC>;
  constexpr int S = L::kStages;
  constexpr bool RESIDENT = RC > 0;
  // T = int: Q2's int32 form, the accumulators stored as they are (sx, sw and
  // bias unused)
  constexpr bool kRaw = std::is_same_v<T, int>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = cs::smem_1024(smem_raw);
  unsigned char* out_tiles = smem;
  unsigned char* a_slots = smem + L::kOut;
  unsigned char* ring = a_slots + L::kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::kStage);
  uint64_t* empty = full + S;
  uint64_t* a_full = empty + S;  // the A slots (resident K)
  uint64_t* a_empty = a_full + 2;

  const int tid = threadIdx.x;
  // K chunks a tile: at resident K the instantiation's, so that a tile's
  // products are one straight chain
  const int kc = RESIDENT ? RC : (k + kKC - 1) / kKC;
  const int nt = (n + kBN - 1) / kBN;
  // this block's run [t0, t1) of the row-major tile order (tiles < 2^31: the launch checks)
  const int tiles = (m + kBM - 1) / kBM * nt;
  const int t0 = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      cs::mbar_init(&full[s], 1);
      cs::mbar_init(&empty[s], 8);  // the two consumer warpgroups' eight warps
    }
    for (int s = 0; s < 2; ++s) {
      cs::mbar_init(&a_full[s], 1);
      cs::mbar_init(&a_empty[s], 8);
    }
    cs::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: its registers go to the consumers, one thread issues every load
    cs::setmaxnreg_dec<cs::PRODUCER_REGS>();
    if (tid != kConsumers) return;
    int it = 0, ai = 0, mb = t0 / nt, nb = t0 % nt;
    for (int t = t0; t < t1; ++t) {
      if constexpr (RESIDENT) {
        if (t == t0 || nb == 0) {  // the tile's A rows, every K chunk, into the next slot once it is free
          const int slot = ai & 1;
          if (ai >= 2) cs::mbar_wait(&a_empty[slot], ((ai >> 1) - 1) & 1);
          cs::mbar_expect_tx(&a_full[slot], RC * kChunkA);
#pragma unroll
          for (int c = 0; c < RC; ++c)
            cs::tma_load_2d(a_slots + slot * L::kASlot + c * kChunkA, &map_a, &a_full[slot], c * kKC, mb * kBM);
          ++ai;
        }
      }
      for (int c = 0; c < kc; ++c, ++it) {
        const int s = it % S;
        if (it >= S) cs::mbar_wait(&empty[s], (it / S - 1) & 1);
        cs::mbar_expect_tx(&full[s], L::kStage);
        unsigned char* st = ring + s * L::kStage;
        if constexpr (!RESIDENT) {
          cs::tma_load_2d(st, &map_a, &full[s], c * kKC, mb * kBM);
          st += kChunkA;
        }
        cs::tma_load_2d(st, &map_w, &full[s], c * kKC, nb * kBN);
      }
      if (++nb == nt) {
        nb = 0;
        ++mb;
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  cs::setmaxnreg_inc<cs::CONSUMER_REGS>();
  const int wg = tid / 128, ltid = tid % 128, warp = ltid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int r_lo = warp * 16 + g;  // this thread's rows of the warpgroup's 64: r_lo, r_lo + 8
  unsigned char* out_tile = out_tiles + wg * L::kOutBoxes * kOutBox;
  int it = 0, ai = 0, slot = 0, mb = t0 / nt, nb = t0 % nt;
  int acc[kBN / 2];
  for (int t = t0; t < t1; ++t) {
    const long long row0 = (long long)mb * kBM + wg * 64;
    // the epilogue's operands, loaded while the products run: the rows'
    // scales, and the weight scales and the bias of this thread's columns
    float s_lo = 0.f, s_hi = 0.f;
    float2 w[kBN / 8];
    typename Pair<T>::type b[kBN / 8];
    if constexpr (!kRaw) {
      if (row0 + r_lo < m) s_lo = sx[row0 + r_lo];
      if (row0 + r_lo + 8 < m) s_hi = sx[row0 + r_lo + 8];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int gc = nb * kBN + j * 8 + 2 * q;  // n % 8 == 0: the pair is whole or out
        w[j] = make_float2(0.f, 0.f);
        b[j] = Pair<T>::zero();
        if (gc < n) {
          w[j] = *reinterpret_cast<const float2*>(sw + gc);
          if (bias != nullptr) b[j] = *reinterpret_cast<const typename Pair<T>::type*>(bias + gc);
        }
      }
    }
    if constexpr (RESIDENT) {
      // the tile's RC chunks as one chain of products, waited for once
      if (t == t0 || nb == 0) {
        slot = ai & 1;
        cs::mbar_wait(&a_full[slot], (ai >> 1) & 1);
        ++ai;
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) cs::mbar_wait(&full[(it + c) % S], ((it + c) / S) & 1);
      cs::wgmma_fence();
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const uint32_t a_addr = cs::smem_addr(a_slots + slot * L::kASlot + c * kChunkA + wg * 64 * kKC);
        const uint32_t w_addr = cs::smem_addr(ring + ((it + c) % S) * L::kStage);
#pragma unroll
        for (int kk = 0; kk < kKC / 32; ++kk)
          cs::WgmmaS8<kBN>::ss(acc, cs::sw128_desc_at(a_addr + kk * 32, 16), cs::sw128_desc_at(w_addr + kk * 32, 16),
                               c > 0 || kk > 0);
      }
      cs::wgmma_commit();
      cs::wgmma_wait<0>();
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < RC; ++c) cs::mbar_arrive(&empty[(it + c) % S]);
        if (t + 1 == t1 || nb + 1 == nt) cs::mbar_arrive(&a_empty[slot]);  // the rows' last tile
      }
      it += RC;
    } else {
      // K streams through the ring: both warpgroups multiply each chunk as it
      // arrives (a tile's chunks outnumber the stages)
      for (int c = 0; c < kc; ++c, ++it) {
        const int s = it % S;
        cs::mbar_wait(&full[s], (it / S) & 1);
        const uint32_t a_addr = cs::smem_addr(ring + s * L::kStage + wg * 64 * kKC);
        const uint32_t w_addr = cs::smem_addr(ring + s * L::kStage + kChunkA);
        cs::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 32; ++kk)
          cs::WgmmaS8<kBN>::ss(acc, cs::sw128_desc_at(a_addr + kk * 32, 16), cs::sw128_desc_at(w_addr + kk * 32, 16),
                               c > 0 || kk > 0);
        cs::wgmma_commit();
        cs::wgmma_wait<0>();
        if (lane == 0) cs::mbar_arrive(&empty[s]);
      }
    }
    cs::fence_regs(acc);

    // the epilogue: dequantise into the staged tile (or half), then one
    // thread's TMA stores
#pragma unroll
    for (int h = 0; h < L::kHalves; ++h) {
      if (ltid == 0) cs::bulk_wait_read<0>();  // the previous stores have read the staged tile
      warpgroup_sync(wg);
#pragma unroll
      for (int jj = 0; jj < L::kColsH / 8; ++jj) {
        const int j = h * (L::kColsH / 8) + jj, col = jj * 8 + 2 * q;
        if constexpr (kRaw) {
          store2(staged<T>(out_tile, r_lo, col), acc[4 * j], acc[4 * j + 1]);
          store2(staged<T>(out_tile, r_lo + 8, col), acc[4 * j + 2], acc[4 * j + 3]);
        } else {
          const float2 bj = widen(b[j]);
          dequant2(staged<T>(out_tile, r_lo, col), acc[4 * j], acc[4 * j + 1], s_lo, w[j], bias != nullptr, bj);
          dequant2(staged<T>(out_tile, r_lo + 8, col), acc[4 * j + 2], acc[4 * j + 3], s_hi, w[j], bias != nullptr,
                   bj);
        }
      }
      cs::fence_async_shared();  // the staged tile, visible to the TMA stores
      warpgroup_sync(wg);
      if (ltid == 0 && row0 < m) {
        for (int x = 0; x < L::kOutBoxes; ++x) {
          const int c0 = nb * kBN + h * L::kColsH + x * (128 / (int)sizeof(T));
          if (c0 < n) cs::tma_store_2d(&map_out, out_tile + x * kOutBox, c0, (int)row0);
        }
        cs::bulk_commit();
      }
    }
    if (++nb == nt) {
      nb = 0;
      ++mb;
    }
  }
  if (ltid == 0) cs::bulk_wait_all();
}

template <typename T>
int launch_quantize(const void* x, void* q, void* s, long long rows, int k, float qmax, cudaStream_t st) {
  const long long blocks = (rows + kQ1Warps - 1) / kQ1Warps;
  if (rows <= 0) return 0;
  quantize_rows_kernel<T><<<(unsigned)blocks, kQ1Warps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), rows, k, qmax);
  return (int)cudaGetLastError();
}

template <typename T>
constexpr CUtensorMapDataType out_type() {
  if constexpr (std::is_same_v<T, int>) return CU_TENSOR_MAP_DATA_TYPE_INT32;
  if constexpr (std::is_same_v<T, float>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int RC>
int launch_q2(const void* a, const void* sx, const void* w, const void* sw, const void* bias, void* out, int m,
              int n, int k, cudaStream_t st) {
  using L = Q2Layout<T, RC>;
  auto kernel = int8_linear_kernel<T, RC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap ma, mw, mo;
  cudaError_t e = cs::matrix_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, k, m, k, kKC, kBM);
  if (e == cudaSuccess) e = cs::matrix_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k, n, k, kKC, kBN);
  if (e == cudaSuccess)
    e = cs::matrix_map(&mo, out_type<T>(), out, n, m, (long long)n * sizeof(T), 128 / (int)sizeof(T), 64);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);  // persistent: one block a SM at most
  kernel<<<grid, kQ2Threads, L::kSmem, st>>>(ma, mw, mo, static_cast<const float*>(sx),
                                             static_cast<const float*>(sw), static_cast<const T*>(bias), m, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_linear(const void* a, const void* sx, const void* w, const void* sw, const void* bias, void* out,
                  long long m, int n, int k, cudaStream_t st) {
  if (m <= 0) return 0;
  if (m > INT_MAX - kBM) return (int)cudaErrorInvalidValue;
  switch ((k + kKC - 1) / kKC) {  // A resident at 1-3 K chunks, else K streamed
    case 1:
      return launch_q2<T, 1>(a, sx, w, sw, bias, out, (int)m, n, k, st);
    case 2:
      return launch_q2<T, 2>(a, sx, w, sw, bias, out, (int)m, n, k, st);
    case 3:
      return launch_q2<T, 3>(a, sx, w, sw, bias, out, (int)m, n, k, st);
    default:
      return launch_q2<T, 0>(a, sx, w, sw, bias, out, (int)m, n, k, st);
  }
}

template <typename T>
int launch_absmax(const void* x, void* m, long long rows, int k, cudaStream_t st) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kQ1Warps - 1) / kQ1Warps;
  row_absmax_kernel<T><<<(unsigned)blocks, kQ1Warps * 32, 0, st>>>(static_cast<const T*>(x), static_cast<float*>(m),
                                                                    rows, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_given(const void* x, const void* m, void* q, void* s, long long rows, int k, cudaStream_t st) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kQ1Warps - 1) / kQ1Warps;
  quantize_given_kernel<T><<<(unsigned)blocks, kQ1Warps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(m), static_cast<int8_t*>(q), static_cast<float*>(s), rows,
      k);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, k) row major, fp32 or bf16 (dtype code), k % 4 == 0; q: (rows,
// k) int8; s: (rows,) fp32. qmax is 127 (another value plants a fault).
extern "C" int cs_quantize_rows(const void* x, void* q, void* s, long long rows, int k, float qmax, int dtype,
                                void* stream) {
  if (k <= 0 || k % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::kBFloat16) return launch_quantize<__nv_bfloat16>(x, q, s, rows, k, qmax, st);
  if (dtype == cs::kFloat32) return launch_quantize<float>(x, q, s, rows, k, qmax, st);
  return (int)cudaErrorInvalidValue;
}

// a: (m, k) int8, sx: (m,) fp32, w: (n, k) int8, sw: (n,) fp32, bias: (n,)
// of the output's dtype or null; out: (m, n) fp32 or bf16 (dtype code).
// k % 32 == 0, n % 8 == 0, every pointer 16-byte aligned.
extern "C" int cs_int8_linear(const void* a, const void* sx, const void* w, const void* sw, const void* bias,
                              void* out, long long m, int n, int k, int dtype, void* stream) {
  if (k <= 0 || k % 32 || n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::kBFloat16) return launch_linear<__nv_bfloat16>(a, sx, w, sw, bias, out, m, n, k, st);
  if (dtype == cs::kFloat32) return launch_linear<float>(a, sx, w, sw, bias, out, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

// Q1a. x: (rows, k) row major, fp32 or bf16 (dtype code), k % 4 == 0; m: (rows,) fp32.
extern "C" int cs_row_absmax(const void* x, void* m, long long rows, int k, int dtype, void* stream) {
  if (k <= 0 || k % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::kBFloat16) return launch_absmax<__nv_bfloat16>(x, m, rows, k, st);
  if (dtype == cs::kFloat32) return launch_absmax<float>(x, m, rows, k, st);
  return (int)cudaErrorInvalidValue;
}

// Q1b. x: (rows, k) as Q1a; m: (rows,) fp32, each row's absmax; q: (rows, k)
// int8; s: (rows,) fp32.
extern "C" int cs_quantize_rows_given(const void* x, const void* m, void* q, void* s, long long rows, int k, int dtype,
                                      void* stream) {
  if (k <= 0 || k % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cs::kBFloat16) return launch_given<__nv_bfloat16>(x, m, q, s, rows, k, st);
  if (dtype == cs::kFloat32) return launch_given<float>(x, m, q, s, rows, k, st);
  return (int)cudaErrorInvalidValue;
}

// Q2's int32 form. a: (m, k) int8, w: (n, k) int8; out: (m, n) int32, the
// exact products. k % 32 == 0, n % 8 == 0, every pointer 16-byte aligned.
extern "C" int cs_int8_matmul_s32(const void* a, const void* w, void* out, long long m, int n, int k, void* stream) {
  if (k <= 0 || k % 32 || n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  return launch_linear<int>(a, nullptr, w, nullptr, nullptr, out, m, n, k, static_cast<cudaStream_t>(stream));
}
