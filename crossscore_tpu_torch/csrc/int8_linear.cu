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
// Q2, `int8_linear_kernel`: int8 A (M, K) row major times the int8 weight
// (N, K), which is mma's "col" operand as stored, on
// mma.sync.m16n8k32.s32.s8.s8.s32, then out = rn_T((float(acc) * sx[m]) *
// sw[n]) and, with a bias, rn_T(out + bias[n]) in the output's type T (bf16
// or fp32): the plain version's order, each step rounded (__fmul_rn,
// __fadd_rn: no FMA contraction). 128 x 128 output tiles, 8 warps of 32 x 64,
// K in 64-byte slices through a 4-stage cp.async ring (rows padded to 80
// bytes: ldmatrix reads without bank conflicts), ldmatrix fragments; the
// output tile is staged in shared memory and stored in 16-byte row pieces.
// M is predicated (zero rows), K % 32 == 0 and N % 8 == 0 (the wrapper
// raises otherwise). Bound on the H100: at the backbone's shapes the bytes
// (A, W, the output; the int32 products never leave the registers) over the
// 2 M N K operations at 1,979 TOP/s. A simple kernel: on an H100 80GB HBM3 at
// 700 W it reads 279-433 TOP/s at dinov2-small's products over 98,640 rows
// (chip_smoke.py step 21); other tiles (64-256 rows or columns, warps of
// 64 x 64) were slower and 3 stages within noise; wgmma.s8 with TMA is later
// work.
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
// - Q2's int32 form (`int8_linear_kernel` with T = int): Q2's main loop, its
//   epilogue storing the int32 accumulators as they are; the wrapper
//   all-reduces them (SUM) and dequantises in Q2's order.
// Bound on the H100: bytes, as Q1 and Q2 (Q2's int32 form writes 4 bytes an
// output). Simple forms: the split costs Q1 a second read of x and Q2 its
// int32 output, which is later work to fuse.

#include <type_traits>

#include "mma.cuh"

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

// Q2's tile: BM x BN outputs a block, warps of WM x WN, K in 64-byte stages
// through a STAGES-deep cp.async ring.
constexpr int kBM = 128, kBN = 128, kWM = 32, kWN = 64, kStages = 4;
constexpr int kBK = 64;         // K bytes a stage
constexpr int kLds = kBK + 16;  // padded row of a shared tile, bytes

template <int BM, int BN, int WM, int WN, int STAGES>
struct Tile {
  static constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  static constexpr int kThreads = kWarpsM * kWarpsN * 32;
  static constexpr int kMt = WM / 16, kNt = WN / 8;  // mma tiles a warp
  static constexpr int kStageBytes = (BM + BN) * kLds;
  // two blocks of up to 8 warps an SM while the accumulators fit in 64
  // registers a thread
  static constexpr int kMinBlocks = kThreads <= 256 && kMt * kNt * 4 <= 64 ? 2 : 1;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BM % WM == 0 && BN % WN == 0, "tile shape");
  // the staged output tile's padded row, elements of T
  template <typename T>
  static constexpr int kOutLd = BN + 16 / (int)sizeof(T);
  template <typename T>
  static constexpr int smem_bytes() {
    const int ring = STAGES * kStageBytes, out = BM * kOutLd<T> * (int)sizeof(T);
    return out > ring ? out : ring;
  }
};

// rows [r0, r0 + ROWS) x bytes [k0, k0 + 64) of a row-major int8 matrix into a
// stage tile; rows at or past `nrows` and bytes at or past `k` zero-filled
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, long long r0, long long nrows, int k,
                                          int k0, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * (kBK / 16); i += NTHREADS) {
    const int rr = i / (kBK / 16), cc = (i % (kBK / 16)) * 16;
    const long long g = r0 + rr;
    const bool ok = g < nrows && k0 + cc < k;
    cs::cp_async16(dst + rr * kLds + cc, src + (ok ? g * k + k0 + cc : 0), ok ? 16 : 0);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) { *reinterpret_cast<int2*>(p) = make_int2(a, b); }

// the epilogue of one accumulator: the plain version's roundings in order
template <typename T>
__device__ __forceinline__ T dequant(int acc, float sx, float sw, const T* bias, int n) {
  const T y = cs::from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw));
  if (bias == nullptr) return y;
  return cs::from_f32<T>(__fadd_rn(cs::to_f32(y), cs::to_f32(bias[n])));
}

template <typename T, int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN, STAGES>::kThreads, Tile<BM, BN, WM, WN, STAGES>::kMinBlocks)
    int8_linear_kernel(const int8_t* __restrict__ a, const float* __restrict__ sx, const int8_t* __restrict__ w,
                       const float* __restrict__ sw, const T* __restrict__ bias, T* __restrict__ out, long long m,
                       int n, int k) {
  using C = Tile<BM, BN, WM, WN, STAGES>;
  constexpr int NT = C::kThreads, MT = C::kMt, NT8 = C::kNt;
  // T = int: Q2's int32 form, the accumulators stored as they are (sx, sw and
  // bias unused)
  constexpr bool kRaw = std::is_same_v<T, int>;
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int n_tiles = (n + BN - 1) / BN;
  // consecutive blocks share one A tile (the large operand) over the N tiles
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k_tiles = (k + kBK - 1) / kBK;

  auto stage_a = [&](int s) { return smem + s * C::kStageBytes; };
  auto stage_b = [&](int s) { return smem + s * C::kStageBytes + BM * kLds; };
  auto load_stage = [&](int s, int kt) {
    load_tile<BM, NT>(stage_a(s), a, m0, m, k, kt * kBK, tid);
    load_tile<BN, NT>(stage_b(s), w, n0, n, k, kt * kBK, tid);
  };

  int acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cs::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cs::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_stage(next % STAGES, next);
    cs::cp_async_commit();
    const int8_t* ta = stage_a(kt % STAGES) + (wm * WM) * kLds;
    const int8_t* tb = stage_b(kt % STAGES) + (wn * WN) * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t fa[MT][4], fb[NT8 / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        cs::ldsm_x4(fa[i], ta + (i * 16 + lane % 16) * kLds + kk + (lane / 16) * 16);
#pragma unroll
      for (int j = 0; j < NT8 / 2; ++j)
        cs::ldsm_x4(fb[j], tb + (j * 16 + lane % 8 + (lane / 16) * 8) * kLds + kk + ((lane / 8) % 2) * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT8; ++j) cs::mma_s8(acc[i][j], fa[i], fb[j / 2][(j % 2) * 2], fb[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cs::cp_async_wait<0>();

  const int g = lane / 4, q = lane % 4;
  // the tile goes through shared memory, then out in 16-byte row pieces
  constexpr int LD = C::template kOutLd<T>;
  T* tile = reinterpret_cast<T*>(smem);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * WM + i * 16 + g + h * 8;
      const long long r = m0 + rl;
      float sr = 0.f;
      if constexpr (!kRaw) sr = r < m ? sx[r] : 0.f;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int cl = wn * WN + j * 8 + 2 * q, c = n0 + cl;
        if (c >= n) continue;
        if constexpr (kRaw) {
          store2(tile + rl * LD + cl, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          store2(tile + rl * LD + cl, dequant<T>(acc[i][j][2 * h], sr, sw[c], bias, c),
                 dequant<T>(acc[i][j][2 * h + 1], sr, sw[c + 1], bias, c + 1));
        }
      }
    }
  }
  __syncthreads();
  constexpr int VEC = 16 / sizeof(T), CPR = BN / VEC;
  for (int i = tid; i < BM * CPR; i += NT) {
    const int rl = i / CPR, cl = (i % CPR) * VEC;
    const long long r = m0 + rl;
    if (r < m && n0 + cl < n)  // n % 8 == 0: a piece is whole or out
      *reinterpret_cast<uint4*>(out + r * n + n0 + cl) = *reinterpret_cast<const uint4*>(tile + rl * LD + cl);
  }
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
int launch_linear(const void* a, const void* sx, const void* w, const void* sw, const void* bias, void* out,
                  long long m, int n, int k, cudaStream_t st) {
  using C = Tile<kBM, kBN, kWM, kWN, kStages>;
  constexpr int kSmem = C::template smem_bytes<T>();
  auto kernel = int8_linear_kernel<T, kBM, kBN, kWM, kWN, kStages>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (m <= 0) return 0;
  const long long blocks = (m + kBM - 1) / kBM * ((n + kBN - 1) / kBN);
  kernel<<<(unsigned)blocks, C::kThreads, kSmem, st>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(sx), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const T*>(bias), static_cast<T*>(out), m, n, k);
  return (int)cudaGetLastError();
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
