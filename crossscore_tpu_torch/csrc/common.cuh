// Shared helpers of the port's kernels. Each csrc/<name>.cu is built alone
// into one shared library with a plain C interface (ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* cs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace cs {

constexpr float kLog2e = 1.4426950408889634f;

// dtype codes passed from the wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Copy rows [r0, r0 + ROWS) x COLS of a row-major matrix (row stride `rs`
// elements) into shared memory (row stride `ld`) with 16-byte loads; rows at
// or past `nrows` are zero-filled. COLS * sizeof(T), the source rows and `ld`
// must be 16-byte multiples (the wrappers check the global side).
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long rs,
                                          int r0, int nrows, int tid, int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = COLS / VEC;
  for (int i = tid; i < ROWS * CPR; i += nthreads) {
    const int rr = i / CPR, cc = (i % CPR) * VEC;
    const int g = r0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < nrows) val = *reinterpret_cast<const uint4*>(src + (long long)g * rs + cc);
    *reinterpret_cast<uint4*>(dst + rr * ld + cc) = val;
  }
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace cs
