// Warp-level tensor-core and copy primitives (sm_80+ PTX, used on sm_90a):
// ldmatrix, mma.sync m16n8k16 bf16 with fp32 accumulators, mma.sync m16n8k32
// int8 with int32 accumulators, cp.async.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16x16, row major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..), a2 = (g, 2q+8..), a3 = (g+8, 2q+8..)
//   B (16x8, "col"):      b0 = (k 2q..2q+1, n g), b1 = (k 2q+8.., n g)
//   C (16x8, fp32):       c0,c1 = (g, 2q..2q+1), c2,c3 = (g+8, 2q..2q+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace cs {

// A fragment of a 16x16 bf16 tile at `tile` (row major, row stride ld).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld, int lane) {
  const __nv_bfloat16* p = tile + (lane % 16) * ld + (lane / 16) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// B fragments of two n8 tiles x k16 from an [n][k] tile (row stride ld):
// b[0], b[1] for n 0..7 and b[2], b[3] for n 8..15.
__device__ __forceinline__ void ldsm_b_nk_x2tiles(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                                  int lane) {
  const __nv_bfloat16* p = tile + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p)));
}

// B fragment of one n8 tile x k16 from an [n][k] tile.
__device__ __forceinline__ void ldsm_b_nk_1tile(uint32_t (&b)[2], const __nv_bfloat16* tile, int ld,
                                                int lane) {
  const __nv_bfloat16* p = tile + (lane % 8) * ld + ((lane / 8) % 2) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p)));
}

// B fragments of k16 x two n8 tiles from a [k][n] tile (row stride ld),
// transposed on load: b[0], b[1] for n 0..7 and b[2], b[3] for n 8..15.
__device__ __forceinline__ void ldsm_b_kn_x2tiles(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                                  int lane) {
  const __nv_bfloat16* p = tile + ((lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices (8 rows of 16 bytes each, any element type) from
// shared memory: lane l gives the address of row l % 8 of matrix l / 8, and
// r[j] holds the 4 bytes (lane % 4) of row lane / 4 of matrix j. For int8
// tiles that is mma.m16n8k32's A fragment (matrices: rows 0-7 and 8-15 at
// bytes 0-15, then the same at bytes 16-31) and two n8 tiles' B fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// int8 x int8 -> int32, m16n8k32 (g = lane / 4, q = lane % 4):
//   A (16x32, row major): a0 = (g, 4q..4q+3), a1 = (g+8, 4q..), a2 = (g, 16+4q..), a3 = (g+8, 16+4q..)
//   B (32x8, "col"):      b0 = (k 4q..4q+3, n g), b1 = (k 16+4q.., n g)
//   C (16x8, int32):      c0,c1 = (g, 2q..2q+1), c2,c3 = (g+8, 2q..2q+1)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error ~2^-22; ex2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte asynchronous copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ROWS x COLS bf16 rows [r0, r0 + ROWS) of a row-major matrix (row stride rs)
// into shared memory (row stride ld) with cp.async; rows at or past nrows
// are zero-filled.
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                              long long rs, int r0, int nrows, int tid) {
  constexpr int CPR = COLS / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int rr = i / CPR, cc = (i % CPR) * 8;
    const int g = r0 + rr;
    const bool ok = g < nrows;
    cp_async16(dst + rr * ld + cc, src + (ok ? (long long)g * rs + cc : 0), ok ? 16 : 0);
  }
}

}  // namespace cs
