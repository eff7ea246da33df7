// Hopper asynchronous copies (sm_90a): TMA tile loads and plain bulk copies
// into shared memory that complete on an mbarrier (one block's, or multicast
// to the blocks of a thread-block cluster), TMA tile stores, the mbarrier
// operations of a producer / consumer ring (arrivals on a cluster partner's
// barriers too), register rebalancing between warpgroups (setmaxnreg), the
// block shape that the attention kernels share (a producer warpgroup and two
// consumer warpgroups), and the host side: a 4-D tensor map of one bf16
// operand and a 2-D map of a row-major matrix of any element type.
//
// The driver's cuTensorMapEncodeTiled is resolved at run time through the
// runtime's driver entry point, so a library that includes this header
// links against the runtime only (no -lcuda); <cuda.h> supplies the types.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cs {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, and `bytes` more to come from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) of device memory at `src` into shared memory at
// `dst` (both 16-byte aligned) as one bulk copy, completing them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// one box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at `dst`, completing `bytes` (the whole box, out-of-bounds
// elements included, which TMA fills with zeros) on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same box written into the shared memory of every block of the cluster
// named in `mask` (bit r: rank r), at `dst`'s offset in each, completing on
// the barrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_4d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                                      int c1, int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// one box of shared memory at `src` stored to a 4-D tensor map at (c0 .. c3)
// (rows past the map's end are not written), then committed as a bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// one box of a 2-D tensor map at (c0 innermost, c1) into shared memory at
// `dst`, completing the whole box's bytes on `bar` (out-of-bounds elements
// read as zeros)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one box of shared memory at `src` stored to a 2-D tensor map at (c0, c1);
// elements past the map's ends are not written. Not committed: a thread
// commits its stores as one bulk group (bulk_commit)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's bulk groups have shared memory still to read
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until every bulk group of this thread has completed its writes
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// commit this thread's bulk stores and wait until they have read shared memory
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this block's rank in its thread-block cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: arrive, then wait for all
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// one arrival on the barrier at `bar`'s offset in the cluster's block `cta`
// (this block's own included)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\nmbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// the shared::cluster address of `p`'s offset in the cluster's block `cta`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(cta));
  return r;
}

// one arrival, released to the cluster, on the barrier at `bar`'s offset in
// the cluster's block `cta`
__device__ __forceinline__ void mbar_arrive_release_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_addr(bar, cta))
               : "memory");
}

// spin until the phase of parity `parity` has completed, acquiring what the
// arrivals of other blocks of the cluster released
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, "
        "0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` of this block's shared memory at `src` copied into the block of the
// cluster whose shared::cluster addresses `dst` and `bar` are (mapa): one
// arrival on that barrier that expects the bytes, then the copy, which
// completes them there. `src` is read by the async proxy: fence the writes
// that filled it first.
__device__ __forceinline__ void bulk_copy_to_cluster(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, [%3], %2;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// every warp of a warpgroup together: lower or raise its register ceiling
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The warp-specialised attention block (forward and backward): warpgroup 0
// the producer, of which one warp issues the TMA loads with its registers
// handed to the consumers by setmaxnreg, and warpgroups 1 and 2 the
// consumers, 64 rows each.
constexpr int WG_THREADS = 384;
constexpr int PRODUCER_REGS = 24;   // one warp issuing loads
constexpr int CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65536

// the block's shared memory, aligned up to the 1024 bytes of a swizzle atom
__device__ __forceinline__ unsigned char* smem_1024(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// bar[0] the resident tiles, bar[1 + s] stage s full, bar[1 + S + s] empty
__device__ __forceinline__ void init_ring(uint64_t* bar, int stages, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bar[1 + s], full_count);
      mbar_init(&bar[1 + stages + s], 8);  // the two consumer warpgroups' eight warps
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// the CB column blocks of `rows`-row boxes at row r0 of `map` into `dst`
template <int CB>
__device__ __forceinline__ void tma_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int rows,
                                         int r0, int head, int b) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) tma_load_4d(dst + cb * rows * 128, map, bar, cb * 64, r0, head, b);
}

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                          const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                          CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one bf16 operand with hd contiguous elements per row and
// element strides rs (row), hs (head) and bs (batch) (the fused MLP maps a
// 2-D matrix as one head of one batch item): dimensions
// (hd, rows, heads, batch), so that a box never crosses into another head or
// batch item: rows past `rows` and columns past hd read as zeros. Boxes are
// 64 columns (128 bytes, the swizzle span) by `box_rows` rows, written
// 128-byte swizzled. TMA takes 16-byte aligned bases and 16-byte multiples
// as strides (the wrappers check both before the launch).
inline cudaError_t operand_map(CUtensorMap* map, const void* base, int hd, int rows, int heads, int batch,
                               long long rs, long long hs, long long bs, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)rs * 2, (cuuint64_t)hs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a row-major matrix of `rows` rows of `cols` elements of
// `type`, `row_bytes` apart (a 16-byte multiple, the base 16-byte aligned):
// boxes of box_cols x box_rows, box_cols elements being the 128 bytes of the
// swizzle span, written to (or read from) shared memory 128-byte swizzled.
inline cudaError_t matrix_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long cols,
                              long long rows, long long row_bytes, int box_cols, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace cs
