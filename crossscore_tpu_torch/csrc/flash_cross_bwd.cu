// K4: decoder attention backward on token-major projections; K8 and K9: the
// head-major backward. One set of kernels (attention_bwd.cuh, shared with
// K12) behind two entries.
//
// K4 replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_bwd_kernel_cross_ln` (launched by `_bwd_cross_ln_pallas`), the backward
// of K3: q and do (B, Nq, H*hd), k and v (B, Nk, H*hd), heads at column
// offset h*hd. K8 and K9 replace `_bwd_kernel_single` (launched by
// `_bwd_pallas_single`, Nk <= 2048) and `_bwd_kernel_multi` (launched by
// `_bwd_pallas_multi`, Nk > 2048), the backward of the JAX
// `flash_cross_attention` (K7 forward) on the tensor-parallel route and, fed
// the global (l, m), of the context-parallel cross-attention (`_bwd_xla`):
// q, do (B, H, Nq, hd) and k, v (B, H, Nk, hd) with their own batch, head and
// row strides (contiguous, or head-major views of token-major projections
// read in place). The two TPU bodies differ only in which gradient their
// sequential grid carries, a VMEM matter; the two passes here carry none, so
// one design serves both and the wrappers count a launch as K8 or K9 by the
// JAX rule. dq, dk and dv are written token-major (B, N, H*hd) for all three
// (K8/K9 hand back their head-major views). Per score tile, the TPU recipe:
//   p  = exp2(s * scale * log2e - lb)        (s = q k^T)
//   dp = do v^T
//   ds = p * (dp - delta) * scale
//   dv += p^T do,  dk += ds^T q,  dq += ds k
// with p and ds rounded to bf16 before their products in the bf16 path and
// every product summed in fp32; lb = (m + ln l) * log2(e) and delta =
// rowsum_h(o * do) arrive as (B, H, Nq) fp32, made for bf16 by the small
// `bwd_stats` kernel below (the JAX package makes them in XLA; fp32 keeps
// PyTorch's).
//
// Bound on the H100: the five products are 10 * B * H * Nq * Nk * hd
// operations against ~(4 Nq + 4 Nk) * H * hd * 2 bytes per batch row, far
// above the ridge, so the tensor cores bound it (0.873 ms at the train cross
// shape, 24 x 8 heads x 1369 x 6845 x hd 48). Two passes, as the TPU's
// sequential grid cannot carry dq across blocks here: pass 1 (dk, dv) keeps
// 128 KV rows resident and walks every q tile, pass 2 (dq) keeps 128 q rows
// resident and walks every KV tile, recomputing s and dp: seven products a
// score tile, 14 units of B H Nq Nk hd, a floor of 1.22 ms. No atomics: dq
// is written once and every launch on the same inputs gives the same bits,
// which the context-parallel backward and the tensor-parallel checks rely
// on. (One pass with fp32 atomics for dq measured 8.9-9.0 ms against 5.5 ms
// for two mma.sync passes, PERF.md.)
//
// bf16, on Hopper's own instructions (attention_bwd.cuh):
// - every product is wgmma: a consumer warpgroup owns 64 rows and the
//   hardware reads B once from shared memory for all 128 threads (the score
//   products with both operands there, the gradient products with p or ds
//   from registers and q, do or K read transposed from the same tile);
// - loads are TMA boxes from one 4-D tensor map per operand (hd, rows,
//   heads, batch), built on the host from the strides, into a four-stage
//   mbarrier ring fed by one producer warp; rows past Nq or Nk and columns
//   past hd arrive as zeros, never another head's or batch item's data;
// - the exponentials and ds overlap the tensor cores: the previous tile's
//   gradient products run behind this tile's score products, and the two
//   consumer warpgroups run about half an iteration apart;
// - pass 2 still recomputes s and dp (14 units, not 10): the cost of a
//   deterministic dq without atomics.
// On an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py in a
// parent / change A/B, PERF.md): K4 at the train cross shape 3.07-3.24 ms
// (5.22-5.24 with mma.sync; SDPA's backward 3.09-3.25 in the same runs),
// self 0.76-0.86 (1.30-1.31; SDPA 0.80-1.05), K8 0.75-0.76 (1.44-1.51; SDPA
// 0.83-0.98), K9 3.04-3.05 (5.34; SDPA 3.07-3.10). fp32 takes a CUDA-core
// path in full fp32 (the tensor cores' fp32 route is TF32), unchanged.

#include "attention_bwd.cuh"

namespace {

// the arguments of both entries; the outputs dq (B, Nq, H*hd) and dk, dv
// (B, Nk, H*hd) token-major, the input strides set by the caller
cs::BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, const void* lb,
                     const void* delta, void* dq, void* dk, void* dv, int nq, int nk, int heads,
                     int hd, float scale) {
  const long long d = (long long)heads * hd;
  cs::BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lb = static_cast<const float*>(lb);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_bs = (long long)nq * d, a.dq_hs = hd, a.dq_rs = d;
  a.dkv_bs = (long long)nk * d, a.dkv_hs = hd, a.dkv_rs = d;
  a.h = heads;
  a.nq = nq;
  a.nk = nk;
  a.scale = scale;
  a.c1 = scale * cs::kLog2e;
  return a;
}

// The backward's per-row inputs in bf16, as the JAX package prepares them in
// XLA before its kernel: lb = (m + ln l) * log2(e), l == 0 taken as 1, and
// delta = the fp32 sum over hd of o * do, for every (batch, head, query).
// One thread per row, the query index fastest (lb and delta are written
// (B, H, Nq) contiguous), o and do read in 16-byte pieces; o and do
// strides in elements, hd contiguous and rows 16-byte aligned.
struct StatsArgs {
  const void* o;
  const void* dout;
  const float* l;
  const float* m;
  float* lb;
  float* delta;
  long long o_bs, o_hs, o_rs, do_bs, do_hs, do_rs;
  int h, nq, hd;
  long long rows;
};

__global__ void __launch_bounds__(256) bwd_stats(StatsArgs a) {
  using T = __nv_bfloat16;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.rows) return;
  const long long bh = i / a.nq;
  const int n = (int)(i % a.nq), hh = (int)(bh % a.h), bb = (int)(bh / a.h);
  const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + bb * a.o_bs + hh * a.o_hs + n * a.o_rs);
  const uint4* d =
      reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + bb * a.do_bs + hh * a.do_hs + n * a.do_rs);
  constexpr int PER = 16 / sizeof(T);
  float acc = 0.f;
  for (int c = 0; c < a.hd / PER; ++c) {
    const uint4 ov = o[c], dv = d[c];
    const T* op = reinterpret_cast<const T*>(&ov);
    const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int e = 0; e < PER; ++e) acc = fmaf(cs::to_f32(op[e]), cs::to_f32(dp[e]), acc);
  }
  const float l = a.l[i];
  a.lb[i] = (a.m[i] + logf(l == 0.f ? 1.f : l)) * cs::kLog2e;
  a.delta[i] = acc;
}

template <int HD>
void plan(int* out) {
  using T = cs::BwdTiles<HD>;
  const int p[6] = {T::ROWS, T::BQ, T::BK, cs::STAGES, (int)T::p1_bytes, (int)T::p2_bytes};
  for (int i = 0; i < 6; ++i) out[i] = p[i];
}

int launch_bwd(const cs::BwdArgs& a, int batch, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return cs::launch_bwd_hd<16>(a, batch, dtype, st);
    case 32: return cs::launch_bwd_hd<32>(a, batch, dtype, st);
    case 48: return cs::launch_bwd_hd<48>(a, batch, dtype, st);
    case 64: return cs::launch_bwd_hd<64>(a, batch, dtype, st);
    case 80: return cs::launch_bwd_hd<80>(a, batch, dtype, st);
    case 96: return cs::launch_bwd_hd<96>(a, batch, dtype, st);
    case 112: return cs::launch_bwd_hd<112>(a, batch, dtype, st);
    case 128: return cs::launch_bwd_hd<128>(a, batch, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K4. q, do: (B, Nq, H*hd); k, v: (B, Nk, H*hd); lb, delta: (B, H, Nq) fp32;
// dq: (B, Nq, H*hd), dk, dv: (B, Nk, H*hd), all in the input dtype.
extern "C" int cs_flash_cross_attention_bwd(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lb, const void* delta,
                                            void* dq, void* dk, void* dv, int batch, int nq,
                                            int nk, int heads, int hd, int dtype, float scale,
                                            void* stream) {
  cs::BwdArgs a = bwd_args(q, k, v, dout, lb, delta, dq, dk, dv, nq, nk, heads, hd, scale);
  a.q_bs = a.do_bs = a.dq_bs, a.q_hs = a.do_hs = hd, a.q_rs = a.do_rs = a.dq_rs;
  a.k_bs = a.v_bs = a.dkv_bs, a.k_hs = a.v_hs = hd, a.k_rs = a.v_rs = a.dkv_rs;
  return launch_bwd(a, batch, hd, dtype, stream);
}

// K8/K9. q, do: (B, H, Nq, hd) and k, v: (B, H, Nk, hd), each with its own
// batch, head and row strides (strides[0..11]: q, do, k, v, three each, in
// elements; hd contiguous); lb, delta: (B, H, Nq) fp32. dq is written to a
// token-major (B, Nq, H*hd) buffer and dk, dv to (B, Nk, H*hd) ones, all in
// the input dtype.
extern "C" int cs_flash_attention_head_major_bwd(const void* q, const void* k, const void* v,
                                                 const void* dout, const long long* strides,
                                                 const void* lb, const void* delta, void* dq,
                                                 void* dk, void* dv, int batch, int heads, int nq,
                                                 int nk, int hd, int dtype, float scale,
                                                 void* stream) {
  cs::BwdArgs a = bwd_args(q, k, v, dout, lb, delta, dq, dk, dv, nq, nk, heads, hd, scale);
  a.q_bs = strides[0], a.q_hs = strides[1], a.q_rs = strides[2];
  a.do_bs = strides[3], a.do_hs = strides[4], a.do_rs = strides[5];
  a.k_bs = strides[6], a.k_hs = strides[7], a.k_rs = strides[8];
  a.v_bs = strides[9], a.v_hs = strides[10], a.v_rs = strides[11];
  return launch_bwd(a, batch, hd, dtype, stream);
}

// The bf16 tile plan of head dim hd (attention_bwd.cuh's BwdTiles): out[0..5]
// = resident rows a block (KV rows in pass 1, q rows in pass 2), pass 1's q
// tile, pass 2's KV tile, ring stages, and the dynamic shared memory of
// pass 1 and of pass 2 in bytes.
extern "C" int cs_flash_attention_bwd_plan(int hd, int* out) {
  switch (hd) {
    case 16: plan<16>(out); return 0;
    case 32: plan<32>(out); return 0;
    case 48: plan<48>(out); return 0;
    case 64: plan<64>(out); return 0;
    case 80: plan<80>(out); return 0;
    case 96: plan<96>(out); return 0;
    case 112: plan<112>(out); return 0;
    case 128: plan<128>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's lb and delta (B, H, Nq) fp32 from bf16 o, do (B, H, Nq, hd)
// with strides[0..5] = o's and do's batch, head and row strides in elements
// (hd contiguous, rows 16-byte aligned) and l, m (B, H, Nq) fp32 contiguous.
extern "C" int cs_flash_attention_bwd_stats(const void* o, const void* dout, const long long* strides,
                                            const void* l, const void* m, void* lb, void* delta, int batch,
                                            int heads, int nq, int hd, void* stream) {
  StatsArgs a;
  a.o = o;
  a.dout = dout;
  a.l = static_cast<const float*>(l);
  a.m = static_cast<const float*>(m);
  a.lb = static_cast<float*>(lb);
  a.delta = static_cast<float*>(delta);
  a.o_bs = strides[0], a.o_hs = strides[1], a.o_rs = strides[2];
  a.do_bs = strides[3], a.do_hs = strides[4], a.do_rs = strides[5];
  a.h = heads;
  a.nq = nq;
  a.hd = hd;
  a.rows = (long long)batch * heads * nq;
  const unsigned grid = (unsigned)((a.rows + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rows == 0) return 0;
  bwd_stats<<<grid, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
