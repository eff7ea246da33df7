// K4: decoder attention backward on token-major projections.
//
// Replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_bwd_kernel_cross_ln` (launched by `_bwd_cross_ln_pallas`), the backward
// of K3. q and do are (B, Nq, H*hd), k and v (B, Nk, H*hd), heads at column
// offset h*hd; lb = (m + ln l) * log2(e) and delta = rowsum_h(o * do) arrive
// as (B, H, Nq) fp32 (prepared in PyTorch, as the JAX package prepares them
// in XLA). Per score tile, the TPU kernel's recipe:
//   p  = exp2(s * scale * log2e - lb)        (s = q k^T)
//   dp = do v^T
//   ds = p * (dp - delta) * scale
//   dv += p^T do,  dk += ds^T q,  dq += ds k
// with p and ds rounded to bf16 before their products in the bf16 path and
// every product accumulated in fp32.
//
// Design (the kernels are in attention_bwd.cuh, shared with K12): two
// passes, as the TPU kernel's sequential grid cannot carry dq
// across blocks here. Pass 1 (dkdv) takes one block per (batch, head, 64-row
// KV tile), so that dk and dv stay exact in registers while the block walks
// over every 64-row q tile (the TPU kernel's sequential KV grid axis becomes
// this loop). Pass 2 (dq) takes one block per (batch, head, 64-row q tile)
// and walks over the KV tiles, recomputing s and dp, so that dq too stays in
// registers and is written once, in the input dtype. That is seven products
// per score tile instead of five. The alternative, one pass that adds each
// block's share of dq into an fp32 buffer with atomicAdd, issues Nq * hd
// atomics per KV tile (1.4e9 at the train cross shape) and measured
// 8.9-9.0 ms there against 5.5-5.6 ms for the two passes on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit (chip_smoke.py from both checkouts,
// PERF.md); it also left dq's last bits to the order of the atomics.
//
// Ragged tails are masked, never padded in memory: q rows past Nq load as
// zeros with lb = +inf, so p = 0; KV rows past Nk get p = 0 and their dk, dv
// rows are never stored.
//
// Bound on the H100: 10 * B * H * Nq * Nk * hd operations against
// ~(4 Nq + 4 Nk) * H * hd * 2 bytes per batch row, far above the ridge, so
// the tensor cores bound it. bf16 runs every product as mma.sync m16n8k16
// (operands through ldmatrix, the streamed tiles double-buffered with
// cp.async); fp32 takes a CUDA-core path in full fp32 (the tensor cores'
// fp32 route is TF32). Not yet used: wgmma, TMA, warp specialisation.
//
// K8 and K9: the head-major backward, the same two passes. They replace the
// TPU kernels crossscore_tpu/ops/flash_attention.py `_bwd_kernel_single`
// (launched by `_bwd_pallas_single`, Nk <= 2048: one KV block, dk/dv in VMEM
// scratch across the sequential q axis) and `_bwd_kernel_multi` (launched by
// `_bwd_pallas_multi`, Nk > 2048: dk/dv exact per 1024-row KV block, dq in
// fp32 scratch across the sequential KV axis), the backward of the JAX
// `flash_cross_attention` (K7 forward) on the tensor-parallel route and, fed
// the global (l, m), of the context-parallel cross-attention (`_bwd_xla`).
// The two TPU bodies differ only in which gradient their grid carries; the
// split at 2048 is a VMEM matter. Here the two passes above carry none, so
// one design serves both, and the wrappers count a launch as K8 or K9 by the
// JAX rule. q, do (B, H, Nq, hd) and k, v (B, H, Nk, hd) arrive with their
// own batch, head and row strides (contiguous tensors, or head-major views of
// token-major projections read in place); dq, dk and dv are written
// token-major, (B, N, H*hd), whose head-major views the wrappers hand back,
// so the projections' backward reads them with no transpose copy. Bound as
// K4's: 10 * B * H * Nq * Nk * hd operations against (4 Nq + 4 Nk) * H * hd
// elements moved, far above the ridge, so the tensor cores bound it; a view
// costs nothing over a contiguous tensor, since every row of hd elements is
// one run of 16-byte loads either way. K4 passes a head stride of hd.

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
