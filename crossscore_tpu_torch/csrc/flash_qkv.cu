// K1: backbone self-attention straight off the fused qkv projection, and
// K5: the same with an additive KV-token bias (shape-bucketed inference).
//
// K1 replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_fwd_kernel_qkv` (launched by `_flash_qkv_fwd`). Like it, this reads q, k
// and v from the (B, N, 3*H*hd) projection output at column offsets
// h*hd, D + h*hd and 2D + h*hd, and writes o into (B, N, H*hd), so no
// head split or transpose touches device memory. The TPU kernel keeps the
// whole KV row in VMEM; here a block streams KV in 64-row tiles with an
// online softmax (attention_fwd.cuh), since a block has at most 227 KB of
// shared memory. What bounds it and how: see attention_fwd.cuh.
//
// K5 replaces `_fwd_kernel_qkv_biased` (`_flash_qkv_fwd` with `kv_bias`): the
// bias is a (N,) row shared by the batch or a (B, N) row per item (0 valid,
// -1e30 padded). The TPU kernel gets the bias pre-scaled by log2(e) as a
// VMEM block holding every batch row; here the kernel reads its item's row
// from device memory (16 columns per thread per KV tile, through the
// read-only cache) and scales it in the score epilogue. The work is K1's plus
// one FMA per score, so the same tensor-core bound applies; masked columns are
// still computed (bucket padding is 15-25% of the columns at the bucketed
// predict shapes), which a later version could skip per tile.

#include "attention_fwd.cuh"

namespace {

cs::AttnArgs qkv_args(const void* qkv, void* o, void* l, void* m, int n, int heads, int hd,
                      int dtype, float scale) {
  const long long d = (long long)heads * hd;
  const size_t esize = dtype == cs::kBFloat16 ? 2 : 4;
  cs::AttnArgs a;
  a.q = qkv;
  a.k = static_cast<const char*>(qkv) + d * esize;
  a.v = static_cast<const char*>(qkv) + 2 * d * esize;
  a.q_bs = a.k_bs = a.v_bs = (long long)n * 3 * d;
  a.q_rs = a.k_rs = a.v_rs = 3 * d;
  a.q_hs = a.k_hs = a.v_hs = a.o_hs = hd;  // heads side by side in a row
  a.o = o;
  a.o_bs = (long long)n * d;
  a.o_rs = d;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = heads;
  a.nq = a.nk = n;
  a.c1 = scale * cs::kLog2e;
  return a;
}

}  // namespace

extern "C" int cs_flash_qkv_self_attention(const void* qkv, void* o, void* l, void* m,
                                           int batch, int n, int heads, int hd,
                                           int dtype, float scale, void* stream) {
  const cs::AttnArgs a = qkv_args(qkv, o, l, m, n, heads, hd, dtype, scale);
  return cs::launch_attention<false>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}

// bias: (N,) with bias_bs 0, or (B, N) with bias_bs N; fp32, natural units
extern "C" int cs_flash_qkv_self_attention_masked(const void* qkv, const void* bias,
                                                  long long bias_bs, void* o, void* l,
                                                  void* m, int batch, int n, int heads,
                                                  int hd, int dtype, float scale,
                                                  void* stream) {
  cs::AttnArgs a = qkv_args(qkv, o, l, m, n, heads, hd, dtype, scale);
  a.bias = static_cast<const float*>(bias);
  a.bias_bs = bias_bs;
  return cs::launch_attention<true>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}
