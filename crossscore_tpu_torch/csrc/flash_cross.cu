// K3: decoder self- and cross-attention on token-major projections, and
// K6: the same with an additive KV-token bias (shape-bucketed inference).
//
// K3 replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_fwd_kernel_cross_ln` (launched by `_flash_cross_ln_fwd`). q is
// (B, Nq, H*hd) and k, v are (B, Nk, H*hd), the layout the q/k/v projections
// emit; heads are read at column offset h*hd. The TPU kernel pads hd 48 to 64
// in HBM so that two heads fill a 128-lane block, and folds the true scale
// into the q projection; here the kernel works at the true hd (48 on the main
// path, three 16-wide tensor-core steps) with scale 1/sqrt(hd), and the KV
// tail (Nk = 1369 or K*1369) is masked in the last 64-row tile instead of
// being padded in memory. What bounds it and how: see attention_fwd.cuh.
//
// K6 is the same body with `kv_bias` (`_fwd_kernel_cross_ln` with `per_item`):
// a (Nk,) or (B, Nk) fp32 bias row, for the decoder's self-attention (Nk =
// Nq) and its cross-attention over K bucket-padded reference grids (the
// item's token mask tiled K times). The TPU kernel adds the pre-scaled bias
// block to the score tile; here each thread reads its columns of the item's
// row per KV tile and the tail mask still applies after it.

#include "attention_fwd.cuh"

namespace {

cs::AttnArgs cross_args(const void* q, const void* k, const void* v, void* o, void* l, void* m,
                        int nq, int nk, int heads, int hd, float scale) {
  const long long d = (long long)heads * hd;
  cs::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_bs = (long long)nq * d;
  a.k_bs = a.v_bs = (long long)nk * d;
  a.q_rs = a.k_rs = a.v_rs = d;
  a.o = o;
  a.o_bs = (long long)nq * d;
  a.o_rs = d;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = heads;
  a.nq = nq;
  a.nk = nk;
  a.c1 = scale * cs::kLog2e;
  return a;
}

}  // namespace

extern "C" int cs_flash_cross_attention(const void* q, const void* k, const void* v,
                                        void* o, void* l, void* m, int batch, int nq,
                                        int nk, int heads, int hd, int dtype, float scale,
                                        void* stream) {
  const cs::AttnArgs a = cross_args(q, k, v, o, l, m, nq, nk, heads, hd, scale);
  return cs::launch_attention<false>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}

// bias: (Nk,) with bias_bs 0, or (B, Nk) with bias_bs Nk; fp32, natural units
extern "C" int cs_flash_cross_attention_masked(const void* q, const void* k, const void* v,
                                               const void* bias, long long bias_bs, void* o,
                                               void* l, void* m, int batch, int nq, int nk,
                                               int heads, int hd, int dtype, float scale,
                                               void* stream) {
  cs::AttnArgs a = cross_args(q, k, v, o, l, m, nq, nk, heads, hd, scale);
  a.bias = static_cast<const float*>(bias);
  a.bias_bs = bias_bs;
  return cs::launch_attention<true>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}
