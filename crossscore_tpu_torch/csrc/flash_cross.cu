// K3: decoder self- and cross-attention on token-major projections, and
// K6: the same with an additive KV-token bias (shape-bucketed inference).
//
// K3 replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_fwd_kernel_cross_ln` (launched by `_flash_cross_ln_fwd`). q is
// (B, Nq, H*hd) and k, v are (B, Nk, H*hd), the layout the q/k/v projections
// emit; heads are read at column offset h*hd. The TPU kernel pads hd 48 to 64
// in HBM so that two heads fill a 128-lane block, and folds the true scale
// into the q projection; here the kernel works at the true hd (48 on the main
// path: three 16-deep steps of Q K^T, and P V as m64n48, over TMA boxes of 64
// columns whose last 16 read as zeros) with scale 1/sqrt(hd), and the KV
// tail (Nk = 1369 or K*1369) is masked in the last 128-row tile instead of
// being padded in memory. What bounds it and how: see attention_fwd.cuh.
//
// K6 is the same body with `kv_bias` (`_fwd_kernel_cross_ln` with `per_item`):
// a (Nk,) or (B, Nk) fp32 bias row, for the decoder's self-attention (Nk =
// Nq) and its cross-attention over K bucket-padded reference grids (the
// item's token mask tiled K times). The TPU kernel adds the pre-scaled bias
// block to the score tile; here the producer warp stages each KV tile's
// slice of the item's row beside the tile, the score epilogue adds it, and
// the tail mask still applies after it.
//
// K7 is the same kernel on head-major operands, the counterpart of the TPU
// kernels that `_flash_fwd` launches: `_fwd_kernel` and `_fwd_kernel_single`
// (v1, no bias; what the context-parallel cross-attention calls per KV shard)
// and `_fwd_kernel_v2` and `_fwd_kernel_single_v2` (v2, with an optional (Nk,)
// bias row shared by the batch). q is (B, H, Nq, hd) and k, v (B, H, Nk, hd),
// each with its own batch, head and row strides and hd contiguous: a
// contiguous tensor, or the head-major view x.view(B, N, H, hd).transpose(1,
// 2) of a token-major projection, read in place. o is written to a contiguous
// (B, H, Nq, hd). The TPU kernels pick one of two bodies by the KV length
// (one exact-softmax block up to 2048 tokens, an online softmax over 1024-row
// blocks beyond); here the 128-row online softmax covers both (Nk = 1369 or
// 5476 per shard on the view-parallel path), and the tail is masked in the
// last tile instead of padded in memory. Bound and design as K3's: the tensor
// cores and the exponentials bound it (4*Nq*Nk*hd operations and Nq*Nk
// exponentials per head against (2*Nq + 2*Nk)*hd elements moved), and a view
// costs nothing over a contiguous tensor: its tensor map takes the view's
// head and row strides, and TMA reads each box of hd-wide rows either way.
//
// The entries below take bf16; fp32 operands go through the 3xTF32 body's
// entries (cs_attention_f32_*, attention_fwd_f32.cuh), which this library
// holds too, at the same strides.
//
// K7's timing modes (K7') are in attention_modes.cu.

#include "attention_fwd.cuh"
#include "attention_fwd_f32.cuh"

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
  a.q_hs = a.k_hs = a.v_hs = a.o_hs = hd;  // heads side by side in a row
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


extern "C" int cs_flash_attention_head_major(const void* q, const void* k, const void* v,
                                             const long long* strides, void* o, void* l, void* m,
                                             int batch, int heads, int nq, int nk, int hd,
                                             int dtype, float scale, void* stream) {
  const cs::AttnArgs a = cs::head_major_args(q, k, v, strides, o, l, m, heads, nq, nk, hd, scale);
  return cs::launch_attention<false>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}

// bias: (Nk,) fp32 in natural units, one row shared by the batch
extern "C" int cs_flash_attention_head_major_biased(const void* q, const void* k, const void* v,
                                                    const long long* strides, const void* bias,
                                                    void* o, void* l, void* m, int batch,
                                                    int heads, int nq, int nk, int hd, int dtype,
                                                    float scale, void* stream) {
  cs::AttnArgs a = cs::head_major_args(q, k, v, strides, o, l, m, heads, nq, nk, hd, scale);
  a.bias = static_cast<const float*>(bias);
  a.bias_bs = 0;
  return cs::launch_attention<true>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}

// The bf16 forward's tile plan of head dim hd (attention_fwd.cuh's
// FwdTiles): out[0..3] = q rows a block, KV rows a tile, ring stages and
// the dynamic shared memory in bytes.
extern "C" int cs_flash_attention_fwd_plan(int hd, int* out) {
  switch (hd) {
    case 16: cs::fwd_plan<16>(out); return 0;
    case 32: cs::fwd_plan<32>(out); return 0;
    case 48: cs::fwd_plan<48>(out); return 0;
    case 64: cs::fwd_plan<64>(out); return 0;
    case 80: cs::fwd_plan<80>(out); return 0;
    case 96: cs::fwd_plan<96>(out); return 0;
    case 112: cs::fwd_plan<112>(out); return 0;
    case 128: cs::fwd_plan<128>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}
