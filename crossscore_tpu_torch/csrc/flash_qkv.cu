// K1: backbone self-attention straight off the fused qkv projection, and
// K5: the same with an additive KV-token bias (shape-bucketed inference).
//
// K1 replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_fwd_kernel_qkv` (launched by `_flash_qkv_fwd`). Like it, this reads q, k
// and v from the (B, N, 3*H*hd) projection output at column offsets
// h*hd, D + h*hd and 2D + h*hd, and writes o into (B, N, H*hd), so no
// head split or transpose touches device memory. The TPU kernel keeps the
// whole KV row in VMEM; here a block streams KV in 128-row tiles with an
// online softmax (attention_fwd.cuh), since a block has at most 227 KB of
// shared memory. The three sections map onto TMA in place: each is a 4-D
// tensor map (hd, N, H, B) with row stride 3D and head stride hd. What
// bounds it and how: see attention_fwd.cuh.
//
// K5 replaces `_fwd_kernel_qkv_biased` (`_flash_qkv_fwd` with `kv_bias`): the
// bias is a (N,) row shared by the batch or a (B, N) row per item (0 valid,
// -1e30 padded). The TPU kernel gets the bias pre-scaled by log2(e) as a
// VMEM block holding every batch row; here the producer warp stages each KV
// tile's slice of its item's row in shared memory beside the tile (scaled
// by log2(e), 0 past Nk), and the score epilogue adds it. The work is K1's plus
// one FMA per score, so the same tensor-core bound applies; masked columns are
// still computed (bucket padding is 15-25% of the columns at the bucketed
// predict shapes), which a later version could skip per tile.
//
// The entries below take bf16; fp32 operands go through the 3xTF32 body's
// entries (cs_attention_f32_*, attention_fwd_f32.cuh), which this library
// holds too: a pre-pass splits K and V into the wrapper's scratch, then the
// body reads q at the fused projection's strides.
//
// K1's timing modes (K11) are in attention_modes.cu.

#include "attention_fwd.cuh"
#include "attention_fwd_f32.cuh"

extern "C" int cs_flash_qkv_self_attention(const void* qkv, void* o, void* l, void* m,
                                           int batch, int n, int heads, int hd,
                                           int dtype, float scale, void* stream) {
  const cs::AttnArgs a = cs::qkv_args(qkv, o, l, m, n, heads, hd, dtype, scale);
  return cs::launch_attention<false>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}

// bias: (N,) with bias_bs 0, or (B, N) with bias_bs N; fp32, natural units
extern "C" int cs_flash_qkv_self_attention_masked(const void* qkv, const void* bias,
                                                  long long bias_bs, void* o, void* l,
                                                  void* m, int batch, int n, int heads,
                                                  int hd, int dtype, float scale,
                                                  void* stream) {
  cs::AttnArgs a = cs::qkv_args(qkv, o, l, m, n, heads, hd, dtype, scale);
  a.bias = static_cast<const float*>(bias);
  a.bias_bs = bias_bs;
  return cs::launch_attention<true>(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}
