// K1: backbone self-attention straight off the fused qkv projection.
//
// Replaces the TPU kernel crossscore_tpu/ops/flash_attention.py
// `_fwd_kernel_qkv` (launched by `_flash_qkv_fwd`). Like it, this reads q, k
// and v from the (B, N, 3*H*hd) projection output at column offsets
// h*hd, D + h*hd and 2D + h*hd, and writes o into (B, N, H*hd), so no
// head split or transpose touches device memory. The TPU kernel keeps the
// whole KV row in VMEM; here a block streams KV in 64-row tiles with an
// online softmax (attention_fwd.cuh), since a block has at most 227 KB of
// shared memory. What bounds it and how: see attention_fwd.cuh.

#include "attention_fwd.cuh"

extern "C" int cs_flash_qkv_self_attention(const void* qkv, void* o, void* l, void* m,
                                           int batch, int n, int heads, int hd,
                                           int dtype, float scale, void* stream) {
  const long long d = (long long)heads * hd;
  const size_t esize = dtype == cs::kBFloat16 ? 2 : 4;
  cs::AttnArgs a;
  a.q = qkv;
  a.k = static_cast<const char*>(qkv) + d * esize;
  a.v = static_cast<const char*>(qkv) + 2 * d * esize;
  a.q_bs = a.k_bs = a.v_bs = (long long)n * 3 * d;
  a.q_rs = a.k_rs = a.v_rs = 3 * d;
  a.o = o;
  a.o_bs = (long long)n * d;
  a.o_rs = d;
  a.l = static_cast<float*>(l);
  a.m = static_cast<float*>(m);
  a.h = heads;
  a.nq = a.nk = n;
  a.c1 = scale * cs::kLog2e;
  return cs::launch_attention(a, batch, hd, dtype, static_cast<cudaStream_t>(stream));
}
