// The timing modes of the attention forward, K11 and K7': no model path
// calls them (tools/attn_microbench.py and chip_smoke.py do). Their seven
// modes at hd 48, 64 and 128 (21 instantiations of attention_fwd.cuh's bf16
// kernel) have a source of their own, compiled beside the model path's
// flash_qkv.cu and flash_cross.cu rather than inside them.
//
// K11 is K1's geometry (flash_qkv.cu) with a timing mode: the TPU's
// `_fwd_kernel_qkv_probe` (`probe` "nomax", "nosum", "mxu": wrong math on
// purpose, each deleting a pass of K1) and `_fwd_kernel_qkv_chunked`
// (`chunks` > 1: K1's exact math over 128-aligned KV chunks combined by an
// online softmax, for MXU/VPU overlap on the TPU's static schedule). The
// Hopper form of `chunks` is split-KV: one block per (q tile, chunk) writes
// the chunk's unnormalised fp32 (o, l, m), and a combine kernel merges the
// chunks with the exact online-softmax rule into K1's (o, l, m). The chunks
// are independent work in flight against one more pass over o; within a
// chunk p is rounded against the chunk's running max, where the TPU rounds
// it against the running max over the chunks so far, so the two agree to
// bf16 rounding, not bit for bit. The combine reads C * B * H * N * hd fp32
// partials once: bytes-bound, ~1.4 GB at three chunks of the bench point.
//
// K7' is K7's geometry (flash_cross.cu) with a timing mode: the TPU's MXU
// probe `_fwd_kernel_v2_mxu_probe` (`variant` "v2_mxuprobe", the multi-KV
// body) and the `noexp` and `bf16` options of `_fwd_kernel_single_v2`
// ("v2_noexp", "v2_bf16", the single-KV body). On the TPU each is tied to the
// body its blocking selects; here each is a function of (q, k, v) alone, at
// any Nk. v2 without its ones column ("v2_noaug") is the function of v2, and
// K7 itself.

#include "attention_fwd.cuh"

namespace cs {

struct CombineArgs {
  const float* part_o;  // (C, B, H, N, HD)
  const float* part_l;  // (C, B, H, N)
  const float* part_m;  // (C, B, H, N), log2 units
  __nv_bfloat16* o;     // (B, N, H*HD), token-major
  float* l;
  float* m;
  long long rows;  // B * H * N
  int h, n, nchunks;
};

// One thread per 8 columns of one (b, head, row): the chunks' partials
// merged with weights exp2(m_c - max_c m_c), then normalised by the merged l.
template <int HD>
__global__ void __launch_bounds__(256) attn_combine_chunks(CombineArgs c) {
  constexpr int G = HD / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.rows * G) return;
  const long long row = i / G;
  const int grp = (int)(i - row * G);
  float mx = -INFINITY;
  for (int ch = 0; ch < c.nchunks; ++ch) mx = fmaxf(mx, c.part_m[ch * c.rows + row]);
  float lsum = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int ch = 0; ch < c.nchunks; ++ch) {
    const long long pr = ch * c.rows + row;
    const float w = ex2(c.part_m[pr] - mx);
    lsum = fmaf(c.part_l[pr], w, lsum);
    const float4* po = reinterpret_cast<const float4*>(c.part_o + pr * HD + grp * 8);
    const float4 v0 = po[0], v1 = po[1];
    acc[0] = fmaf(v0.x, w, acc[0]);
    acc[1] = fmaf(v0.y, w, acc[1]);
    acc[2] = fmaf(v0.z, w, acc[2]);
    acc[3] = fmaf(v0.w, w, acc[3]);
    acc[4] = fmaf(v1.x, w, acc[4]);
    acc[5] = fmaf(v1.y, w, acc[5]);
    acc[6] = fmaf(v1.z, w, acc[6]);
    acc[7] = fmaf(v1.w, w, acc[7]);
  }
  const float inv = lsum == 0.f ? 1.f : 1.f / lsum;
  const int r = (int)(row % c.n), head = (int)((row / c.n) % c.h);
  const long long b = row / ((long long)c.n * c.h);
  __nv_bfloat16* out = c.o + (b * c.n + r) * c.h * HD + head * HD + grp * 8;
  *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv), pack_bf16(acc[2] * inv, acc[3] * inv),
                                              pack_bf16(acc[4] * inv, acc[5] * inv), pack_bf16(acc[6] * inv, acc[7] * inv));
  if (grp == 0) {
    c.l[row] = lsum;
    c.m[row] = mx * (1.f / kLog2e);
  }
}

template <int HD>
int launch_combine(const CombineArgs& c, cudaStream_t st) {
  const long long threads = c.rows * (HD / 8);
  attn_combine_chunks<HD><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace cs

// K11 probe: 1 "nomax", 2 "nosum", 3 "mxu"; bf16, hd 48, 64 or 128.
extern "C" int cs_flash_qkv_self_attention_probe(const void* qkv, void* o, void* l, void* m, int batch,
                                                 int n, int heads, int hd, int probe, float scale,
                                                 void* stream) {
  const cs::AttnArgs a = cs::qkv_args(qkv, o, l, m, n, heads, hd, cs::kBFloat16, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case 1: return cs::launch_attention_mode<cs::kNoMax>(a, batch, hd, 1, st);
    case 2: return cs::launch_attention_mode<cs::kNoSum>(a, batch, hd, 1, st);
    case 3: return cs::launch_attention_mode<cs::kMxu>(a, batch, hd, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K11 chunks: `nchunks` KV chunks of `kv_chunk` rows (the last one shorter;
// a chunk ends inside a KV tile where it must, the rest of the tile masked),
// partials in the caller's fp32 scratch part_o (C, B, H, N, hd), part_l and
// part_m (C, B, H, N); bf16, hd 48, 64 or 128.
extern "C" int cs_flash_qkv_self_attention_chunked(const void* qkv, void* o, void* l, void* m,
                                                   void* part_o, void* part_l, void* part_m, int batch,
                                                   int n, int heads, int hd, int kv_chunk, int nchunks,
                                                   float scale, void* stream) {
  cs::AttnArgs a = cs::qkv_args(qkv, o, l, m, n, heads, hd, cs::kBFloat16, scale);
  a.kv_chunk = kv_chunk;
  a.part_o = static_cast<float*>(part_o);
  a.part_l = static_cast<float*>(part_l);
  a.part_m = static_cast<float*>(part_m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_chunk < 1 || nchunks < 1 || (long long)(nchunks - 1) * kv_chunk >= n) return (int)cudaErrorInvalidValue;
  const int rc = cs::launch_attention_mode<cs::kPartial>(a, batch, hd, nchunks, st);
  if (rc != 0) return rc;
  cs::CombineArgs c{a.part_o, a.part_l, a.part_m, static_cast<__nv_bfloat16*>(o), a.l, a.m,
                    (long long)batch * heads * n, heads, n, nchunks};
  switch (hd) {
    case 48: return cs::launch_combine<48>(c, st);
    case 64: return cs::launch_combine<64>(c, st);
    case 128: return cs::launch_combine<128>(c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7': mode 5 "mxuprobe", 6 "noexp", 7 "bf16exp" (cs::kMxuProbe ..); bf16,
// no bias, hd 48, 64 or 128.
extern "C" int cs_flash_attention_head_major_variant(const void* q, const void* k, const void* v,
                                                     const long long* strides, void* o, void* l, void* m,
                                                     int batch, int heads, int nq, int nk, int hd, int mode,
                                                     float scale, void* stream) {
  const cs::AttnArgs a = cs::head_major_args(q, k, v, strides, o, l, m, heads, nq, nk, hd, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case cs::kMxuProbe: return cs::launch_attention_mode<cs::kMxuProbe>(a, batch, hd, 1, st);
    case cs::kNoExp: return cs::launch_attention_mode<cs::kNoExp>(a, batch, hd, 1, st);
    case cs::kBf16Exp: return cs::launch_attention_mode<cs::kBf16Exp>(a, batch, hd, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
