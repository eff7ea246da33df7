// K12: the backward's five products with no transcendentals, over one
// 128-lane block of each token's row, at several head-slice geometries.
//
// Replaces the inline Pallas kernel of the TPU tool tools/lane_pad_probe.py
// (`probe_kernel`, launched by `run` in `main`), which asks what the
// decoder's lane padding (hd 48 padded to 64) costs the backward's matrix
// products. q, do (B, Nq, 128) and k, v (B, Nk, 128) bf16 each hold S head
// slices of width HD at lane offsets 0 and STRIDE (S = 2; S = 1 at HD 128).
// For each batch item and slice, with c1 = 0.1442695:
//   s = q k^T, dp = do v^T, pb = bf16(s * c1), dsb = bf16(dp * c1),
//   dq = dsb k, dk = dsb^T q, dv = pb^T do,
// every product accumulated in fp32 and each output rounded to bf16 once.
// Lanes outside the slices are not part of the function: this kernel leaves
// them unwritten in dq, dk and dv (the TPU leaves dk and dv unwritten and dq
// zero).
//
// Design: the K4 backward's two passes (attention_bwd.cuh with PROBE: wgmma
// products, TMA loads, a producer warp), the slices read as heads through a
// head stride of STRIDE lanes and a row stride of 128, so K12 times the
// products of K4's own schedule without its exponentials: seven products per
// score tile (s and dp are recomputed by the dq pass), where the TPU tool
// runs five in one pass. Bound on the H100: the five products' 10 * B * S *
// Nq * Nk * HD operations (the useful hd-48 work, 10 * B * 2 * Nq * Nk * 48,
// at the hd 48 geometries) against ~(2 Nq + 2 Nk) * 128 * 2 bytes in and the
// same out per item, far above the ridge, so the tensor cores bound it. On
// an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md) hd 48 takes
// 0.57-0.58 ms, 40% of that bound (0.96-0.99 ms, 24%, with mma.sync).

#include "attention_bwd.cuh"

namespace {

template <int HD>
int launch_probe(const cs::BwdArgs& a, int batch, cudaStream_t st) {
  return cs::launch_bwd_hd<HD, true>(a, batch, cs::kBFloat16, st);
}

}  // namespace

// q, dout: (B, Nq, lanes) and k, v: (B, Nk, lanes) bf16, row-major; dq, dk,
// dv the same shapes. `slices` head slices of width hd at lane offsets
// 0, stride, ...; hd 48, 64 or 128.
extern "C" int cs_lane_pad_probe(const void* q, const void* dout, const void* k, const void* v, void* dq,
                                 void* dk, void* dv, int batch, int nq, int nk, int lanes, int slices,
                                 int hd, int stride, float c1, void* stream) {
  cs::BwdArgs a;
  a.q = q;
  a.dout = dout;
  a.k = k;
  a.v = v;
  a.lb = a.delta = nullptr;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.q_bs = a.do_bs = a.dq_bs = (long long)nq * lanes;
  a.k_bs = a.v_bs = a.dkv_bs = (long long)nk * lanes;
  a.q_hs = a.do_hs = a.k_hs = a.v_hs = a.dq_hs = a.dkv_hs = stride;
  a.q_rs = a.do_rs = a.k_rs = a.v_rs = a.dq_rs = a.dkv_rs = lanes;
  a.h = slices;
  a.nq = nq;
  a.nk = nk;
  a.scale = 1.f;
  a.c1 = c1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 48: return launch_probe<48>(a, batch, st);
    case 64: return launch_probe<64>(a, batch, st);
    case 128: return launch_probe<128>(a, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
